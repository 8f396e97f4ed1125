// Backward tile compositor: the hand-derived VJP of the front-to-back blend,
// one 16x16 tile per block.
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/tile_bwd.py
// `_backward_kernel` (launched by `pallas_composite_backward`), OBB, AABB and
// 2DGS modes.
//
// Inputs: params [P, 10] f32 in pair-sorted order (the forward's input), rows
// [cx_vp, cy_vp, e1x, e1y, b1, b2, r, g, b, alpha] (OBB) or [cx_vp, cy_vp,
// conic.x, conic.y, conic.z, radius_vp, r, g, b, alpha] (AABB); for 2DGS
// [P, 16], rows [cx_ndc, cy_ndc, mr, A.xyz, B.xyz, C.xyz, r, g, b, alpha];
// tile_start / tile_count [T] i32; gbar [T, 8, 256] f32 per pixel: rows 0-2
// the rgb cotangent, row 3 the final-transmittance cotangent, rows 4-6 the
// forward's rgb totals, row 7 its final transmittance.  Output dparams of
// the params' shape, zeroed by the caller: pairs no tile walked (past k_max,
// past the early exit, past the total) and pairs whose splat reaches no
// pixel of the tile keep their zeros.
//
// Per pixel, splats i front to back (derivation: tile_bwd.py:8-22):
//   w_i = a_i T_i,  dL/dc_i = w_i ghat_rgb,
//   dL/da_i = gc_i T_i - (S_i + ghat_T T_fin) / (1 - a_i)
// with gc_i = ghat_rgb . c_i and S_i = sum_{j>i} gc_j w_j.  Each thread keeps
// T and the running prefix q_acc = sum_{j<=i} gc_j w_j, so
// S_i + ghat_T T_fin = (Q_total + ghat_T T_fin) - q_acc needs no scan
// (Q_total = ghat_rgb . total_rgb from gbar).  dL/da chains through
// a = min(op g, 0.999) into the row's parameters (tile_bwd.py:286-317), with
// dpower = dL/da g op:
//   OBB  (:367-390): g = exp(-4.5 (u^2 + v^2)) through u, v to the centre,
//        the axis and the two radii;
//   AABB (:320-332): g = exp(power), power = -0.5 (a dx^2 + c dy^2) + b dx dy
//        with dx = cx - px: dcx = dpower (-a dx + b dy), dcy = dpower (-c dy
//        + b dx), da = dpower (-0.5 dx^2), db = dpower dx dy, dc = dpower
//        (-0.5 dy^2); the radius only masks, so its column is exactly 0;
//   2DGS (:333-366): power = -0.5 min(s3d, d2x2), the branch min() took
//        (take3d = s3d <= d2x2) gets it all: ds3d = -0.5 dpower or dd2 =
//        -dpower; dq_k = 2 ds3d (us, vs) / pz for k = 0, 1 and dq_2 =
//        -(dus us + dvs vs) / pz, zero where the clamp held |q.z| <= 1e-12;
//        dA_k = dq_k dxn, dB_k = dq_k dyn, dC_k = dq_k; dcx = -(dd2 2 W^2 dxn
//        + dq . A), dcy = -(dd2 2 W^2 dyn + dq . B) (dxn = pixel - centre);
//        the surfel radius only masks, so column 2 is exactly 0.
// The cap and the inside test zero the gradient.
//
// Semantics kept from the TPU kernel, because they change the gradient:
//  * the chunk grid of the forward (chunks aligned at floor(start/128)*128)
//    and its between-chunk early exit, the same block vote on the same T as
//    csrc/tile_fwd.cu, so the backward walks exactly the pairs the forward
//    blended;
//  * inv_om = 1 / max(1 - a, 1e-6); zero gradient where alpha hit the cap;
//  * `y0` and `full_height` place the tile in the full image (bands).
// The file is built with --fmad=false like tile_fwd.cu: alpha, the inside
// test, the 2DGS min() branch and T must round exactly as the forward's, or a
// gradient term flips and the exit vote can fall one chunk apart.  All modes
// share one body (a template on the mode), as in the forward.
//
// What bounds it on the H100.  The arithmetic a gradient needs is small:
// 51-105 FP32 operations where a pixel is inside the splat, none elsewhere
// (the bound below).  A splat of the bench
// scene reaches 5-8 of a tile's 256 pixels, so almost all of a pair's work
// in a kernel that visits every (pair, pixel) is overhead: staged loads, the
// falloff and a vote for warps that no pixel of the splat reaches, a full
// butterfly per gradient column for a handful of active lanes, and the
// flush of eight warp partials per pair.  The kernel is bound by issued
// instructions, not by FP32 work or bytes.  The design removes that
// overhead and keeps the arithmetic:
//
//  1. Per-warp footprint culling, decided once per pair when its chunk is
//     staged: warp_mask (csrc/cull.cuh, shared with the forward) bounds the
//     splat by a box in the falloff's frame and keeps the warps whose
//     pixels the box may touch.  Each warp ballots its own bit over a batch
//     of pairs and walks only the set bits in order (__ffsll); the exact
//     falloff still decides every pair it visits.  A left-out (pair, warp)
//     has g = 0 at every pixel, so a = 0 and T, q_acc and every partial are
//     unchanged to the bit: the culling changes no float and no exit vote.
//     The twin of the mask in PyTorch is ops/cuda/cull.py `warp_masks`.
//  2. A multi-column warp reduce.  The 9-15 gradient columns of a hit warp
//     are summed over its lanes by a reduce-scatter (reduce_scatter): at each
//     of the five shuffle distances 16 ... 1 a lane keeps half of its
//     columns and sends the other half, so the column count halves per level
//     (10 columns: 5 + 3 + 2 + 1 + 1 = 12 shuffles and 12 adds; 15: 16), not
//     one five-step butterfly per column (45-75).  Each column's sum ends in
//     one or more lanes with the same bits (the adds of a level commute), and
//     the lowest of them writes it.  The order is fixed: two launches on the
//     same inputs are bitwise equal.
//  3. Flush only what was hit.  A warp writes partials only for the pairs it
//     visits (zeros where its exact test found nothing).  The per-pair sum
//     reads the warps of the pair's mask in warp order, and a pair with an
//     empty mask is not written.  Adding an exact zero changes no float sum,
//     so leaving the other warps out gives the sum of all eight.
//  4. Batches of kBatch pairs per pair of barriers: 64 for OBB and AABB, 32
//     for 2DGS, whose 16-column partials would take it to 68 KB of shared
//     memory and 3 resident blocks per SM.  OBB and AABB are held to 48
//     registers so that 5 blocks fit an SM (shared memory allows 5); 2DGS
//     runs 4.
//  5. Warps of 4 x 8 pixels (cull.cuh): a splat's box meets fewer of them
//     than of 2 x 16 strips (the bench scene keeps 0.17-0.18 of the visits
//     at 512x512 against 0.21), at the price of a second column strip in
//     the mask.
//
// The choices of items 4 and 5 were timed against their alternatives (2 x
// 16 warps, batches of 32, no floor on resident blocks) on the card; PERF.md
// keeps that table.
//
// The kSurface instantiation (2DGS training with the surface maps of
// csrc/tile_fwd.cu): rows of 23 columns (the 16, the depth's det T0, A0.z,
// B0.z, C0.z, and n.xyz), staged as 24.  Per pixel it also reads gaux [T, 11, 256]: the cotangents of N.xyz,
// D, the distortion dist and the median depth, the forward's totals ad =
// sum w, z1 = sum w zeta, z2 = sum w zeta^2 (zeta = 1 / z, over the
// fragments in the maps), the median's pair index, and s_extra = gN . N +
// gD D + 2 g_dist dist.  The maps are sums over fragments of w times a
// per-fragment value f_i (n_i, z_i, and for the distortion lam_i = sum_j
// w_j (zeta_i - zeta_j)^2 = zeta_i^2 ad - 2 zeta_i z1 + z2, whose sum
// against the weights is 2 dist), so their gradient in alpha is the
// colour's with gc_i += gN . n_i + gD z_i + g_dist lam_i and the suffix
// total += s_extra.  Through the depth, dz_i = gD w_i - g_dist 2 w_i
// (zeta_i ad - z1) zeta_i^2, plus g_median on the median's pair; z = det T0
// / q0.z gives d det T0 = dz / q0.z and dq0.z = -dz z / q0.z (zero where its
// clamp held) into A0.z, B0.z, C0.z (times dxn, dyn, 1) and the centre
// (columns 0 and 1, through dxn and dyn); dn = w gN.  A fragment is in the maps by
// the forward's rule (a >= 1/255, z >= near), recomputed here on the same
// bits.  Its 22 summed columns take one more level of the reduce-scatter
// than 2DGS's 15, its shared memory (73,216 B) three resident blocks an
// SM.
//
// Shared memory (dynamic, sized per mode): the staged chunk [columns][512]
// (OBB / AABB 10 columns, 2DGS 17), the warp partials [8 warps][kBatch][row
// columns] and the masks [512] B.  Above 48 KB (2DGS), cudaFuncSetAttribute
// raises the limit once per device, before the first launch.
//
// Bound on the H100 (chip_smoke.py), the least work any implementation
// does: the larger of the bytes (the walked rows, the tile ranges, gbar,
// the output) and the operations: per walked pair its staging (the
// reciprocals, the mask), per (pair, pixel) inside the splat the falloff,
// alpha, the gradient chain and one add into each pixel sum.  Both are far
// below the kernel's time: it is bound by issued instructions (above).

#include <cuda_runtime.h>

#include "cull.cuh"

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory a launch gets unasked
constexpr int kMaxDevices = 64;

// the surface instantiation's extra columns (the depth's coefficients, n),
// after the 16
constexpr int kSurfaceCols = 7;
constexpr float kDepthEps = 1e-6f;  // the least |q0.z| of a fragment's depth (DEPTH_EPS)
constexpr int kSurfaceGbarRows = 11;
// a gradient row's columns
template <int kMode, bool kSurface>
constexpr int kRowOf = kRowCols<kMode> + (kSurface ? kSurfaceCols : 0);
// staged columns (the colours and alpha last)
template <int kMode, bool kSurface>
constexpr int kStaged = (kMode == kMode2d ? 17 : 10) + (kSurface ? kSurfaceCols : 0);
// the column that only masks (exact zeros, no warp sum): AABB radius, 2DGS mr
template <int kMode>
constexpr int kMaskCol = kMode == kModeAabb ? 5 : kMode == kMode2d ? 2 : -1;
// the columns the warp reduce sums
template <int kMode, bool kSurface>
constexpr int kSummed = kRowOf<kMode, kSurface> - (kMaskCol<kMode> >= 0 ? 1 : 0);
// pairs whose warp partials are flushed together
template <int kMode>
constexpr int kBatch = kMode == kMode2d ? 32 : 64;
// resident blocks per SM that ptxas must leave registers for (OBB, AABB:
// 48 registers, where they would take 56-60 and allow 4; 2DGS's shared
// memory allows 4 at most)
template <int kMode>
constexpr int kMinBlocks = kMode == kMode2d ? 1 : 5;

template <int kMode, bool kSurface>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kStaged<kMode, kSurface> * kMaxChunk
                          + (size_t)kWarps * kBatch<kMode> * kRowOf<kMode, kSurface>)
         + kMaxChunk;
}

// One level of the reduce-scatter over lanes lane and lane ^ O, then the
// next: n values in, (n + 1) / 2 out; a lane with bit O set keeps the odd
// member of each pair, the other the even one; an odd last value is summed
// in both lanes.
template <int N, int O, int M>
__device__ __forceinline__ void reduce_scatter(float (&v)[M], int lane) {
  if constexpr (O > 0) {
    const bool upper = (lane & O) != 0;
    constexpr int kPairs = N / 2;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const float keep = upper ? v[2 * i + 1] : v[2 * i];
      const float send = upper ? v[2 * i] : v[2 * i + 1];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    if constexpr (N % 2 == 1) v[kPairs] = v[N - 1] + __shfl_xor_sync(kFull, v[N - 1], O);
    reduce_scatter<(N + 1) / 2, O / 2>(v, lane);
  }
}

// The position, among the N values reduce_scatter<N, O> starts from, of the
// one value `lane` holds at its end.
template <int N, int O>
__device__ __forceinline__ int scatter_index(int lane) {
  if constexpr (O == 0) {
    return 0;
  } else {
    const int below = scatter_index<(N + 1) / 2, O / 2>(lane);
    return below < N / 2 ? 2 * below + ((lane & O) ? 1 : 0) : N - 1;
  }
}

template <int kMode, bool kSurface = false>
__global__ void __launch_bounds__(kPix, kMinBlocks<kMode>)
composite_bwd_kernel(const float* __restrict__ params, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, const float* __restrict__ gbar,
                     int tx_count, float width_f, float full_height_f, float inv_w2,
                     float inv_h2, float inv_w, float inv_h, float two_w2, int y0, int chunk,
                     float trans_eps, float* __restrict__ dparams, const float* __restrict__ gaux,
                     float near) {
  static_assert(!kSurface || kMode == kMode2d, "the surface maps are 2DGS's");
  constexpr int kRow = kRowOf<kMode, kSurface>;
  constexpr int kColour = kRowCols<kMode> - 4;  // the row's r; g, b, alpha follow
  constexpr int kCol = kStaged<kMode, kSurface>;
  constexpr int kR = kCol - 4;  // staged r; g, b, alpha follow
  constexpr int kC = 13;        // staged det T0, A0.z, B0.z, C0.z, n.xyz (kSurface)
  constexpr int kB = kBatch<kMode>;
  constexpr int kSum = kSummed<kMode, kSurface>;
  constexpr int kMask = kMaskCol<kMode>;
  // staged columns [kCol][kMaxChunk] (OBB 2-5: e1x, e1y, 1/b1, 1/b2; AABB
  // conic.x, conic.y, conic.z, r; 2DGS 2-12: mr/W, mr/H, A, B, C), then the
  // warp partials [kWarps][kB][kRow], then the warp masks [kMaxChunk]
  extern __shared__ __align__(16) float smem[];
  float (*s)[kMaxChunk] = reinterpret_cast<float (*)[kMaxChunk]>(smem);
  float (*s_part)[kB][kRow] = reinterpret_cast<float (*)[kB][kRow]>(smem + kCol * kMaxChunk);
  unsigned char* s_mask = reinterpret_cast<unsigned char*>(smem + kCol * kMaxChunk + kWarps * kB * kRow);
  __shared__ float s_colx[kTile];
  __shared__ float s_rowy[kTile];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int count = tile_count[t];
  const int start = tile_start[t];
  const int base = (start / 128) * 128;
  const int prefix = start - base;
  const int total = count + prefix;
  if (count <= 0) return;  // uniform over the block, before any barrier
  const int n_chunks = (total + chunk - 1) / chunk;

  // this thread's pixel (cull.cuh) and its coordinates, as the forward's
  const int prow = pixel_row(tid);
  const int pcol = pixel_col(tid);
  const int p = prow * kTile + pcol;
  const PixelCoords pc = pixel_coords(t, prow, pcol, tx_count, width_f, full_height_f, inv_w2, inv_h2, inv_w,
                                      inv_h, y0);
  const float px_vp = pc.px_vp;
  const float py_vp = pc.py_vp;
  const float px_ndc = pc.px_ndc;
  const float py_ndc = pc.py_ndc;
  // the falloff's frame: NDC for 2DGS, else vp units
  const float fx = kMode == kMode2d ? px_ndc : px_vp;
  const float fy = kMode == kMode2d ? py_ndc : py_vp;
  if (prow == 0) s_colx[pcol] = fx;
  if (pcol == 0) s_rowy[prow] = fy;

  const float* gb = gbar + (long long)t * 8 * kPix;
  const float g_r = gb[p];
  const float g_g = gb[kPix + p];
  const float g_b = gb[2 * kPix + p];
  const float q_total = g_r * gb[4 * kPix + p] + g_g * gb[5 * kPix + p] + g_b * gb[6 * kPix + p];
  // S_i + ghat_T T_fin = s_total - q_acc
  float s_total = q_total + gb[3 * kPix + p] * gb[7 * kPix + p];
  // the surface maps' cotangents and totals (kSurface only)
  float gnx = 0.0f, gny = 0.0f, gnz = 0.0f, gd = 0.0f, gl = 0.0f, gz = 0.0f;
  float ad_t = 0.0f, z1_t = 0.0f, z2_t = 0.0f, med = -1.0f;
  if constexpr (kSurface) {
    const float* ga = gaux + (long long)t * kSurfaceGbarRows * kPix + p;
    gnx = ga[0];
    gny = ga[kPix];
    gnz = ga[2 * kPix];
    gd = ga[3 * kPix];
    gl = ga[4 * kPix];
    gz = ga[5 * kPix];
    ad_t = ga[6 * kPix];
    z1_t = ga[7 * kPix];
    z2_t = ga[8 * kPix];
    med = ga[9 * kPix];
    s_total = s_total + ga[10 * kPix];
  }

  // the gradient column whose warp sum this lane ends with, and whether it
  // is the lowest such lane (the one that stores it)
  const int sum_idx = scatter_index<kSum, 16>(lane);
  const int sum_col = kMask >= 0 && sum_idx >= kMask ? sum_idx + 1 : sum_idx;
  const bool sum_writer = (__ffs(__match_any_sync(kFull, sum_idx)) - 1) == lane;

  __syncthreads();  // s_colx, s_rowy before the first chunk's masks

  float T = 1.0f;
  float q_acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    // the forward's exit rule; also the barrier before restaging
    if (c > 0 && !__syncthreads_or(T > trans_eps)) break;
    const int lo = max(prefix - c * chunk, 0);
    const int hi = min(total - c * chunk, chunk);
    const int first = base + c * chunk + lo;
    const int m = hi - lo;
    for (int j = tid; j < m; j += kPix) {
      const float* row = params + (long long)(first + j) * kRow;
      s[0][j] = row[0];
      s[1][j] = row[1];
#pragma unroll
      for (int k = 0; k < 4; ++k) s[kR + k][j] = row[kColour + k];
      if constexpr (kMode == kModeObb) {
        const float b1 = row[4];
        const bool ok = b1 > 0.0f;
        s[2][j] = row[2];
        s[3][j] = row[3];
        // b1 <= 0 is "outside" (alpha 0, no gradient): ib1 = 0 marks it
        s[4][j] = ok ? 1.0f / fmaxf(b1, 1e-12f) : 0.0f;
        s[5][j] = ok ? 1.0f / fmaxf(row[5], 1e-12f) : 0.0f;
        s[kR + 3][j] = ok ? row[9] : 0.0f;
      } else if constexpr (kMode == kModeAabb) {
#pragma unroll
        for (int k = 2; k < 6; ++k) s[k][j] = row[k];
      } else {
        s[2][j] = row[2] * inv_w;
        s[3][j] = row[2] * inv_h;
#pragma unroll
        for (int k = 0; k < 9; ++k) s[4 + k][j] = row[3 + k];
        if constexpr (kSurface) {
#pragma unroll
          for (int k = 0; k < kSurfaceCols; ++k) s[kC + k][j] = row[16 + k];
        }
      }
      s_mask[j] = (unsigned char)warp_mask<kMode>(row, s_colx, s_rowy, inv_w, inv_h);
    }
    __syncthreads();
    for (int jb = 0; jb < m; jb += kB) {
      const int nb = min(kB, m - jb);
      // the batch's pairs whose mask holds this warp, walked in order
      unsigned long long todo = 0;
#pragma unroll
      for (int h = 0; h < kB / 32; ++h) {
        const int k = h * 32 + lane;
        const unsigned mine = __ballot_sync(kFull, k < nb && ((s_mask[jb + k] >> warp) & 1u));
        todo |= (unsigned long long)mine << (h * 32);
      }
      while (todo) {
        const int k = __ffsll(todo) - 1;
        todo &= todo - 1;
        const int j = jb + k;
        // OBB: dx = px - cx, u, v in the quad frame; AABB: dx = cx - px;
        // 2DGS: dx = dxn, dy = dyn (pixel - centre, NDC), and u, v the
        // homography's us, vs
        float dx, dy, u = 0.0f, v = 0.0f;
        float qz = 0.0f, inv_pz = 0.0f;
        bool take3d = false;
        float g = 0.0f;
        if constexpr (kMode == kModeObb) {
          dx = px_vp - s[0][j];
          dy = py_vp - s[1][j];
          u = (dx * s[2][j] + dy * s[3][j]) * s[4][j];
          v = (dx * s[3][j] - dy * s[2][j]) * s[5][j];
          if (s[4][j] > 0.0f && fabsf(u) <= 1.0f && fabsf(v) <= 1.0f) g = expf(-4.5f * (u * u + v * v));
        } else if constexpr (kMode == kModeAabb) {
          dx = s[0][j] - px_vp;
          dy = s[1][j] - py_vp;
          const float power = -0.5f * (s[2][j] * dx * dx + s[4][j] * dy * dy) + s[3][j] * dx * dy;
          if (fabsf(dx) <= s[5][j] && fabsf(dy) <= s[5][j] && power <= 0.0f) g = expf(power);
        } else {
          dx = px_ndc - s[0][j];
          dy = py_ndc - s[1][j];
          if (fabsf(dx) <= s[2][j] && fabsf(dy) <= s[3][j]) {
            const float qx = dx * s[4][j] + dy * s[7][j] + s[10][j];
            const float qy = dx * s[5][j] + dy * s[8][j] + s[11][j];
            qz = dx * s[6][j] + dy * s[9][j] + s[12][j];
            inv_pz = 1.0f / (fabsf(qz) > 1e-12f ? qz : 1e-12f);
            u = qx * inv_pz;
            v = qy * inv_pz;
            const float s3d = u * u + v * v;
            const float d2x2 = (dx * dx + dy * dy) * two_w2;
            take3d = s3d <= d2x2;
            g = expf(-0.5f * fminf(s3d, d2x2));
          }
        }
        float sum = 0.0f;  // this lane's column of the warp's partials
        // g == 0 on every pixel of the warp: a = w = q = 0, the partials
        // are exactly zero and T, q_acc do not move
        if (__any_sync(kFull, g != 0.0f)) {
          const float op = s[kR + 3][j];
          const float raw = g * op;
          const float a = fminf(raw, 0.999f);
          const float w = a * T;
          float gc = g_r * s[kR][j] + g_g * s[kR + 1][j] + g_b * s[kR + 2][j];
          // kSurface: the fragment's depth and its place in the maps
          float z = 0.0f, zeta = 0.0f, q0z = 0.0f, inv_p0 = 0.0f;
          bool frag = false;
          if constexpr (kSurface) {
            if (a >= trans_eps) {  // the forward's least alpha, the same float32 1/255
              q0z = (dx * s[kC + 1][j] + dy * s[kC + 2][j]) + s[kC + 3][j];
              inv_p0 = 1.0f / (fabsf(q0z) > kDepthEps ? q0z : kDepthEps);
              z = s[kC][j] * inv_p0;
              frag = z >= near;
            }
            if (frag) {
              zeta = 1.0f / z;
              const float gnn = (gnx * s[kC + 4][j] + gny * s[kC + 5][j]) + gnz * s[kC + 6][j];
              const float lam = ((zeta * zeta) * ad_t - 2.0f * zeta * z1_t) + z2_t;
              gc = gc + ((gnn + gd * z) + gl * lam);
            }
          }
          q_acc += gc * w;
          const float inv_om = 1.0f / fmaxf(1.0f - a, 1e-6f);
          float dalpha = gc * T - (s_total - q_acc) * inv_om;
          if (raw >= 0.999f) dalpha = 0.0f;  // the cap's min() passes nothing
          const float dag = dalpha * g;
          const float dpower = dag * op;
          float d[kRow];
          if constexpr (kMode == kModeObb) {
            const float dub = (dpower * u) * (-9.0f * s[4][j]);
            const float dvb = (dpower * v) * (-9.0f * s[5][j]);
            // columns 0, 4, 5 are negated after the pixel sum
            d[0] = dub * s[2][j] + dvb * s[3][j];  // -dcx
            d[1] = dvb * s[2][j] - dub * s[3][j];  // dcy
            d[2] = dub * dx - dvb * dy;            // de1x
            d[3] = dub * dy + dvb * dx;            // de1y
            d[4] = dub * u;                        // -db1
            d[5] = dvb * v;                        // -db2
          } else if constexpr (kMode == kModeAabb) {
            d[0] = dpower * (-s[2][j] * dx + s[3][j] * dy);  // dcx
            d[1] = dpower * (-s[4][j] * dy + s[3][j] * dx);  // dcy
            d[2] = dpower * (-0.5f * dx * dx);               // dconic.x
            d[3] = dpower * (dx * dy);                       // dconic.y
            d[4] = dpower * (-0.5f * dy * dy);               // dconic.z
            d[5] = 0.0f;                                     // radius: mask only
          } else {
            // outside the square every factor below is 0 (dpower, u, v,
            // inv_pz), so the partials are exact zeros
            const float ds3d = take3d ? -0.5f * dpower : 0.0f;
            const float dd2 = take3d ? 0.0f : -dpower;
            const float dus = (ds3d * 2.0f) * u;
            const float dvs = (ds3d * 2.0f) * v;
            float dz = 0.0f;
            if constexpr (kSurface) {
              // the maps through the depth: D, the distortion, the median
              if (frag) {
                const float dzeta = gl * (2.0f * w * (zeta * ad_t - z1_t));
                dz = gd * w - dzeta * (zeta * zeta);
              }
              if ((float)(first + j) == med) dz = dz + gz;
            }
            const float dq0 = dus * inv_pz;
            const float dq1 = dvs * inv_pz;
            // the clamp passes no gradient where it held
            const float dq2 = fabsf(qz) > 1e-12f ? -(dus * u + dvs * v) * inv_pz : 0.0f;
            // kSurface: z = det T0 / q0.z, into q0.z (where its clamp did not hold)
            const float dq0z = kSurface && fabsf(q0z) > kDepthEps ? -(dz * z) * inv_p0 : 0.0f;
            // (dd2 * 2) * W^2 == dd2 * (2 W^2): scaling by 2 is exact
            const float dd = dd2 * two_w2;
            // columns 0, 1 are negated after the pixel sum (dxn = px - cx)
            d[0] = dd * dx + ((dq0 * s[4][j] + dq1 * s[5][j]) + dq2 * s[6][j]);  // -dcx
            d[1] = dd * dy + ((dq0 * s[7][j] + dq1 * s[8][j]) + dq2 * s[9][j]);  // -dcy
            if constexpr (kSurface) {  // q0.z moves with the centre
              d[0] = d[0] + dq0z * s[kC + 1][j];
              d[1] = d[1] + dq0z * s[kC + 2][j];
            }
            d[2] = 0.0f;                                                         // mr: mask only
            d[3] = dq0 * dx;
            d[4] = dq1 * dx;
            d[5] = dq2 * dx;
            d[6] = dq0 * dy;
            d[7] = dq1 * dy;
            d[8] = dq2 * dy;
            d[9] = dq0;
            d[10] = dq1;
            d[11] = dq2;
            if constexpr (kSurface) {
              const float we = frag ? w : 0.0f;
              d[16] = dz * inv_p0;  // d det T0
              d[17] = dq0z * dx;    // dA0.z
              d[18] = dq0z * dy;    // dB0.z
              d[19] = dq0z;         // dC0.z
              d[20] = we * gnx;     // dn
              d[21] = we * gny;
              d[22] = we * gnz;
            }
          }
          d[kColour] = w * g_r;
          d[kColour + 1] = w * g_g;
          d[kColour + 2] = w * g_b;
          d[kColour + 3] = dag;  // dopacity
          float vals[kSum];
#pragma unroll
          for (int i = 0; i < kSum; ++i) vals[i] = d[kMask >= 0 && i >= kMask ? i + 1 : i];
          reduce_scatter<kSum, 16>(vals, lane);
          sum = vals[0];
          T *= 1.0f - a;
        }
        if (sum_writer) s_part[warp][k][sum_col] = sum;
      }
      __syncthreads();
      // sum each pair's partials over the warps of its mask, in warp order;
      // rows are contiguous, a pair with an empty mask keeps its zeros
      float* out = dparams + (long long)(first + jb) * kRow;
      for (int i = tid; i < nb * kRow; i += kPix) {
        const int k = i / kRow;
        const int col = i - k * kRow;
        unsigned warps = s_mask[jb + k];
        if (col == kMask || warps == 0) continue;
        float acc = 0.0f;
        while (warps) {
          acc += s_part[__ffs(warps) - 1][k][col];
          warps &= warps - 1;
        }
        const bool negate = kMode == kModeObb ? (col == 0 || col == 4 || col == 5)
                            : kMode == kMode2d ? (col == 0 || col == 1)
                                               : false;
        out[i] = negate ? -acc : acc;
      }
      __syncthreads();
    }
  }
}

// Raise `mode`'s dynamic shared memory limit above the default, once per
// device (the attribute belongs to the device's context); a mode under the
// default never asks.
template <int kMode, bool kSurface>
int raise_smem_limit() {
  constexpr size_t bytes = smem_bytes<kMode, kSurface>();
  if (bytes <= kDefaultSmem) return (int)cudaSuccess;
  static bool raised[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[device]) {
    err = cudaFuncSetAttribute(composite_bwd_kernel<kMode, kSurface>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  return (int)cudaSuccess;
}

template <int kMode, bool kSurface = false>
int launch(const void* params, const void* tile_start, const void* tile_count, const void* gbar,
           int num_tiles, int tx_count, float width_f, float full_height_f, float inv_w2,
           float inv_h2, float inv_w, float inv_h, float two_w2, int y0, int chunk,
           float trans_eps, void* dparams, const void* gaux, float near, cudaStream_t stream) {
  const int err = raise_smem_limit<kMode, kSurface>();
  if (err != (int)cudaSuccess) return err;
  composite_bwd_kernel<kMode, kSurface><<<num_tiles, kPix, smem_bytes<kMode, kSurface>(), stream>>>(
      (const float*)params, (const int*)tile_start, (const int*)tile_count, (const float*)gbar,
      tx_count, width_f, full_height_f, inv_w2, inv_h2, inv_w, inv_h, two_w2, y0, chunk,
      trans_eps, (float*)dparams, (const float*)gaux, near);
  return (int)cudaGetLastError();
}

template <int kMode, bool kSurface = false>
int occupancy(int* blocks_per_sm, int* dynamic_smem) {
  const int err = raise_smem_limit<kMode, kSurface>();
  if (err != (int)cudaSuccess) return err;
  *dynamic_smem = (int)smem_bytes<kMode, kSurface>();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, composite_bwd_kernel<kMode, kSurface>, kPix, smem_bytes<kMode, kSurface>());
}

}  // namespace

extern "C" int bgs_composite_bwd(const void* params, const void* tile_start,
                                 const void* tile_count, const void* gbar, int num_tiles,
                                 int tx_count, float width_f, float full_height_f,
                                 float inv_w2, float inv_h2, float inv_w, float inv_h,
                                 float two_w2, int y0, int chunk, int mode, float trans_eps,
                                 void* dparams, const void* gaux, float near, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (mode != kModeObb && mode != kModeAabb && mode != kMode2d) return (int)cudaErrorInvalidValue;
  if (gaux != nullptr && mode != kMode2d) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  auto fn = mode == kModeObb    ? launch<kModeObb>
            : mode == kModeAabb ? launch<kModeAabb>
                                : launch<kMode2d>;
  if (gaux != nullptr) fn = launch<kMode2d, true>;
  return fn(params, tile_start, tile_count, gbar, num_tiles, tx_count, width_f, full_height_f,
            inv_w2, inv_h2, inv_w, inv_h, two_w2, y0, chunk, trans_eps, dparams, gaux, near,
            (cudaStream_t)stream);
}

// Resident blocks per SM of `mode`'s instantiation (mode 3: 2DGS with the
// surface maps; with its shared memory limit raised, as a launch does) and
// its dynamic shared memory in bytes.
extern "C" int bgs_composite_bwd_occupancy(int mode, int* blocks_per_sm, int* dynamic_smem) {
  if (mode < kModeObb || mode > kMode2d + 1) return (int)cudaErrorInvalidValue;
  auto fn = mode == kModeObb    ? occupancy<kModeObb>
            : mode == kModeAabb ? occupancy<kModeAabb>
            : mode == kMode2d   ? occupancy<kMode2d>
                                : occupancy<kMode2d, true>;
  return fn(blocks_per_sm, dynamic_smem);
}

