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
// past the early exit, past the total) keep their zeros.
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
// What changes: no lane scans, no first-chunk read-merge-write and no donated
// zeros.  Every pair lies in exactly one tile, so its gradient row is written
// by one block, once, without atomics.  The per-pair sum over the 256 pixels
// is a warp butterfly (__shfl_xor_sync) per pair and value, then a fixed-order
// sum of the eight warp partials from shared memory: deterministic.  A warp in
// which no pixel is inside the splat skips its shuffles (its partials are
// exactly zero), which is most warps for small splats.
//
// Shared memory: the staged chunk [columns][512] (OBB / AABB 10 columns,
// 2DGS 17) and the warp partials [8 warps][32 pairs][row columns]: 30 KB for
// OBB / AABB, 50 KB for 2DGS, above the 48 KB of static shared memory, so it
// is dynamic shared memory sized per mode (for 2DGS, cudaFuncSetAttribute
// raises the limit once per device, before the first launch).  The chunk grid stays the forward's: it decides
// where the exit vote may stop a tile.
//
// Bound on the H100: operations.  Every walked (pair, pixel) evaluation
// needs 12 FP32 operations (offsets, u, v, the inside test); one inside the
// splat needs about 59 more and one expf: alpha and transmittance, the
// gradient chain, and one add for each of the ten sums over pixels.  AABB:
// 16 per walked evaluation (offsets, the quadratic form, the clip) and about
// 50 more and one expf inside (nine sums: the radius column has none).
// 2DGS: 4 per walked evaluation (offsets, the square clip) and about 104 more
// and one expf inside (the homography and reciprocal, the chain, fifteen
// sums).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // 256 threads, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kMaxChunk = 512;
constexpr int kBatch = 32;  // pairs whose warp partials are flushed together
constexpr unsigned kFull = 0xffffffffu;
constexpr int kModeObb = 0;
constexpr int kModeAabb = 1;
constexpr int kMode2d = 2;
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory a launch gets unasked
constexpr int kMaxDevices = 64;

// as in tile_fwd.cu: row columns, staged columns (the colours and alpha last)
template <int kMode>
constexpr int kRowCols = kMode == kMode2d ? 16 : 10;
template <int kMode>
constexpr int kStaged = kMode == kMode2d ? 17 : 10;
// the column that only masks (exact zeros, no warp sum): AABB radius, 2DGS mr
template <int kMode>
constexpr int kMaskCol = kMode == kModeAabb ? 5 : kMode == kMode2d ? 2 : -1;

template <int kMode>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kStaged<kMode> * kMaxChunk + (size_t)kWarps * kBatch * kRowCols<kMode>);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int kMode>
__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const float* __restrict__ params, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, const float* __restrict__ gbar,
                     int tx_count, float width_f, float full_height_f, float inv_w2,
                     float inv_h2, float inv_w, float inv_h, float two_w2, int y0, int chunk,
                     float trans_eps, float* __restrict__ dparams) {
  constexpr int kRow = kRowCols<kMode>;
  constexpr int kCol = kStaged<kMode>;
  constexpr int kR = kCol - 4;  // staged r; g, b, alpha follow
  // staged columns [kCol][kMaxChunk] (OBB 2-5: e1x, e1y, 1/b1, 1/b2; AABB
  // conic.x, conic.y, conic.z, r; 2DGS 2-12: mr/W, mr/H, A, B, C), then the
  // warp partials [kWarps][kBatch][kRow]
  extern __shared__ __align__(16) float smem[];
  float (*s)[kMaxChunk] = reinterpret_cast<float (*)[kMaxChunk]>(smem);
  float (*s_part)[kBatch][kRow] = reinterpret_cast<float (*)[kBatch][kRow]>(smem + kCol * kMaxChunk);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int count = tile_count[t];
  const int start = tile_start[t];
  const int base = (start / 128) * 128;
  const int prefix = start - base;
  const int total = count + prefix;
  if (count <= 0) return;  // uniform over the block, before any barrier
  const int n_chunks = (total + chunk - 1) / chunk;

  // the forward's pixel coordinates (csrc/tile_fwd.cu)
  const float px = (float)((t % tx_count) * kTile + p % kTile) + 0.5f;
  const float py = ((float)((t / tx_count) * kTile + p / kTile) + 0.5f) + (float)y0;
  const float x_ndc = fmaf(px, inv_w2, -1.0f);
  const float y_ndc = fmaf(-py, inv_h2, 1.0f);
  const float px_vp = x_ndc * width_f;
  const float py_vp = y_ndc * full_height_f;
  const float px_ndc = x_ndc * (width_f * inv_w);
  const float py_ndc = y_ndc * (full_height_f * inv_h);

  const float* gb = gbar + (long long)t * 8 * kPix;
  const float g_r = gb[p];
  const float g_g = gb[kPix + p];
  const float g_b = gb[2 * kPix + p];
  const float q_total = g_r * gb[4 * kPix + p] + g_g * gb[5 * kPix + p] + g_b * gb[6 * kPix + p];
  // S_i + ghat_T T_fin = s_total - q_acc
  const float s_total = q_total + gb[3 * kPix + p] * gb[7 * kPix + p];

  float T = 1.0f;
  float q_acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    // the forward's exit rule; also the barrier before restaging
    if (c > 0 && !__syncthreads_or(T > trans_eps)) break;
    const int lo = max(prefix - c * chunk, 0);
    const int hi = min(total - c * chunk, chunk);
    const int first = base + c * chunk + lo;
    const int m = hi - lo;
    for (int j = p; j < m; j += kPix) {
      const float* row = params + (long long)(first + j) * kRow;
      s[0][j] = row[0];
      s[1][j] = row[1];
#pragma unroll
      for (int k = 0; k < 4; ++k) s[kR + k][j] = row[kRow - 4 + k];
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
      }
    }
    __syncthreads();
    for (int jb = 0; jb < m; jb += kBatch) {
      const int nb = min(kBatch, m - jb);
      for (int k = 0; k < nb; ++k) {
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
        const float op = s[kR + 3][j];
        const float raw = g * op;
        const float a = fminf(raw, 0.999f);
        // g == 0 on every pixel of the warp: a = w = q = 0, all partials are
        // exactly zero and T, q_acc do not move
        if (__any_sync(kFull, g != 0.0f)) {
          const float w = a * T;
          const float gc = g_r * s[kR][j] + g_g * s[kR + 1][j] + g_b * s[kR + 2][j];
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
            const float dq0 = dus * inv_pz;
            const float dq1 = dvs * inv_pz;
            // the clamp passes no gradient where it held
            const float dq2 = fabsf(qz) > 1e-12f ? -(dus * u + dvs * v) * inv_pz : 0.0f;
            // (dd2 * 2) * W^2 == dd2 * (2 W^2): scaling by 2 is exact
            const float dd = dd2 * two_w2;
            // columns 0, 1 are negated after the pixel sum (dxn = px - cx)
            d[0] = dd * dx + ((dq0 * s[4][j] + dq1 * s[5][j]) + dq2 * s[6][j]);  // -dcx
            d[1] = dd * dy + ((dq0 * s[7][j] + dq1 * s[8][j]) + dq2 * s[9][j]);  // -dcy
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
          }
          d[kRow - 4] = w * g_r;
          d[kRow - 3] = w * g_g;
          d[kRow - 2] = w * g_b;
          d[kRow - 1] = dag;  // dopacity
#pragma unroll
          for (int col = 0; col < kRow; ++col) {
            if (col == kMaskCol<kMode>) continue;
            d[col] = warp_sum(d[col]);
          }
          if (lane == 0) {
#pragma unroll
            for (int col = 0; col < kRow; ++col) s_part[warp][k][col] = d[col];
          }
          T *= 1.0f - a;
        } else if (lane == 0) {
#pragma unroll
          for (int col = 0; col < kRow; ++col) s_part[warp][k][col] = 0.0f;
        }
      }
      __syncthreads();
      // sum the eight warp partials in a fixed order; rows are contiguous
      float* out = dparams + (long long)(first + jb) * kRow;
      for (int i = p; i < nb * kRow; i += kPix) {
        const int k = i / kRow;
        const int col = i - k * kRow;
        float sum = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < kWarps; ++w8) sum += s_part[w8][k][col];
        const bool negate = kMode == kModeObb ? (col == 0 || col == 4 || col == 5)
                            : kMode == kMode2d ? (col == 0 || col == 1)
                                               : false;
        out[i] = negate ? -sum : sum;
      }
      __syncthreads();
    }
  }
}

template <int kMode>
int launch(const void* params, const void* tile_start, const void* tile_count, const void* gbar,
           int num_tiles, int tx_count, float width_f, float full_height_f, float inv_w2,
           float inv_h2, float inv_w, float inv_h, float two_w2, int y0, int chunk,
           float trans_eps, void* dparams, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<kMode>();
  if (bytes > kDefaultSmem) {
    // raise the limit once per device (the attribute belongs to the device's
    // context); OBB and AABB stay under the default and never ask
    static bool raised[kMaxDevices] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!raised[device]) {
      err = cudaFuncSetAttribute(composite_bwd_kernel<kMode>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      raised[device] = true;
    }
  }
  composite_bwd_kernel<kMode><<<num_tiles, kPix, bytes, stream>>>(
      (const float*)params, (const int*)tile_start, (const int*)tile_count, (const float*)gbar,
      tx_count, width_f, full_height_f, inv_w2, inv_h2, inv_w, inv_h, two_w2, y0, chunk,
      trans_eps, (float*)dparams);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bgs_composite_bwd(const void* params, const void* tile_start,
                                 const void* tile_count, const void* gbar, int num_tiles,
                                 int tx_count, float width_f, float full_height_f,
                                 float inv_w2, float inv_h2, float inv_w, float inv_h,
                                 float two_w2, int y0, int chunk, int mode, float trans_eps,
                                 void* dparams, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (mode != kModeObb && mode != kModeAabb && mode != kMode2d) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return (int)cudaGetLastError();
  auto fn = mode == kModeObb    ? launch<kModeObb>
            : mode == kModeAabb ? launch<kModeAabb>
                                : launch<kMode2d>;
  return fn(params, tile_start, tile_count, gbar, num_tiles, tx_count, width_f, full_height_f,
            inv_w2, inv_h2, inv_w, inv_h, two_w2, y0, chunk, trans_eps, dparams,
            (cudaStream_t)stream);
}
