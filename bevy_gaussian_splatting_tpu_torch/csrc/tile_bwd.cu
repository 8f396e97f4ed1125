// Backward tile compositor: the hand-derived VJP of the front-to-back blend,
// one 16x16 tile per block.
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/tile_bwd.py
// `_backward_kernel` (launched by `pallas_composite_backward`), OBB and AABB
// modes.
//
// Inputs: params [P, 10] f32 in pair-sorted order (the forward's input), rows
// [cx_vp, cy_vp, e1x, e1y, b1, b2, r, g, b, alpha] (OBB) or [cx_vp, cy_vp,
// conic.x, conic.y, conic.z, radius_vp, r, g, b, alpha] (AABB); tile_start / tile_count
// [T] i32; gbar [T, 8, 256] f32 per pixel: rows 0-2 the rgb cotangent, row 3
// the final-transmittance cotangent, rows 4-6 the forward's rgb totals, row 7
// its final transmittance.  Output dparams [P, 10] f32, zeroed by the caller:
// pairs no tile walked (past k_max, past the early exit, past the total) keep
// their zeros.
//
// Per pixel, splats i front to back (derivation: tile_bwd.py:8-22):
//   w_i = a_i T_i,  dL/dc_i = w_i ghat_rgb,
//   dL/da_i = gc_i T_i - (S_i + ghat_T T_fin) / (1 - a_i)
// with gc_i = ghat_rgb . c_i and S_i = sum_{j>i} gc_j w_j.  Each thread keeps
// T and the running prefix q_acc = sum_{j<=i} gc_j w_j, so
// S_i + ghat_T T_fin = (Q_total + ghat_T T_fin) - q_acc needs no scan
// (Q_total = ghat_rgb . total_rgb from gbar).  dL/da chains through
// a = min(op g, 0.999) into the ten parameters (tile_bwd.py:286-317), with
// dpower = dL/da g op:
//   OBB  (:367-390): g = exp(-4.5 (u^2 + v^2)) through u, v to the centre,
//        the axis and the two radii;
//   AABB (:320-332): g = exp(power), power = -0.5 (a dx^2 + c dy^2) + b dx dy
//        with dx = cx - px: dcx = dpower (-a dx + b dy), dcy = dpower (-c dy
//        + b dx), da = dpower (-0.5 dx^2), db = dpower dx dy, dc = dpower
//        (-0.5 dy^2); the radius only masks, so its column is exactly 0.
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
// test and T must round exactly as the forward's, or a gradient term flips
// and the exit vote can fall one chunk apart.  Both modes share one body (a
// template on the mode), as in the forward.
//
// What changes: no lane scans, no first-chunk read-merge-write and no donated
// zeros.  Every pair lies in exactly one tile, so its gradient row is written
// by one block, once, without atomics.  The per-pair sum over the 256 pixels
// is a warp butterfly (__shfl_xor_sync) per pair and value, then a fixed-order
// sum of the eight warp partials from shared memory: deterministic.  A warp in
// which no pixel is inside the splat skips its shuffles (its ten partials are
// exactly zero), which is most warps for small splats.
//
// Bound on the H100: operations.  Every walked (pair, pixel) evaluation
// needs 12 FP32 operations (offsets, u, v, the inside test); one inside the
// splat needs about 59 more and one expf: alpha and transmittance, the
// gradient chain, and one add for each of the ten sums over pixels.  AABB:
// 16 per walked evaluation (offsets, the quadratic form, the clip) and about
// 50 more and one expf inside (nine sums: the radius column has none).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // 256 threads, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kCols = 10;
constexpr int kMaxChunk = 512;
constexpr int kBatch = 32;  // pairs whose warp partials are flushed together
constexpr unsigned kFull = 0xffffffffu;
constexpr int kModeObb = 0;
constexpr int kModeAabb = 1;

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
                     float inv_h2, int y0, int chunk, float trans_eps,
                     float* __restrict__ dparams) {
  // columns 2-5: OBB e1x, e1y, 1/b1, 1/b2; AABB conic.x, conic.y, conic.z, r
  __shared__ float s_cx[kMaxChunk], s_cy[kMaxChunk], s_c2[kMaxChunk], s_c3[kMaxChunk];
  __shared__ float s_c4[kMaxChunk], s_c5[kMaxChunk];
  __shared__ float s_r[kMaxChunk], s_g[kMaxChunk], s_b[kMaxChunk], s_op[kMaxChunk];
  __shared__ float s_part[kWarps][kBatch][kCols];

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
  const float px_vp = fmaf(px, inv_w2, -1.0f) * width_f;
  const float py_vp = fmaf(-py, inv_h2, 1.0f) * full_height_f;

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
      const float* row = params + (long long)(first + j) * kCols;
      s_cx[j] = row[0];
      s_cy[j] = row[1];
      s_c2[j] = row[2];
      s_c3[j] = row[3];
      s_r[j] = row[6];
      s_g[j] = row[7];
      s_b[j] = row[8];
      if (kMode == kModeObb) {
        const float b1 = row[4];
        const bool ok = b1 > 0.0f;
        // b1 <= 0 is "outside" (alpha 0, no gradient): ib1 = 0 marks it
        s_c4[j] = ok ? 1.0f / fmaxf(b1, 1e-12f) : 0.0f;
        s_c5[j] = ok ? 1.0f / fmaxf(row[5], 1e-12f) : 0.0f;
        s_op[j] = ok ? row[9] : 0.0f;
      } else {
        s_c4[j] = row[4];
        s_c5[j] = row[5];
        s_op[j] = row[9];
      }
    }
    __syncthreads();
    for (int jb = 0; jb < m; jb += kBatch) {
      const int nb = min(kBatch, m - jb);
      for (int k = 0; k < nb; ++k) {
        const int j = jb + k;
        const float c2 = s_c2[j];
        const float c3 = s_c3[j];
        const float c4 = s_c4[j];
        const float c5 = s_c5[j];
        // OBB: dx = px - cx, u, v in the quad frame; AABB: dx = cx - px
        float dx, dy, u = 0.0f, v = 0.0f;
        float g = 0.0f;
        if (kMode == kModeObb) {
          dx = px_vp - s_cx[j];
          dy = py_vp - s_cy[j];
          u = (dx * c2 + dy * c3) * c4;
          v = (dx * c3 - dy * c2) * c5;
          if (c4 > 0.0f && fabsf(u) <= 1.0f && fabsf(v) <= 1.0f) g = expf(-4.5f * (u * u + v * v));
        } else {
          dx = s_cx[j] - px_vp;
          dy = s_cy[j] - py_vp;
          const float power = -0.5f * (c2 * dx * dx + c4 * dy * dy) + c3 * dx * dy;
          if (fabsf(dx) <= c5 && fabsf(dy) <= c5 && power <= 0.0f) g = expf(power);
        }
        const float op = s_op[j];
        const float raw = g * op;
        const float a = fminf(raw, 0.999f);
        // g == 0 on every pixel of the warp: a = w = q = 0, all ten partials
        // are exactly zero and T, q_acc do not move
        if (__any_sync(kFull, g != 0.0f)) {
          const float w = a * T;
          const float gc = g_r * s_r[j] + g_g * s_g[j] + g_b * s_b[j];
          q_acc += gc * w;
          const float inv_om = 1.0f / fmaxf(1.0f - a, 1e-6f);
          float dalpha = gc * T - (s_total - q_acc) * inv_om;
          if (raw >= 0.999f) dalpha = 0.0f;  // the cap's min() passes nothing
          const float dag = dalpha * g;
          const float dpower = dag * op;
          float d[kCols];
          if (kMode == kModeObb) {
            const float dub = (dpower * u) * (-9.0f * c4);
            const float dvb = (dpower * v) * (-9.0f * c5);
            // columns 0, 4, 5 are negated after the pixel sum
            d[0] = dub * c2 + dvb * c3;  // -dcx
            d[1] = dvb * c2 - dub * c3;  // dcy
            d[2] = dub * dx - dvb * dy;  // de1x
            d[3] = dub * dy + dvb * dx;  // de1y
            d[4] = dub * u;              // -db1
            d[5] = dvb * v;              // -db2
          } else {
            d[0] = dpower * (-c2 * dx + c3 * dy);  // dcx
            d[1] = dpower * (-c4 * dy + c3 * dx);  // dcy
            d[2] = dpower * (-0.5f * dx * dx);     // dconic.x
            d[3] = dpower * (dx * dy);             // dconic.y
            d[4] = dpower * (-0.5f * dy * dy);     // dconic.z
            d[5] = 0.0f;                           // radius: mask only
          }
          d[6] = w * g_r;
          d[7] = w * g_g;
          d[8] = w * g_b;
          d[9] = dag;  // dopacity
#pragma unroll
          for (int col = 0; col < kCols; ++col) {
            if (kMode == kModeAabb && col == 5) continue;
            d[col] = warp_sum(d[col]);
          }
          if (lane == 0) {
#pragma unroll
            for (int col = 0; col < kCols; ++col) s_part[warp][k][col] = d[col];
          }
          T *= 1.0f - a;
        } else if (lane == 0) {
#pragma unroll
          for (int col = 0; col < kCols; ++col) s_part[warp][k][col] = 0.0f;
        }
      }
      __syncthreads();
      // sum the eight warp partials in a fixed order; rows are contiguous
      float* out = dparams + (long long)(first + jb) * kCols;
      for (int i = p; i < nb * kCols; i += kPix) {
        const int k = i / kCols;
        const int col = i - k * kCols;
        float s = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < kWarps; ++w8) s += s_part[w8][k][col];
        const bool negate = kMode == kModeObb && (col == 0 || col == 4 || col == 5);
        out[i] = negate ? -s : s;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int bgs_composite_bwd(const void* params, const void* tile_start,
                                 const void* tile_count, const void* gbar, int num_tiles,
                                 int tx_count, float width_f, float full_height_f,
                                 float inv_w2, float inv_h2, int y0, int chunk, int mode,
                                 float trans_eps, void* dparams, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (mode != kModeObb && mode != kModeAabb) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    auto kernel = mode == kModeObb ? composite_bwd_kernel<kModeObb>
                                   : composite_bwd_kernel<kModeAabb>;
    kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
        (const float*)params, (const int*)tile_start, (const int*)tile_count,
        (const float*)gbar, tx_count, width_f, full_height_f, inv_w2, inv_h2, y0, chunk,
        trans_eps, (float*)dparams);
  }
  return (int)cudaGetLastError();
}
