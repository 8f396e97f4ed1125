// Forward tile compositor: front-to-back alpha blending of pair-sorted
// splats, one 16x16 tile per block.
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/tile_fwd.py
// `_composite_kernel` (launched by `pallas_forward_raw`), OBB mode.
//
// Inputs: params [P, 10] f32 rows [cx_vp, cy_vp, e1x, e1y, b1, b2, r, g, b,
// alpha] in pair-sorted order; tile_start / tile_count [T] i32.  Output
// out [T, 4, 256] f32: rows 0-2 premultiplied rgb, row 3 final transmittance
// (the background is applied afterwards, in PyTorch).
//
// Semantics kept from the TPU kernel, because they change the image:
//  * the walk over a tile's range goes in chunks aligned at
//    base = floor(start / 128) * 128, with the pairs before `start` masked;
//  * the early exit is tested only between chunks: the tile stops when every
//    one of its 256 pixels has T <= 1/255.  Here that is a block-wide vote,
//    __syncthreads_or, at the same pair indices as the TPU kernel.  A pixel
//    does not stop on its own: what it would still add after T < 1/255 is up
//    to 4e-3, far above the 2e-5 bar;
//  * the pixel coordinates are `_tile_pixel_coords` with the same f32
//    expressions, keeping `y0` and `full_height` for band rendering;
//  * the OBB falloff uses the reciprocal form 1 / max(b, 1e-12).
//
// What changes: the TPU kernel blends a chunk with a Hillis-Steele cumprod
// across lanes; here each thread (one pixel) blends its pairs in sequence,
// C += a * T * rgb, T *= 1 - a.  The products associate differently, so the
// bar against the plain version is a tolerance (2e-5), not bit equality.
// The file is built with --fmad=false (see ops/cuda/build.py): contraction
// into FMA would move the inside test |u| <= 1 by an ulp and flip fragments.
//
// Bound on the H100: operations.  Each (pair, pixel) evaluation is about 25
// FP32 operations plus one expf, against ~40 bytes of parameters per pair
// shared by the 256 pixels of the tile.  Design: a chunk of parameter rows
// is staged once into shared memory as structure-of-arrays (with the two
// reciprocals computed at staging, once per pair instead of once per pixel),
// then every thread reads each row as a broadcast.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // 256 threads, one per pixel
constexpr int kCols = 10;
constexpr int kMaxChunk = 512;

__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const float* __restrict__ params, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tx_count, float width_f,
                     float full_height_f, float inv_w2, float inv_h2, int y0,
                     int chunk, float trans_eps, float* __restrict__ out) {
  __shared__ float s_cx[kMaxChunk], s_cy[kMaxChunk], s_e1x[kMaxChunk], s_e1y[kMaxChunk];
  __shared__ float s_ib1[kMaxChunk], s_ib2[kMaxChunk];
  __shared__ float s_r[kMaxChunk], s_g[kMaxChunk], s_b[kMaxChunk], s_op[kMaxChunk];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int base = (start / 128) * 128;
  const int prefix = start - base;
  const int total = tile_count[t] + prefix;
  const int n_chunks = (total + chunk - 1) / chunk;

  // _tile_pixel_coords (tile_fwd.py:87-103): integer-valued adds are exact;
  // the multiply-add is fused, as the compiled JAX kernel evaluates it and
  // as the plain version computes it (ops/cuda/tile_fwd.py)
  const float px = (float)((t % tx_count) * kTile + p % kTile) + 0.5f;
  const float py = ((float)((t / tx_count) * kTile + p / kTile) + 0.5f) + (float)y0;
  const float px_vp = fmaf(px, inv_w2, -1.0f) * width_f;
  const float py_vp = fmaf(-py, inv_h2, 1.0f) * full_height_f;

  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    // between chunks: stop once every pixel of the tile is saturated (this
    // vote is also the barrier before the staging buffer is overwritten)
    if (c > 0 && !__syncthreads_or(T > trans_eps)) break;
    const int lo = max(prefix - c * chunk, 0);
    const int hi = min(total - c * chunk, chunk);
    const int first = base + c * chunk + lo;
    const int m = hi - lo;
    for (int j = p; j < m; j += kPix) {
      const float* row = params + (long long)(first + j) * kCols;
      const float b1 = row[4];
      const bool ok = b1 > 0.0f;
      s_cx[j] = row[0];
      s_cy[j] = row[1];
      s_e1x[j] = row[2];
      s_e1y[j] = row[3];
      // b1 <= 0 is "outside" in the TPU kernel (alpha 0): fold it into
      // opacity 0 with u = v = 0, which gives the same alpha of exactly 0
      s_ib1[j] = ok ? 1.0f / fmaxf(b1, 1e-12f) : 0.0f;
      s_ib2[j] = ok ? 1.0f / fmaxf(row[5], 1e-12f) : 0.0f;
      s_r[j] = row[6];
      s_g[j] = row[7];
      s_b[j] = row[8];
      s_op[j] = ok ? row[9] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float dx = px_vp - s_cx[j];
      const float dy = py_vp - s_cy[j];
      const float e1x = s_e1x[j];
      const float e1y = s_e1y[j];
      const float u = (dx * e1x + dy * e1y) * s_ib1[j];
      const float v = (dx * e1y - dy * e1x) * s_ib2[j];
      float g = 0.0f;
      if (fabsf(u) <= 1.0f && fabsf(v) <= 1.0f) g = expf(-4.5f * (u * u + v * v));
      const float a = fminf(g * s_op[j], 0.999f);
      const float w = a * T;
      cr += w * s_r[j];
      cg += w * s_g[j];
      cb += w * s_b[j];
      T *= 1.0f - a;
    }
  }
  float* o = out + (long long)t * 4 * kPix;
  o[p] = cr;
  o[kPix + p] = cg;
  o[2 * kPix + p] = cb;
  o[3 * kPix + p] = T;
}

}  // namespace

extern "C" int bgs_composite_fwd(const void* params, const void* tile_start,
                                 const void* tile_count, int num_tiles, int tx_count,
                                 float width_f, float full_height_f, float inv_w2,
                                 float inv_h2, int y0, int chunk, float trans_eps,
                                 void* out, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
        (const float*)params, (const int*)tile_start, (const int*)tile_count, tx_count,
        width_f, full_height_f, inv_w2, inv_h2, y0, chunk, trans_eps, (float*)out);
  }
  return (int)cudaGetLastError();
}
