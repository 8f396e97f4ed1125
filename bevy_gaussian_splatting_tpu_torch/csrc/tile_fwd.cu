// Forward tile compositor: front-to-back alpha blending of pair-sorted
// splats, one 16x16 tile per block.
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/tile_fwd.py
// `_composite_kernel` (launched by `pallas_forward_raw`), OBB, AABB and 2DGS
// modes (`kernel_mode`, tile_fwd.py:81-84).
//
// Inputs: params [P, 10] f32 in pair-sorted order, rows [cx_vp, cy_vp, e1x,
// e1y, b1, b2, r, g, b, alpha] (OBB) or [cx_vp, cy_vp, conic.x, conic.y,
// conic.z, radius_vp, r, g, b, alpha] (AABB); for 2DGS params [P, 16], rows
// [cx_ndc, cy_ndc, mr, A.xyz, B.xyz, C.xyz, r, g, b, alpha]; tile_start /
// tile_count [T] i32.  Output out [T, 4, 256] f32: rows 0-2 premultiplied
// rgb, row 3 final transmittance (the background is applied afterwards, in
// PyTorch).
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
//  * the OBB falloff uses the reciprocal form 1 / max(b, 1e-12);
//  * the AABB falloff (tile_fwd.py:146-157) takes the offset as centre minus
//    pixel, power = -0.5 (a dx dx + c dy dy) + b dx dy in the JAX order of
//    products, and clips to |dx|, |dy| <= r and power <= 0;
//  * the 2DGS falloff (tile_fwd.py:117-139) works in NDC: the vp pixel
//    coordinate times f32 1/width (1/full_height) as XLA folds it, the
//    offset pixel minus centre, clipped to |dxn| <= mr/width and |dyn| <= mr/full_height (both
//    products per pair, at staging, as the TPU kernel forms them per row);
//    q = dxn A + dyn B + C, pz = q.z where |q.z| > 1e-12 else +1e-12 (not
//    sign-preserving), one IEEE reciprocal 1/pz, s3d = us^2 + vs^2 and
//    d2x2 = (dxn^2 + dyn^2) * 2 width^2 (width on both axes, the reference's
//    doubled-frame quirk), g = exp(-0.5 min(s3d, d2x2)).  The three f32
//    constants come from the host, rounded as the TPU kernel rounds them.
// One kernel body serves all modes (a template on the mode): the chunk grid,
// the pixel coordinates, the exit vote and the blend are shared; only the
// staged columns and the falloff differ.
//
// What changes: the TPU kernel blends a chunk with a Hillis-Steele cumprod
// across lanes; here each thread (one pixel) blends its pairs in sequence,
// C += a * T * rgb, T *= 1 - a.  The products associate differently, so the
// bar against the plain version is a tolerance (2e-5; 1e-4 for 2DGS, whose
// reciprocal near pz = 0 amplifies an ulp), not bit equality.  The file is
// built with --fmad=false (see ops/cuda/build.py): contraction into FMA would
// move the inside test |u| <= 1 by an ulp and flip fragments, and would move
// the 2DGS min() branch.  It is never built with fast math: 1.0f / pz must
// stay IEEE-rounded.
//
// Bound on the H100: operations.  Each (pair, pixel) evaluation is about 25
// FP32 operations plus one expf, against ~40 bytes of parameters per pair
// shared by the 256 pixels of the tile.  Design: a chunk of parameter rows
// is staged once into shared memory as structure-of-arrays (with the two
// reciprocals computed at staging, once per pair instead of once per pixel),
// then every thread reads each row as a broadcast.  AABB costs about as much
// per evaluation (27 FP32 operations and one expf) and stages its conic and
// radius as they are.  2DGS stages 17 columns (34 KB at 512 pairs, static
// shared memory) and skips its homography where the pixel is outside the
// surfel's square: 4 operations per evaluation, and 37 more and one expf
// inside it.
//
// The bounding-box overlay (the TPU kernel's bbox=True branch,
// tile_fwd.py:140-145, :158-162, :180-185, :289-312) is a second
// instantiation of the same body (kBbox), so the non-overlay instantiations
// compile as before.  Its edge band, before the gate on the opacity:
//  * OBB: inside the quad and max(|u|, |v|) > band.  Rows with b1 <= 0 stay
//    folded into opacity 0 with u = v = 0: no edge, as JAX's inside & b1 > 0;
//  * AABB: inside the radius square (|dx|, |dy| <= r, not the power <= 0
//    test that gates g) and max(|dx|, |dy|) / max(r, 1e-12) > band, a true
//    IEEE divide as in the TPU kernel;
//  * 2DGS: inside the surfel's square and max(|dxn| width, |dyn|
//    full_height) / max(mr, 1e-12) > band.  The raw mr is staged as an 18th
//    column (36,864 B of static shared memory at 512 pairs).
// The edge holds only where the packed alpha column is > 0; there a = 1
// (above the 0.999 cap, so T becomes exactly 0) and the colour is the
// overlay's green (0.3, 1, 0.1).  The blend and the exit vote are unchanged.
// The band 1 - 2 * 0.08 comes from the host rounded to f32, as the TPU
// kernel's weakly typed constant is.  About 4 more operations per walked
// evaluation (OBB, AABB: the abs, max and compare, AABB's divide) and 6
// inside a 2DGS square.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // 256 threads, one per pixel
constexpr int kMaxChunk = 512;
constexpr int kModeObb = 0;
constexpr int kModeAabb = 1;
constexpr int kMode2d = 2;

// columns of a parameter row, and of a staged pair: OBB / AABB stage cx, cy,
// columns 2-5, r, g, b, alpha; 2DGS stages cx, cy, mr/width, mr/full_height,
// A.xyz, B.xyz, C.xyz, (with the overlay: mr,) r, g, b, alpha.  The colours
// and alpha are the last four in all.
template <int kMode>
constexpr int kRowCols = kMode == kMode2d ? 16 : 10;
template <int kMode, bool kBbox>
constexpr int kStaged = kMode == kMode2d ? (kBbox ? 18 : 17) : 10;
constexpr int kMrCol = 13;  // 2DGS with the overlay: the raw mr

template <int kMode, bool kBbox>
__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const float* __restrict__ params, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tx_count, float width_f,
                     float full_height_f, float inv_w2, float inv_h2, float inv_w, float inv_h,
                     float two_w2, int y0, int chunk, float trans_eps, float band,
                     float* __restrict__ out) {
  constexpr int kRow = kRowCols<kMode>;
  constexpr int kCol = kStaged<kMode, kBbox>;
  constexpr int kR = kCol - 4;  // staged r; g, b, alpha follow
  // OBB columns 2-5: e1x, e1y, 1/b1, 1/b2; AABB conic.x, conic.y, conic.z, r
  __shared__ float s[kCol][kMaxChunk];

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
  const float x_ndc = fmaf(px, inv_w2, -1.0f);
  const float y_ndc = fmaf(-py, inv_h2, 1.0f);
  const float px_vp = x_ndc * width_f;
  const float py_vp = y_ndc * full_height_f;
  // 2DGS: the vp coordinate times f32 1/width (tile_fwd.py:120-121), which
  // the compiled JAX kernel folds into x_ndc * f32(width * f32(1/width)), 1
  // for most sizes (ops/cuda/tile_fwd.py tile_pixel_coords)
  const float px_ndc = x_ndc * (width_f * inv_w);
  const float py_ndc = y_ndc * (full_height_f * inv_h);

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
        // b1 <= 0 is "outside" in the TPU kernel (alpha 0): fold it into
        // opacity 0 with u = v = 0, which gives the same alpha of exactly 0
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
        if constexpr (kBbox) s[kMrCol][j] = row[2];
      }
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      float g = 0.0f;
      bool edge = false;  // the overlay's edge band (kBbox only)
      if constexpr (kMode == kModeObb) {
        const float dx = px_vp - s[0][j];
        const float dy = py_vp - s[1][j];
        const float e1x = s[2][j];
        const float e1y = s[3][j];
        const float u = (dx * e1x + dy * e1y) * s[4][j];
        const float v = (dx * e1y - dy * e1x) * s[5][j];
        if (fabsf(u) <= 1.0f && fabsf(v) <= 1.0f) {
          g = expf(-4.5f * (u * u + v * v));
          if constexpr (kBbox) edge = fmaxf(fabsf(u), fabsf(v)) > band;
        }
      } else if constexpr (kMode == kModeAabb) {
        const float dx = s[0][j] - px_vp;
        const float dy = s[1][j] - py_vp;
        const float r = s[5][j];
        const float power = -0.5f * (s[2][j] * dx * dx + s[4][j] * dy * dy) + s[3][j] * dx * dy;
        const bool in_quad = fabsf(dx) <= r && fabsf(dy) <= r;
        if (in_quad && power <= 0.0f) g = expf(power);
        if constexpr (kBbox) edge = in_quad && fmaxf(fabsf(dx), fabsf(dy)) / fmaxf(r, 1e-12f) > band;
      } else {
        const float dxn = px_ndc - s[0][j];
        const float dyn = py_ndc - s[1][j];
        if (fabsf(dxn) <= s[2][j] && fabsf(dyn) <= s[3][j]) {
          const float qx = dxn * s[4][j] + dyn * s[7][j] + s[10][j];
          const float qy = dxn * s[5][j] + dyn * s[8][j] + s[11][j];
          const float qz = dxn * s[6][j] + dyn * s[9][j] + s[12][j];
          const float inv_pz = 1.0f / (fabsf(qz) > 1e-12f ? qz : 1e-12f);
          const float us = qx * inv_pz;
          const float vs = qy * inv_pz;
          const float s3d = us * us + vs * vs;
          const float d2x2 = (dxn * dxn + dyn * dyn) * two_w2;
          g = expf(-0.5f * fminf(s3d, d2x2));
          if constexpr (kBbox) {
            edge = fmaxf(fabsf(dxn) * width_f, fabsf(dyn) * full_height_f) / fmaxf(s[kMrCol][j], 1e-12f) > band;
          }
        }
      }
      float a, wr, wg, wb;
      if constexpr (kBbox) {
        edge = edge && s[kR + 3][j] > 0.0f;
        a = edge ? 1.0f : fminf(g * s[kR + 3][j], 0.999f);
        wr = edge ? 0.3f : s[kR][j];
        wg = edge ? 1.0f : s[kR + 1][j];
        wb = edge ? 0.1f : s[kR + 2][j];
      } else {
        a = fminf(g * s[kR + 3][j], 0.999f);
        wr = s[kR][j];
        wg = s[kR + 1][j];
        wb = s[kR + 2][j];
      }
      const float w = a * T;
      cr += w * wr;
      cg += w * wg;
      cb += w * wb;
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
                                 float inv_h2, float inv_w, float inv_h, float two_w2, int y0,
                                 int chunk, int mode, int bbox, float trans_eps, float band,
                                 void* out, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (mode != kModeObb && mode != kModeAabb && mode != kMode2d) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    auto kernel = mode == kModeObb    ? composite_fwd_kernel<kModeObb, false>
                  : mode == kModeAabb ? composite_fwd_kernel<kModeAabb, false>
                                      : composite_fwd_kernel<kMode2d, false>;
    if (bbox) {
      kernel = mode == kModeObb    ? composite_fwd_kernel<kModeObb, true>
               : mode == kModeAabb ? composite_fwd_kernel<kModeAabb, true>
                                   : composite_fwd_kernel<kMode2d, true>;
    }
    kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
        (const float*)params, (const int*)tile_start, (const int*)tile_count, tx_count,
        width_f, full_height_f, inv_w2, inv_h2, inv_w, inv_h, two_w2, y0, chunk, trans_eps, band,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
