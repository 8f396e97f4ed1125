// Per-warp footprint culling, shared by the forward and the backward tile
// compositors (csrc/tile_fwd.cu, csrc/tile_bwd.cu): the tile and warp
// geometry, the thread-to-pixel map, the pixel coordinates and the mask of
// the warps a pair's splat may reach.
//
// A tile of 16 x 16 pixels is one block of 256 threads, one per pixel; its
// eight warps are blocks of kWarpRows x kWarpCols = 4 x 8 pixels, two
// across and four down, lanes in row-major order within a warp.  The
// output and gbar layouts stay in row-major pixel order; only the map from
// thread to pixel follows the warp shape.
//
// The mask (warp_mask) is decided once per pair, when its chunk is staged.
// The staging thread bounds the splat by a box |px - cx| <= hx, |py - cy|
// <= hy in the falloff's frame and turns it into the set of warps whose
// pixels it may touch.  A strip of pixels is left out when fl(x - cx) at
// its first and last pixel both lie beyond the box: rounding is monotone,
// so every pixel between does too.  AABB and 2DGS test that with the exact
// test's own half-widths (the radius; the staged mr/W, mr/H), so their box
// is the clip itself.  OBB's box is the rotated rectangle's, (b1 |e1x| + b2
// |e1y|, b1 |e1y| + b2 |e1x|) / |e1|^2, widened by 2^-13 of hx + hy: the
// rounding of u, v, 1/b and the box's own arithmetic stay below 20 ulps of
// hx + hy, so no pixel that the exact test keeps is dropped.  b1 <= 0 is
// empty (the exact test rejects it); an axis with |e1|^2 < 2^-100 (or NaN)
// keeps every warp, and so does any NaN in the box (the comparisons are
// written so that NaN keeps).  The overlay's edge band lies inside the same
// box: OBB's needs |u|, |v| <= 1, AABB's the radius square, 2DGS's the
// surfel's square.
//
// A row whose alpha or any of its three colour columns is not finite keeps
// every warp.  Both compositors skip a left-out (pair, warp) on the grounds
// that g = 0 there, so a = min(g alpha, 0.999) = 0 and C += a T rgb, T *=
// 1 - a change no bit; that holds only for a finite alpha and colour
// (fminf(0 inf, 0.999) is 0.999, and 0 NaN is NaN).  With the rule a
// culled walk equals the unculled one bit for bit for any row, as long as
// every pixel's T stays finite, which it does for alphas >= 0 (the packed
// alpha is opacity x global opacity x mask).  The backward's gradients
// cannot change from it: it only keeps more warps, where g = 0.
//
// The PyTorch twin of the mask, with the same float32 operations in the
// same order, is ops/cuda/cull.py `warp_masks`.  Both sources are built
// with --fmad=false (ops/cuda/build.py), which this header inherits.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // 256 threads, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kMaxChunk = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAllWarps = (1u << kWarps) - 1u;
constexpr int kModeObb = 0;
constexpr int kModeAabb = 1;
constexpr int kMode2d = 2;

// columns of a parameter row: 2DGS 16, OBB and AABB 10; the colours and
// alpha are the last four in all
template <int kMode>
constexpr int kRowCols = kMode == kMode2d ? 16 : 10;

// the warp shape: kWarpRows x kWarpCols pixels; the eight warps of a tile
// as kStripsY rows of kStripsX warps
constexpr int kWarpRows = 4;
constexpr int kWarpCols = 8;
constexpr int kStripsX = kTile / kWarpCols;
constexpr int kStripsY = kTile / kWarpRows;
// OBB's box margin, a share of hx + hy, and the smallest |e1|^2 it trusts
constexpr float kObbMargin = 0x1p-13f;
constexpr float kMinAxisNorm2 = 0x1p-100f;

// Thread tid's pixel in the tile: warp (warp / kStripsX, warp % kStripsX),
// lane in row-major order within it.
__device__ __forceinline__ int pixel_row(int tid) {
  return ((tid >> 5) / kStripsX) * kWarpRows + (tid & 31) / kWarpCols;
}
__device__ __forceinline__ int pixel_col(int tid) {
  return ((tid >> 5) % kStripsX) * kWarpCols + (tid & 31) % kWarpCols;
}

// A pixel centre of tile t in the falloff's frames: vp units (OBB, AABB)
// and NDC (2DGS).  _tile_pixel_coords (ops/pallas/tile_fwd.py:87-103):
// integer-valued adds are exact; the multiply-add is fused, as the compiled
// JAX kernel evaluates it and as the plain version computes it
// (ops/cuda/tile_fwd.py); `y0` and `full_height` place the tile in the full
// image (bands).  2DGS: the vp coordinate times f32 1/width (tile_fwd.py:
// 120-121), which the compiled JAX kernel folds into x_ndc * f32(width *
// f32(1/width)), 1 for most sizes (ops/cuda/tile_fwd.py tile_pixel_coords).
struct PixelCoords {
  float px_vp, py_vp, px_ndc, py_ndc;
};

__device__ __forceinline__ PixelCoords pixel_coords(int t, int prow, int pcol, int tx_count, float width_f,
                                                    float full_height_f, float inv_w2, float inv_h2, float inv_w,
                                                    float inv_h, int y0) {
  const float px = (float)((t % tx_count) * kTile + pcol) + 0.5f;
  const float py = ((float)((t / tx_count) * kTile + prow) + 0.5f) + (float)y0;
  const float x_ndc = fmaf(px, inv_w2, -1.0f);
  const float y_ndc = fmaf(-py, inv_h2, 1.0f);
  return {x_ndc * width_f, y_ndc * full_height_f, x_ndc * (width_f * inv_w), y_ndc * (full_height_f * inv_h)};
}

// Bit w set: the splat of `row` (a parameter row in global memory) may
// reach a pixel of warp w.  `colx` holds the falloff frame's x of the
// tile's 16 columns, `rowy` the y of its 16 rows (decreasing with the row).
template <int kMode>
__device__ __forceinline__ unsigned warp_mask(const float* row, const float* colx, const float* rowy,
                                              float inv_w, float inv_h) {
  constexpr int kRow = kRowCols<kMode>;
#pragma unroll
  for (int k = kRow - 4; k < kRow; ++k) {
    if (!isfinite(row[k])) return kAllWarps;  // a skipped blend is exact only for finite values
  }
  float hx, hy;
  if constexpr (kMode == kModeObb) {
    if (!(row[4] > 0.0f)) return 0u;  // the exact test's b1 <= 0: outside
    const float b1 = fmaxf(row[4], 1e-12f);
    const float b2 = fmaxf(row[5], 1e-12f);
    const float ax = fabsf(row[2]);
    const float ay = fabsf(row[3]);
    const float n2 = row[2] * row[2] + row[3] * row[3];
    if (!(n2 >= kMinAxisNorm2)) return kAllWarps;
    hx = (b1 * ax + b2 * ay) / n2;
    hy = (b1 * ay + b2 * ax) / n2;
    const float grow = (hx + hy) * kObbMargin;
    hx += grow;
    hy += grow;
  } else if constexpr (kMode == kModeAabb) {
    hx = row[5];
    hy = row[5];
  } else {
    hx = row[2] * inv_w;
    hy = row[2] * inv_h;
  }
  const float cx = row[0];
  const float cy = row[1];
  unsigned xs = 0, ys = 0;
#pragma unroll
  for (int sx = 0; sx < kStripsX; ++sx) {
    const float lo = colx[sx * kWarpCols] - cx;
    const float hi = colx[sx * kWarpCols + kWarpCols - 1] - cx;
    if (!(lo > hx || hi < -hx)) xs |= 1u << sx;
  }
#pragma unroll
  for (int sy = 0; sy < kStripsY; ++sy) {
    const float hi = rowy[sy * kWarpRows] - cy;
    const float lo = rowy[sy * kWarpRows + kWarpRows - 1] - cy;
    if (!(lo > hy || hi < -hy)) ys |= 1u << sy;
  }
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if ((ys >> (w / kStripsX)) & (xs >> (w % kStripsX)) & 1u) mask |= 1u << w;
  }
  return mask;
}

}  // namespace
