// Forward tile compositor: front-to-back alpha blending of pair-sorted
// splats, one 16x16 tile per block.
//
// Replaces the TPU kernel bevy_gaussian_splatting_tpu/ops/pallas/tile_fwd.py
// `_composite_kernel` (tile_fwd.py:237, launched by `pallas_forward_raw`),
// OBB, AABB and 2DGS modes (`kernel_mode`, tile_fwd.py:81-84), each with and
// without the bounding-box overlay.
//
// Inputs: params [P, 10] f32 in pair-sorted order, rows [cx_vp, cy_vp, e1x,
// e1y, b1, b2, r, g, b, alpha] (OBB) or [cx_vp, cy_vp, conic.x, conic.y,
// conic.z, radius_vp, r, g, b, alpha] (AABB); for 2DGS params [P, 16], rows
// [cx_ndc, cy_ndc, mr, A.xyz, B.xyz, C.xyz, r, g, b, alpha]; tile_start /
// tile_count [T] i32.  Output out [T, 4, 256] f32 in row-major pixel order:
// rows 0-2 premultiplied rgb, row 3 final transmittance (the background is
// applied afterwards, in PyTorch).
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
//    expressions, keeping `y0` and `full_height` for band rendering
//    (cull.cuh pixel_coords);
//  * the OBB falloff uses the reciprocal form 1 / max(b, 1e-12);
//  * the AABB falloff (tile_fwd.py:146-157) takes the offset as centre minus
//    pixel, power = -0.5 (a dx dx + c dy dy) + b dx dy in the JAX order of
//    products, and clips to |dx|, |dy| <= r and power <= 0;
//  * the 2DGS falloff (tile_fwd.py:117-139) works in NDC: the vp pixel
//    coordinate times f32 1/width (1/full_height) as XLA folds it, the
//    offset pixel minus centre, clipped to |dxn| <= mr/width and |dyn| <=
//    mr/full_height (both products per pair, at staging, as the TPU kernel
//    forms them per row); q = dxn A + dyn B + C, pz = q.z where |q.z| >
//    1e-12 else +1e-12 (not sign-preserving), one IEEE reciprocal 1/pz, s3d
//    = us^2 + vs^2 and d2x2 = (dxn^2 + dyn^2) * 2 width^2 (width on both
//    axes, the reference's doubled-frame quirk), g = exp(-0.5 min(s3d,
//    d2x2)).  The three f32 constants come from the host, rounded as the TPU
//    kernel rounds them;
//  * the bounding-box overlay (the TPU kernel's bbox=True branch,
//    tile_fwd.py:140-145, :158-162, :180-185, :289-312; the kBbox
//    instantiations): its edge band, before the gate on the opacity, is
//    OBB: inside the quad and max(|u|, |v|) > band (rows with b1 <= 0 stay
//    folded into opacity 0 with u = v = 0: no edge, as JAX's inside & b1 >
//    0); AABB: inside the radius square (|dx|, |dy| <= r, not the power <= 0
//    test that gates g) and max(|dx|, |dy|) / max(r, 1e-12) > band, a true
//    IEEE divide; 2DGS: inside the surfel's square and max(|dxn| width, |dyn|
//    full_height) / max(mr, 1e-12) > band, with the raw mr staged beside
//    the homography.  The edge holds only where the packed alpha column is > 0;
//    there a = 1 (above the 0.999 cap, so T becomes exactly 0) and the colour
//    is the overlay's green (0.3, 1, 0.1).  The band 1 - 2 * 0.08 comes from
//    the host rounded to f32, as the TPU kernel's weakly typed constant is.
// One kernel body serves all six instantiations (a template on the mode and
// the overlay): only the staged columns and the falloff differ.
//
// The seventh, kSurface (2DGS training with the surface regularisers of
// Huang et al., SIGGRAPH 2024, section 4.2): rows of 23 columns, the 16 then
// det T0, A0.z, B0.z, C0.z (a fragment's depth coefficients with the scales
// factored out, ops/gaussian_2d.py surfel_depth_coeffs) and n.xyz (the unit
// normal, view space, facing the camera).  Its colour and transmittance are
// the serving branch's expressions in the same order, so they are bitwise
// the same; beside them, for each blended fragment with a >= 1/255 (the
// official rasteriser's least alpha, trans_eps's float32 value) whose depth
// z = det T0 / q0.z, q0.z = (dxn A0.z + dyn B0.z) + C0.z clamped to 1e-6
// in magnitude (not sign-preserving) and inverted once (the official (us,
// vs, 1) . c), is at least `near`, in blend order, with w = a T:
//   dist += w ((zeta^2 ad + z2) - 2 zeta z1), zeta = 1 / z (the running
//     sums before the fragment's own);
//   ad += w, z1 += w zeta, z2 += (w zeta) zeta, N += w n, D += w z;
//   the median (z and the pair index) is replaced where T > 0.5.
// It writes maps [T, 6, 256] (N.xyz, D, dist, median) and totals [T, 4,
// 256] (ad, z1, z2, the median's pair index as a float, exact below 2^24;
// -1 where none).  The seven columns are read from the row in device
// memory when a warp visits the pair (a broadcast load, cached): staged
// beside the 20 floats they would take the static shared memory past 48 KB.
//
// What changes: the TPU kernel blends a chunk with a Hillis-Steele cumprod
// across lanes; here each thread (one pixel) blends its pairs in sequence,
// C += a * T * rgb, T *= 1 - a.  The products associate differently, so the
// bar against the plain version is a tolerance (2e-5; 1e-4 for 2DGS, whose
// reciprocal near pz = 0 amplifies an ulp), not bit equality.  The file is
// built with --fmad=false (ops/cuda/build.py; cull.cuh inherits it):
// contraction into FMA would move the inside test |u| <= 1 by an ulp and flip
// fragments, and would move the 2DGS min() branch.  It is never built with
// fast math: 1.0f / pz must stay IEEE-rounded.
//
// What bounds it on the H100.  The work a frame needs is small: its rows
// read once, and per (pair, pixel) inside a splat about 30 FP32 operations
// with one expf (2DGS 45).  A splat of the bench scene reaches 5-8 of a
// tile's 256 pixels, so a kernel that gives every thread every walked pair
// spends almost all of its issued instructions on pixels with g = 0: ten or
// more shared-memory broadcasts, the offsets, the inside test and a blend
// step that changes no bit.  The design:
//
//  1. Per-warp footprint culling, from the mask the backward uses
//     (cull.cuh warp_mask): when a chunk is staged, the staging thread
//     computes each pair's mask of the 4x8-pixel warps its splat's box may
//     reach (s_mask), beside the staged columns.  After the staging barrier
//     each warp ballots its own bit over the chunk, 32 pairs at a time, and
//     walks only the set bits in pair order (__ffs); every visited pair goes
//     through the exact falloff and blend, the same expressions in the same
//     order.  A left-out (pair, warp) has g = 0 at all 32 pixels (and no
//     edge: the band lies inside the box), so a = 0 and T and C are
//     unchanged to the bit; the exit vote stays where it was, at the same
//     pair indices.  The image and the exit chunk are therefore those of the
//     unculled walk, bit for bit (cull.cuh states the one condition: finite
//     T).  The overlay instantiations use the same mask.
//  2. Threads map to pixels by 4x8-pixel warps (cull.cuh pixel_row,
//     pixel_col), the backward's map; the output stays in row-major pixel
//     order.
//  3. Staged rows as an array of structures, read as float4 broadcasts:
//     the staging thread writes each pair's row (with the OBB reciprocals
//     and the 2DGS mr/W, mr/H computed there, once per pair) as 12 floats
//     (2DGS 20) into shared memory, and every lane of a visiting warp reads
//     the same row with 128-bit loads: 3 loads a visit for OBB and AABB
//     where a structure of arrays took 10, and for 2DGS one load before its
//     square test.  All lanes read one address, so there are no bank
//     conflicts.  Shared memory: 25,216 B (2DGS 41,600 B) of static memory.
//
// The choice of item 3 was timed on the card against the structure of
// arrays and against __launch_bounds__ floors of 6 and 8 blocks per SM
// (which spill); PERF.md keeps that table.
//
// What is left: at the bench scene's 17-26% of (pair, warp) visits kept,
// the issued instructions of a kept visit (its broadcasts, falloff and
// blend), then the chunk barrier, where a chunk takes as long as its
// busiest warp, and the tail of the busiest tiles.  The bound that
// chip_smoke.py gives is the least work: the larger of the bytes (walked
// rows, tile ranges, output) and the operations (per walked pair its
// staging, per (pair, pixel) inside the splat the falloff and the blend).

#include <cuda_runtime.h>

#include "cull.cuh"

namespace {

// staged rows, kStride floats a pair, read by each warp as float4
// broadcasts (all lanes of a warp read the same pair):
//   OBB / AABB: [cx, cy, c2, c3 | c4, c5, -, - | r, g, b, alpha], OBB c4, c5
//     = 1/b1, 1/b2 and alpha folded to 0 where b1 <= 0;
//   2DGS: [cx, cy, mr/width, mr/full_height | A.xyz, B.x | B.yz, C.xy | C.z,
//     mr, -, - | r, g, b, alpha].
template <int kMode>
constexpr int kStride = kMode == kMode2d ? 20 : 12;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// the surface instantiation's extra columns (the depth's coefficients, n),
// after the 16
constexpr int kSurfaceCols = 7;
constexpr float kDepthEps = 1e-6f;  // the least |q0.z| of a fragment's depth (DEPTH_EPS)
constexpr float kMedianT = 0.5f;

template <int kMode, bool kBbox, bool kSurface = false>
__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const float* __restrict__ params, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tx_count, float width_f,
                     float full_height_f, float inv_w2, float inv_h2, float inv_w, float inv_h,
                     float two_w2, int y0, int chunk, float trans_eps, float band,
                     float* __restrict__ out, float* __restrict__ maps, float* __restrict__ totals,
                     float near) {
  static_assert(!kSurface || (kMode == kMode2d && !kBbox), "the surface maps are 2DGS's, without the overlay");
  constexpr int kRow = kRowCols<kMode> + (kSurface ? kSurfaceCols : 0);
  constexpr int kColour = kRowCols<kMode> - 4;  // r, g, b, alpha
  constexpr int kS = kStride<kMode>;
  __shared__ __align__(16) float s[kMaxChunk * kS];
  __shared__ unsigned char s_mask[kMaxChunk];  // each staged pair's warps
  __shared__ float s_colx[kTile];              // the falloff frame's x of the columns
  __shared__ float s_rowy[kTile];              // and y of the rows

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_start[t];
  const int base = (start / 128) * 128;
  const int prefix = start - base;
  const int total = tile_count[t] + prefix;
  const int n_chunks = (total + chunk - 1) / chunk;

  const int prow = pixel_row(tid);
  const int pcol = pixel_col(tid);
  const PixelCoords pc = pixel_coords(t, prow, pcol, tx_count, width_f, full_height_f, inv_w2, inv_h2, inv_w,
                                      inv_h, y0);
  const float px_vp = pc.px_vp;
  const float py_vp = pc.py_vp;
  const float px_ndc = pc.px_ndc;
  const float py_ndc = pc.py_ndc;
  if (prow == 0) s_colx[pcol] = kMode == kMode2d ? px_ndc : px_vp;
  if (pcol == 0) s_rowy[prow] = kMode == kMode2d ? py_ndc : py_vp;
  __syncthreads();  // s_colx, s_rowy before the first chunk's masks

  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  // the surface maps' running sums (kSurface only)
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, dsum = 0.0f, dist = 0.0f, zmed = 0.0f;
  float ad = 0.0f, z1 = 0.0f, z2 = 0.0f, med = -1.0f;
  for (int c = 0; c < n_chunks; ++c) {
    // between chunks: stop once every pixel of the tile is saturated (this
    // vote is also the barrier before the staging buffer is overwritten)
    if (c > 0 && !__syncthreads_or(T > trans_eps)) break;
    const int lo = max(prefix - c * chunk, 0);
    const int hi = min(total - c * chunk, chunk);
    const int first = base + c * chunk + lo;
    const int m = hi - lo;
    for (int j = tid; j < m; j += kPix) {
      const float* row = params + (long long)(first + j) * kRow;
      float* st = s + j * kS;
      float4 colour = make_float4(row[kColour], row[kColour + 1], row[kColour + 2], row[kColour + 3]);
      if constexpr (kMode == kModeObb) {
        const float b1 = row[4];
        const bool ok = b1 > 0.0f;
        // b1 <= 0 is "outside" in the TPU kernel (alpha 0): fold it into
        // opacity 0 with u = v = 0, which gives the same alpha of exactly 0
        *reinterpret_cast<float4*>(st) = make_float4(row[0], row[1], row[2], row[3]);
        *reinterpret_cast<float4*>(st + 4) = make_float4(ok ? 1.0f / fmaxf(b1, 1e-12f) : 0.0f,
                                                         ok ? 1.0f / fmaxf(row[5], 1e-12f) : 0.0f, 0.0f, 0.0f);
        colour.w = ok ? colour.w : 0.0f;
      } else if constexpr (kMode == kModeAabb) {
        *reinterpret_cast<float4*>(st) = make_float4(row[0], row[1], row[2], row[3]);
        *reinterpret_cast<float4*>(st + 4) = make_float4(row[4], row[5], 0.0f, 0.0f);
      } else {
        *reinterpret_cast<float4*>(st) = make_float4(row[0], row[1], row[2] * inv_w, row[2] * inv_h);
        *reinterpret_cast<float4*>(st + 4) = make_float4(row[3], row[4], row[5], row[6]);
        *reinterpret_cast<float4*>(st + 8) = make_float4(row[7], row[8], row[9], row[10]);
        *reinterpret_cast<float4*>(st + 12) = make_float4(row[11], row[2], 0.0f, 0.0f);
      }
      *reinterpret_cast<float4*>(st + kS - 4) = colour;
      s_mask[j] = (unsigned char)warp_mask<kMode>(row, s_colx, s_rowy, inv_w, inv_h);
    }
    __syncthreads();
    for (int jb = 0; jb < m; jb += 32) {
      // the pairs among the next 32 whose mask holds this warp, in order
      unsigned todo = __ballot_sync(kFull, jb + lane < m && ((s_mask[jb + lane] >> warp) & 1u));
      while (todo) {
        const int j = jb + __ffs(todo) - 1;
        todo &= todo - 1;
        const float* st = s + j * kS;
        const float4 h = ld4(st);
        float g = 0.0f;
        bool edge = false;  // the overlay's edge band (kBbox only)
        if constexpr (kMode == kModeObb) {
          const float4 k = ld4(st + 4);
          const float dx = px_vp - h.x;
          const float dy = py_vp - h.y;
          const float e1x = h.z;
          const float e1y = h.w;
          const float u = (dx * e1x + dy * e1y) * k.x;
          const float v = (dx * e1y - dy * e1x) * k.y;
          if (fabsf(u) <= 1.0f && fabsf(v) <= 1.0f) {
            g = expf(-4.5f * (u * u + v * v));
            if constexpr (kBbox) edge = fmaxf(fabsf(u), fabsf(v)) > band;
          }
        } else if constexpr (kMode == kModeAabb) {
          const float4 k = ld4(st + 4);
          const float dx = h.x - px_vp;
          const float dy = h.y - py_vp;
          const float r = k.y;
          const float power = -0.5f * (h.z * dx * dx + k.x * dy * dy) + h.w * dx * dy;
          const bool in_quad = fabsf(dx) <= r && fabsf(dy) <= r;
          if (in_quad && power <= 0.0f) g = expf(power);
          if constexpr (kBbox) edge = in_quad && fmaxf(fabsf(dx), fabsf(dy)) / fmaxf(r, 1e-12f) > band;
        } else {
          const float dxn = px_ndc - h.x;
          const float dyn = py_ndc - h.y;
          if (fabsf(dxn) <= h.z && fabsf(dyn) <= h.w) {
            const float4 f1 = ld4(st + 4);   // A.xyz, B.x
            const float4 f2 = ld4(st + 8);   // B.yz, C.xy
            const float4 f3 = ld4(st + 12);  // C.z, mr
            const float qx = dxn * f1.x + dyn * f1.w + f2.z;
            const float qy = dxn * f1.y + dyn * f2.x + f2.w;
            const float qz = dxn * f1.z + dyn * f2.y + f3.x;
            const float inv_pz = 1.0f / (fabsf(qz) > 1e-12f ? qz : 1e-12f);
            const float us = qx * inv_pz;
            const float vs = qy * inv_pz;
            const float s3d = us * us + vs * vs;
            const float d2x2 = (dxn * dxn + dyn * dyn) * two_w2;
            g = expf(-0.5f * fminf(s3d, d2x2));
            if constexpr (kBbox) {
              edge = fmaxf(fabsf(dxn) * width_f, fabsf(dyn) * full_height_f) / fmaxf(f3.y, 1e-12f) > band;
            }
          }
        }
        const float4 col = ld4(st + kS - 4);
        float a, wr, wg, wb;
        if constexpr (kBbox) {
          edge = edge && col.w > 0.0f;
          a = edge ? 1.0f : fminf(g * col.w, 0.999f);
          wr = edge ? 0.3f : col.x;
          wg = edge ? 1.0f : col.y;
          wb = edge ? 0.1f : col.z;
        } else {
          a = fminf(g * col.w, 0.999f);
          wr = col.x;
          wg = col.y;
          wb = col.z;
        }
        const float w = a * T;
        cr += w * wr;
        cg += w * wg;
        cb += w * wb;
        if constexpr (kSurface) {
          if (a >= trans_eps) {  // the fragments' least alpha: the same float32 1/255
            const float* sr = params + (long long)(first + j) * kRow + kRowCols<kMode>;
            const float q0z = ((px_ndc - h.x) * __ldg(sr + 1) + (py_ndc - h.y) * __ldg(sr + 2)) + __ldg(sr + 3);
            const float z = __ldg(sr) * (1.0f / (fabsf(q0z) > kDepthEps ? q0z : kDepthEps));
            if (z >= near) {
              const float zeta = 1.0f / z;
              dist += w * (((zeta * zeta) * ad + z2) - 2.0f * zeta * z1);
              const float wz = w * zeta;
              ad += w;
              z1 += wz;
              z2 += wz * zeta;
              nx += w * __ldg(sr + 4);
              ny += w * __ldg(sr + 5);
              nz += w * __ldg(sr + 6);
              dsum += w * z;
              if (T > kMedianT) {
                zmed = z;
                med = (float)(first + j);
              }
            }
          }
        }
        T *= 1.0f - a;
      }
    }
  }
  const int p = prow * kTile + pcol;
  float* o = out + (long long)t * 4 * kPix;
  o[p] = cr;
  o[kPix + p] = cg;
  o[2 * kPix + p] = cb;
  o[3 * kPix + p] = T;
  if constexpr (kSurface) {
    float* m = maps + (long long)t * 6 * kPix;
    m[p] = nx;
    m[kPix + p] = ny;
    m[2 * kPix + p] = nz;
    m[3 * kPix + p] = dsum;
    m[4 * kPix + p] = dist;
    m[5 * kPix + p] = zmed;
    float* q = totals + (long long)t * 4 * kPix;
    q[p] = ad;
    q[kPix + p] = z1;
    q[2 * kPix + p] = z2;
    q[3 * kPix + p] = med;
  }
}

}  // namespace

extern "C" int bgs_composite_fwd(const void* params, const void* tile_start,
                                 const void* tile_count, int num_tiles, int tx_count,
                                 float width_f, float full_height_f, float inv_w2,
                                 float inv_h2, float inv_w, float inv_h, float two_w2, int y0,
                                 int chunk, int mode, int bbox, float trans_eps, float band,
                                 void* out, void* maps, void* totals, float near, void* stream) {
  if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (mode != kModeObb && mode != kModeAabb && mode != kMode2d) return (int)cudaErrorInvalidValue;
  const bool surface = maps != nullptr;
  if (surface && (mode != kMode2d || bbox || totals == nullptr)) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    auto kernel = mode == kModeObb    ? composite_fwd_kernel<kModeObb, false>
                  : mode == kModeAabb ? composite_fwd_kernel<kModeAabb, false>
                                      : composite_fwd_kernel<kMode2d, false>;
    if (bbox) {
      kernel = mode == kModeObb    ? composite_fwd_kernel<kModeObb, true>
               : mode == kModeAabb ? composite_fwd_kernel<kModeAabb, true>
                                   : composite_fwd_kernel<kMode2d, true>;
    }
    if (surface) kernel = composite_fwd_kernel<kMode2d, false, true>;
    kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
        (const float*)params, (const int*)tile_start, (const int*)tile_count, tx_count,
        width_f, full_height_f, inv_w2, inv_h2, inv_w, inv_h, two_w2, y0, chunk, trans_eps, band,
        (float*)out, (float*)maps, (float*)totals, near);
  }
  return (int)cudaGetLastError();
}
