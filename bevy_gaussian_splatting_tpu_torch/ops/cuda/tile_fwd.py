"""Forward tile compositor and its epilogue.

Replaces the TPU kernel ``bevy_gaussian_splatting_tpu/ops/pallas/tile_fwd.py``
``_composite_kernel`` (``pallas_forward_raw`` / ``pallas_composite_tiles``)
with ``csrc/tile_fwd.cu``: one block of 256 threads per 16x16 tile, one
thread per pixel, parameter rows staged chunk by chunk into shared memory and
blended in sequence.  Three modes, as the TPU kernel's ``kernel_mode``: OBB
(``MODE_OBB``, the eigen-rotated quad), AABB (``MODE_AABB``, the conic
quadratic form clipped to the radius square) and 2DGS (``MODE_2D``, the
surfel's folded homography clipped to its square).  It keeps what the TPU
kernel does that changes the image (chunk grid, between-chunk early exit,
pixel coordinates).

A splat of the bench scene reaches a handful of a tile's pixels, so a kernel
that gives every thread every pair spends almost all of its instructions on
pixels with g = 0.  Its design, for the H100: each staged pair gets the
mask of the 4x8-pixel warps its splat's box may reach (``csrc/cull.cuh``,
the backward's mask; ``ops/cuda/cull.py`` is its twin), and each warp blends
only the pairs whose mask holds it, in pair order, with the exact falloff.
A left-out (pair, warp) has a = 0 at every pixel, so the image and the exit
vote are those of the unculled walk, bit for bit.  See the source for the
bounds and the design; ``PERF.md`` for the times.

The bounding-box overlay (``CloudSettings.visualize_bounding_box``, the TPU
kernel's ``bbox=True`` branch: opaque green edge bands, tile_fwd.py:140-145,
:158-162, :180-185, :289-312) is a second instantiation of the kernel in
each mode; its edge band lies inside the same mask.

2DGS training with the surface regularisers of Huang et al. (SIGGRAPH 2024,
section 4.2) takes a third instantiation of the 2DGS branch,
``aux_near`` given: its rows carry seven more columns (``SURFACE_COLS``: a
fragment's depth coefficients det T0, A0.z, B0.z, C0.z and the
camera-facing unit normal n in view space), and in the same pass over the
pairs it writes, beside the colour,
each pixel's surface maps (``SURFACE_MAPS`` rows: the normal N = sum w n,
the depth D = sum w z, the distortion of inverse depth sum_{j<i} w_i w_j
(1/z_i - 1/z_j)^2 and the median depth) and the totals its backward needs
(``SURFACE_TOTALS`` rows).  A fragment enters the maps where its alpha is
at least ``AUX_ALPHA_MIN`` and its depth z at least ``aux_near``, as the
official rasteriser's fragments do.  The depth is the official one, (us, vs,
1) . c with c the homography's column 2 (its ``Tw``), evaluated as det T0 /
q0.z, the same number with the scales factored out of the homography
(``ops/gaussian_2d.py`` ``surfel_depth_coeffs``, which says why).  The
median is the depth of the last such fragment whose incoming transmittance
is above ``MEDIAN_T``.  The colour and transmittance are those of the
serving instantiation, bit for bit.

``composite_tiles_raw`` launches the kernel for CUDA tensors and runs the
plain version, ``composite_tiles_raw_plain``, for CPU tensors.
``composite_tiles_raw.launches`` counts kernel launches, and
``composite_tiles_raw.instances`` counts them per (mode, overlay).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.ops.cuda import build
from bevy_gaussian_splatting_tpu_torch.ops.gaussian_2d import DEPTH_EPS
from bevy_gaussian_splatting_tpu_torch.utils.trace import spanned

TILE = 16
PIX = TILE * TILE  # 256
# Row layouts (tile_fwd.py:72-78):
#   OBB  [cx_vp, cy_vp, e1x, e1y, b1, b2, r, g, b, alpha]
#   AABB [cx_vp, cy_vp, conic.x, conic.y, conic.z, radius_vp, r, g, b, alpha]
#   2DGS [cx_ndc, cy_ndc, mr, A.xyz, B.xyz, C.xyz, r, g, b, alpha]
MODE_OBB = 0
MODE_AABB = 1
MODE_2D = 2
MODES = {MODE_OBB: "obb", MODE_AABB: "aabb", MODE_2D: "2d"}
# 2DGS training rows with the surface maps: the 16 columns, then det T0,
# A0.z, B0.z, C0.z (a fragment's depth is det T0 / (dxn A0.z + dyn B0.z +
# C0.z)) and n.xyz (the unit normal, view space, facing the camera)
SURFACE_COLS = 7
# per pixel: N.xyz, D, the inverse-depth distortion, the median depth
SURFACE_MAPS = 6
# per pixel, for the backward: sum w, sum w / z, sum w / z^2 over the
# fragments in the maps, and the median fragment's pair index (-1: none)
SURFACE_TOTALS = 4
MEDIAN_T = 0.5  # the median's incoming transmittance must be above this
AUX_NEAR = 0.2  # the official 2DGS rasteriser's near plane for fragments
# the official rasteriser's least alpha of a fragment (1 / 255, float32)
AUX_ALPHA_MIN = float(np.float32(1.0 / 255.0))
ALPHA_CAP = 0.999
TRANS_EPS = float(np.float32(1.0 / 255.0))
MAX_CHUNK = 512
BBOX_GREEN = (0.3, 1.0, 0.1)  # bounding-box overlay colour (tile_fwd.py:68)
# the overlay's edge band 1 - 2 * 0.08 (tile_fwd.py:69), rounded to float32
# as the TPU kernel's weakly typed constant is in its float32 comparisons
EDGE_BAND = float(np.float32(1.0 - 2.0 * 0.08))

_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2
    + [ctypes.c_float] * 7
    + [ctypes.c_int] * 4
    + [ctypes.c_float] * 2
    + [ctypes.c_void_p] * 3
    + [ctypes.c_float]
    + [ctypes.c_void_p]
)


def param_width(mode: int, surface: bool = False) -> int:
    """Columns of a parameter row in ``mode``: 16 for 2DGS (23 with the
    surface columns), else 10."""
    return 16 + (SURFACE_COLS if surface else 0) if mode == MODE_2D else 10


def rgb_row(mode: int) -> int:
    """Column of the first colour (alpha follows at +3)."""
    return 12 if mode == MODE_2D else 6


def preferred_chunk(p_max: int, num_tiles: int) -> int:
    """Chunk size from the mean per-tile pair budget, as the TPU kernel picks
    it (tile_fwd.py:56-62): 256 at or below 320 budgeted pairs per tile, else
    512.  The chunk grid decides where the early exit may stop a tile, so it
    is part of the image, not only of the speed."""
    avg = p_max / max(num_tiles, 1)
    return 256 if avg <= 320 else 512


def _coord_constants(width: int, full_height: int):
    """f32 values of 2/width and 2/full_height, as the TPU kernel's weakly
    typed constants round them."""
    return float(np.float32(2.0 / width)), float(np.float32(2.0 / full_height))


def _surfel_constants(width: int, full_height: int):
    """f32 values of 1/width, 1/full_height and 2 width^2: the 2DGS branch's
    radius scalings and its doubled-frame distance factor, as the TPU kernel's
    weakly typed constants round them (tile_fwd.py:123-137)."""
    return (
        float(np.float32(1.0 / width)),
        float(np.float32(1.0 / full_height)),
        float(np.float32(2.0 * width * width)),
    )


def tile_ndc(tids, tx_count: int, width: int, full_height: int, y0: int = 0):
    """NDC pixel centres of tiles ``tids`` [B] -> ([B, 256], [B, 256]).

    The expressions of ``_tile_pixel_coords`` (tile_fwd.py:87-103) with the
    multiply-add fused, ``fma(px, 2/width, -1)``, as the compiled JAX kernel
    evaluates them (XLA contracts it) and as csrc/tile_fwd.cu does with
    ``fmaf``.  The float64 product and sum are exact here (at most 35
    significant bits), so rounding them once to float32 is the fused
    result."""
    inv_w2, inv_h2 = _coord_constants(width, full_height)
    sub = torch.arange(PIX, device=tids.device)
    px = (tids % tx_count)[:, None] * TILE + (sub % TILE) + 0.5
    py = (tids // tx_count)[:, None] * TILE + (sub // TILE) + 0.5 + y0
    return (px.double() * inv_w2 - 1.0).float(), (1.0 - py.double() * inv_h2).float()


def tile_pixel_coords(tids, tx_count: int, width: int, full_height: int, y0: int = 0, mode: int = MODE_OBB):
    """Pixel centers of tiles ``tids`` [B] -> ([B, 256], [B, 256]) in the
    frame ``mode``'s falloff evaluates in: vp units (:func:`tile_ndc` times
    the width or the full height), or NDC for 2DGS.

    The 2DGS branch scales the vp value back by f32 1/width (:120-121);
    compiled, XLA folds the two constants into one, ``fma(...) * f32(width
    * f32(1/width))``, and so does the port.  The folded factor is exactly 1
    for most sizes (512, 1920, 120, 1080; not 656 or 121), so a 2DGS pixel
    is at the fused NDC coordinate itself: one rounding less than the vp
    value scaled back, which the doubled-frame distance (2 width^2 per NDC
    unit squared) would amplify to 1e-4 in g."""
    x, y = tile_ndc(tids, tx_count, width, full_height, y0)
    if mode == MODE_2D:
        inv_w, inv_h, _ = _surfel_constants(width, full_height)
        return x * float(np.float32(width * np.float32(inv_w))), y * float(np.float32(full_height * np.float32(inv_h)))
    return x * float(width), y * float(full_height)


def _check_inputs(params, tile_start, tile_count, chunk, mode, surface: bool = False):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode}")
    if surface and mode != MODE_2D:
        raise ValueError("the surface maps are 2DGS's: mode must be MODE_2D")
    if params.dtype != torch.float32:
        raise TypeError(f"params must be float32, got {params.dtype}")
    cols = param_width(mode, surface)
    if params.dim() != 2 or params.shape[1] != cols:
        raise ValueError(f"params must be [P, {cols}] in mode {MODES[mode]}, got {tuple(params.shape)}")
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != tile_start.shape[0]:
            raise ValueError(f"{name} must be [T]")
        if t.device != params.device:
            raise ValueError(f"{name} is on {t.device}, params on {params.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not params.is_contiguous():
        raise ValueError("params must be contiguous")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in (0, {MAX_CHUNK}], got {chunk}")


def splat_falloff(q, px, py, mode: int, width: int, full_height: int, with_edge: bool = False):
    """The Gaussian term g of rows ``q`` [..., param_width(mode)] at pixels
    ``px``, ``py`` (:func:`tile_pixel_coords` of ``mode``: vp units, or NDC
    for 2DGS), zero outside the splat's quad, in the kernel's operation
    order (``_chunk_alpha``, tile_fwd.py:106-179).  Returns ``(g, inside,
    aux)``; ``aux`` holds what the backward chains through: ``(dx, dy)`` for
    AABB, ``(dx, dy, u, v, inv_b1, inv_b2)`` for OBB, ``(dxn, dyn, qz,
    inv_pz, us, vs, s3d, d2x2)`` for 2DGS.  ``with_edge`` appends the
    bounding-box overlay's edge band (``_chunk_alpha(with_edge=True)``),
    before its gate on the opacity: OBB ``max(|u|, |v|)``, AABB
    ``max(|dx|, |dy|) / max(r, 1e-12)`` in the radius square (whatever the
    falloff there), 2DGS ``max(|dxn| width, |dyn| full_height) / max(mr,
    1e-12)`` in the surfel's square, each above ``EDGE_BAND``."""
    if mode == MODE_2D:
        # NDC offsets, pixel minus centre; q = dxn A + dyn B + C; the clamp
        # of q.z is not sign-preserving, as the TPU kernel's (:131)
        inv_w, inv_h, two_w2 = _surfel_constants(width, full_height)
        dxn = px - q[..., 0:1]
        dyn = py - q[..., 1:2]
        mr = q[..., 2:3]
        inside = (dxn.abs() <= mr * inv_w) & (dyn.abs() <= mr * inv_h)
        qx, qy, qz = (dxn * q[..., 3 + k : 4 + k] + dyn * q[..., 6 + k : 7 + k] + q[..., 9 + k : 10 + k]
                      for k in range(3))
        inv_pz = 1.0 / torch.where(qz.abs() > 1e-12, qz, torch.full_like(qz, 1e-12))
        us = qx * inv_pz
        vs = qy * inv_pz
        s3d = us * us + vs * vs
        # doubled-frame quirk: both axes scale by the width
        d2x2 = (dxn * dxn + dyn * dyn) * two_w2
        g = torch.where(inside, torch.exp(-0.5 * torch.minimum(s3d, d2x2)), 0.0)
        out = g, inside, (dxn, dyn, qz, inv_pz, us, vs, s3d, d2x2)
        if with_edge:
            uvm = torch.maximum(dxn.abs() * float(width), dyn.abs() * float(full_height)) / torch.clamp(mr, min=1e-12)
            out += (inside & (uvm > EDGE_BAND),)
        return out
    cx, cy, c2, c3, c4, c5 = (q[..., i : i + 1] for i in range(6))
    if mode == MODE_AABB:
        # conic quadratic form clipped to the radius square; the offset is
        # centre minus pixel, the opposite sign of OBB's
        dx = cx - px
        dy = cy - py
        power = -0.5 * (c2 * dx * dx + c4 * dy * dy) + c3 * dx * dy
        in_quad = (dx.abs() <= c5) & (dy.abs() <= c5)
        inside = in_quad & (power <= 0.0)
        out = torch.where(inside, torch.exp(power), 0.0), inside, (dx, dy)
        if with_edge:
            out += (in_quad & (torch.maximum(dx.abs(), dy.abs()) / torch.clamp(c5, min=1e-12) > EDGE_BAND),)
        return out
    dx = px - cx
    dy = py - cy
    inv_b1 = 1.0 / torch.clamp(c4, min=1e-12)
    inv_b2 = 1.0 / torch.clamp(c5, min=1e-12)
    u = (dx * c2 + dy * c3) * inv_b1
    v = (dx * c3 - dy * c2) * inv_b2
    inside = (u.abs() <= 1.0) & (v.abs() <= 1.0) & (c4 > 0.0)
    g = torch.where(inside, torch.exp(-4.5 * (u * u + v * v)), 0.0)
    out = g, inside, (dx, dy, u, v, inv_b1, inv_b2)
    if with_edge:
        out += (inside & (torch.maximum(u.abs(), v.abs()) > EDGE_BAND),)
    return out


def overlay_alpha(g, edge, q, mode: int):
    """Alpha of rows ``q`` for the Gaussian term ``g`` with the bounding-box
    overlay's ``edge`` (``None`` without it) -> (alpha, edge): the edge gated
    by the packed alpha column > 0, where it holds alpha exactly 1, above
    ``ALPHA_CAP``, so T becomes exactly 0 (tile_fwd.py:180-185, :289-291)."""
    ro = rgb_row(mode)
    opacity = q[..., ro + 3 : ro + 4]
    alpha = torch.clamp(g * opacity, max=ALPHA_CAP)
    if edge is None:
        return alpha, None
    edge = edge & (opacity > 0.0)
    return torch.where(edge, 1.0, alpha), edge


def overlay_rgb(q, edge, mode: int, ch: int):
    """Colour channel ``ch`` of rows ``q``: the overlay's green where
    ``edge`` holds (``None``: no overlay)."""
    ro = rgb_row(mode)
    rgb = q[..., ro + ch : ro + ch + 1]
    return rgb if edge is None else torch.where(edge, BBOX_GREEN[ch], rgb)


def composite_tiles_raw_plain(
    params: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tx_count: int,
    width: int,
    full_height: int,
    y0: int = 0,
    chunk: int = MAX_CHUNK,
    mode: int = MODE_OBB,
    tile_batch: int = 128,
    walked: Optional[torch.Tensor] = None,
    bbox: bool = False,
    inside_count: Optional[torch.Tensor] = None,
    aux_near: Optional[float] = None,
):
    """Plain PyTorch version, vectorized over [tiles, chunk, 256] in batches
    of ``tile_batch`` tiles, with the kernel's chunk grid and exit rule.
    Within a chunk the blend is an exclusive ``cumprod``.  ``bbox`` draws
    the bounding-box overlay (:func:`overlay_alpha`); ``aux_near`` adds the
    surface maps and totals (:func:`composite_tiles_raw`), the running sums
    of a chunk as exclusive ``cumsum``.

    ``walked``, if given ([T] int64), receives the number of in-range pairs
    each tile evaluated before its early exit, and ``inside_count`` the
    number of those (pair, pixel) evaluations inside the splat's quad."""
    dev = params.device
    num_tiles = tile_start.shape[0]
    p = params.shape[0]
    # one zero row past the end keeps every clamped gather in bounds
    table = torch.cat([params, params.new_zeros((1, params.shape[1]))], dim=0)
    out = torch.empty((num_tiles, 4, PIX), dtype=torch.float32, device=dev)
    if aux_near is not None:
        maps = torch.zeros((num_tiles, SURFACE_MAPS, PIX), dtype=torch.float32, device=dev)
        totals = torch.zeros((num_tiles, SURFACE_TOTALS, PIX), dtype=torch.float32, device=dev)
        totals[:, 3] = -1.0
    lane = torch.arange(chunk, device=dev)
    for b0 in range(0, num_tiles, tile_batch):
        tids = torch.arange(b0, min(b0 + tile_batch, num_tiles), device=dev)
        start = tile_start[tids].to(torch.int64)
        base = start // 128 * 128
        prefix = start - base
        total = tile_count[tids].to(torch.int64) + prefix
        n_chunks = (total + chunk - 1) // chunk
        px, py = tile_pixel_coords(tids, tx_count, width, full_height, y0, mode)
        px, py = px[:, None, :], py[:, None, :]
        trans = torch.ones((tids.shape[0], PIX), dtype=torch.float32, device=dev)
        accum = torch.zeros((tids.shape[0], 3, PIX), dtype=torch.float32, device=dev)
        if aux_near is not None:
            m_acc, t_acc = maps[tids], totals[tids]
        # lanes past the batch's longest range are masked in every tile:
        # leave them out (alpha 0 multiplies and adds exactly nothing)
        span = int(total.max()) if tids.numel() else 0
        for c in range(int(n_chunks.max()) if tids.numel() else 0):
            running = c < n_chunks
            if c > 0:
                running = running & (trans.amax(dim=1) > TRANS_EPS)
            if not bool(running.any()):
                break
            lane_idx = c * chunk + lane[: span - c * chunk]
            in_rng = (
                (lane_idx >= prefix[:, None])
                & (lane_idx < total[:, None])
                & running[:, None]
            )  # [B, chunk]
            if walked is not None:
                walked[tids] += in_rng.sum(dim=1)
            idx = (base[:, None] + lane_idx).clamp(max=p)
            q = table[idx]  # [B, chunk, param_width(mode)]
            falloff = splat_falloff(q, px, py, mode, width, full_height, with_edge=bbox)
            alpha, edge = overlay_alpha(falloff[0], falloff[3] if bbox else None, q, mode)
            if inside_count is not None:
                inside_count[tids] += (falloff[1] & in_rng[..., None]).sum(dim=(1, 2))
            alpha = torch.where(in_rng[..., None], alpha, 0.0)  # [B, chunk, 256]
            cum = torch.cumprod(1.0 - alpha, dim=1)
            excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
            w = alpha * excl * trans[:, None, :]
            for ch in range(3):
                accum[:, ch] += torch.sum(w * overlay_rgb(q, edge, mode, ch), dim=1)
            if aux_near is not None:
                t_i = excl * trans[:, None, :]
                _surface_chunk(m_acc, t_acc, q, falloff[2], alpha, t_i, w, aux_near, base[:, None] + lane_idx)
            trans = trans * cum[:, -1]
        out[tids, :3] = accum
        out[tids, 3] = trans
        if aux_near is not None:
            maps[tids], totals[tids] = m_acc, t_acc
    return out if aux_near is None else (out, maps, totals)


def surface_fragments(q, falloff_aux, alpha, near: float):
    """The fragments of 2DGS surface rows ``q`` [..., 23] that enter the
    surface maps -> (z, inside, inv_z, q0z, inv_p0): the depth z = det T0 /
    q0.z of the ray-plane intersection at the pixel (``splat_falloff``'s
    offsets dxn, dyn; q0.z = (dxn A0.z + dyn B0.z) + C0.z from the row's
    columns 16-19, clamped to ``DEPTH_EPS`` in magnitude, not
    sign-preserving, and inverted once), in the maps where alpha >=
    ``AUX_ALPHA_MIN`` and z >= ``near``, and 1 / z there (0 elsewhere)."""
    q0z = (falloff_aux[0] * q[..., 17:18] + falloff_aux[1] * q[..., 18:19]) + q[..., 19:20]
    inv_p0 = 1.0 / torch.where(q0z.abs() > DEPTH_EPS, q0z, torch.full_like(q0z, DEPTH_EPS))
    z = q[..., 16:17] * inv_p0
    inside = (alpha >= AUX_ALPHA_MIN) & (z >= near)
    inv_z = torch.where(inside, 1.0 / torch.where(inside, z, 1.0), 0.0)
    return z, inside, inv_z, q0z, inv_p0


def _exclusive(run: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``run`` [B, 256] plus the sum of ``v`` [B, L, 256] over the lanes
    before each lane -> [B, L, 256]."""
    c = torch.cumsum(v, dim=1)
    return run[:, None, :] + torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)


def _surface_chunk(maps, totals, q, falloff_aux, alpha, t_i, w, near: float, pair_idx):
    """Fold a chunk's fragments into the running ``maps`` [B, 6, 256] and
    ``totals`` [B, 4, 256] (in place): the kernel's per-fragment steps, the
    distortion's running sums taken before each fragment's own."""
    z, inside, inv_z, _, _ = surface_fragments(q, falloff_aux, alpha, near)
    we = torch.where(inside, w, 0.0)
    wz = we * inv_z
    ad, z1, z2 = (_exclusive(totals[:, k], v) for k, v in enumerate((we, wz, wz * inv_z)))
    maps[:, 4] += torch.sum(we * ((inv_z * inv_z) * ad + z2 - 2.0 * inv_z * z1), dim=1)
    for k in range(3):
        maps[:, k] += torch.sum(we * q[..., 20 + k : 21 + k], dim=1)
    maps[:, 3] += torch.sum(we * z, dim=1)
    totals[:, 0] += torch.sum(we, dim=1)
    totals[:, 1] += torch.sum(wz, dim=1)
    totals[:, 2] += torch.sum(wz * inv_z, dim=1)
    # the median: the chunk's last fragment in the maps entered above MEDIAN_T
    lanes = torch.arange(alpha.shape[1], device=alpha.device)[None, :, None]
    last = torch.where(inside & (t_i > MEDIAN_T), lanes, -1).amax(dim=1)  # [B, 256]
    found = last >= 0
    pick = last.clamp(min=0)[:, None, :]
    maps[:, 5] = torch.where(found, torch.gather(z, 1, pick)[:, 0], maps[:, 5])
    slot = torch.gather(pair_idx[..., None].expand_as(alpha), 1, pick)[:, 0]
    totals[:, 3] = torch.where(found, slot.to(torch.float32), totals[:, 3])


@spanned("gs.composite")
def composite_tiles_raw(
    params: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tx_count: int,
    width: int,
    full_height: int,
    y0: int = 0,
    chunk: int = MAX_CHUNK,
    mode: int = MODE_OBB,
    bbox: bool = False,
    aux_near: Optional[float] = None,
):
    """Composite every tile -> raw [T, 4, 256]: rows 0-2 premultiplied rgb,
    row 3 final transmittance.

    ``params`` [P, param_width(mode)] f32: pair-sorted rows of ``mode``'s
    layout;
    ``tile_start`` / ``tile_count`` [T] int32: each tile's range in
    ``params`` (counts already clipped to the per-tile budget).
    ``full_height`` and ``y0`` place the tile grid in the full image (``y0``
    = 0 for one device).  ``bbox`` draws the bounding-box overlay, a
    separate instantiation of the kernel; ``composite_tiles_raw.instances``
    counts the launches of each (mode name, bbox, surface maps).

    ``aux_near`` (2DGS, no overlay; rows of ``param_width(MODE_2D, True)``
    columns) also composites the surface maps -> ``(raw, maps, totals)``:
    ``maps`` [T, SURFACE_MAPS, 256] rows N.xyz, D, the distortion of inverse
    depth and the median depth (0 where no fragment is the median);
    ``totals`` [T, SURFACE_TOTALS, 256] rows sum w, sum w / z, sum w / z^2
    and the median fragment's pair index (-1 where none), for the
    backward."""
    surface = aux_near is not None
    if surface and bbox:
        raise ValueError("the surface maps are composited without the bounding-box overlay")
    _check_inputs(params, tile_start, tile_count, chunk, mode, surface)
    if params.device.type == "cpu":
        return composite_tiles_raw_plain(
            params, tile_start, tile_count, tx_count, width, full_height, y0, chunk, mode, bbox=bbox,
            aux_near=aux_near,
        )
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    dev = params.device
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, 4, PIX), dtype=torch.float32, device=dev)
    maps = torch.empty((num_tiles, SURFACE_MAPS, PIX), dtype=torch.float32, device=dev) if surface else None
    totals = torch.empty((num_tiles, SURFACE_TOTALS, PIX), dtype=torch.float32, device=dev) if surface else None
    inv_w2, inv_h2 = _coord_constants(width, full_height)
    inv_w, inv_h, two_w2 = _surfel_constants(width, full_height)
    lib = build.load("tile_fwd")
    fn = lib.bgs_composite_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            params.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
            num_tiles, tx_count, float(width), float(full_height), inv_w2, inv_h2,
            inv_w, inv_h, two_w2, int(y0), chunk, mode, int(bbox), TRANS_EPS, EDGE_BAND,
            out.data_ptr(), maps.data_ptr() if surface else None, totals.data_ptr() if surface else None,
            float(aux_near) if surface else 0.0, stream,
        )
    build.check(status, "composite_tiles_raw")
    if num_tiles > 0:
        composite_tiles_raw.launches += 1
        key = (MODES[mode], bool(bbox)) + (("surface",) if surface else ())
        composite_tiles_raw.instances[key] = composite_tiles_raw.instances.get(key, 0) + 1
    return (out, maps, totals) if surface else out


composite_tiles_raw.launches = 0
composite_tiles_raw.instances = {}


@spanned("gs.composite")
def composite_epilogue(out_raw: torch.Tensor, background, width: int, height: int) -> torch.Tensor:
    """Raw kernel rows [T, 4, 256] -> [H, W, 4] with the background blended
    under the splats (tile_fwd.py:435-472): a solid [4] RGBA, or a full
    image [H, W, 4] (``height`` the padded grid's) blended per pixel.
    Differentiable in ``out_raw`` and ``background``."""
    tx_count = width // TILE
    ty_count = height // TILE
    accum = out_raw[:, :3, :].transpose(1, 2)  # [T, 256, 3]
    trans = out_raw[:, 3, :]  # [T, 256]
    alpha_out = 1.0 - trans
    if background is not None:
        if background.dim() == 1:
            bg_rgb, bg_a = background[:3], background[3]
        else:
            bg_tiles = (
                background.reshape(ty_count, TILE, tx_count, TILE, 4)
                .permute(0, 2, 1, 3, 4)
                .reshape(tx_count * ty_count, PIX, 4)
            )
            bg_rgb, bg_a = bg_tiles[..., :3], bg_tiles[..., 3]
        accum = accum + trans[..., None] * bg_rgb
        alpha_out = alpha_out + trans * bg_a
    return tiles_to_image(torch.cat([accum, alpha_out[..., None]], dim=-1), width, height)


def tiles_to_image(tile_rows: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Per-tile pixel rows [T, 256, C] in row-major pixel order -> the image
    [height, width, C] (``height`` the padded grid's)."""
    c = tile_rows.shape[-1]
    return (
        tile_rows.reshape(height // TILE, width // TILE, TILE, TILE, c)
        .permute(0, 2, 1, 3, 4)
        .reshape(height, width, c)
    )
