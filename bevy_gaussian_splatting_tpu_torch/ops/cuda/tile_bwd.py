"""Backward tile compositor: per-pair parameter gradients of the blend.

Replaces the TPU kernel ``bevy_gaussian_splatting_tpu/ops/pallas/tile_bwd.py``
``_backward_kernel`` (``pallas_composite_backward``) with
``csrc/tile_bwd.cu``: one block of 256 threads per 16x16 tile, one thread per
pixel, re-walking the tile front to back with the forward's chunk grid and
early exit.  OBB, AABB and 2DGS modes, as the forward.

A splat of the bench scene reaches a handful of a tile's pixels, so the
kernel was bound by issued instructions spent on pixels it does not reach,
not by its FP32 work or bytes.  Its design, for the H100: when a chunk is
staged, each pair gets a mask of the warps (4x8-pixel blocks) that its
splat's box may reach (``csrc/cull.cuh``, shared with the forward;
``ops/cuda/cull.py`` ``warp_masks`` is its twin, written with the kernel's
float32 operations in its order), and each warp walks only the
pairs whose mask holds it; a warp that a splat hits sums its 9-15 gradient
columns over its lanes with one multi-column reduce-scatter (12-16
shuffles); and each pair's sum reads only the warps of its mask, in warp
order (no atomics: two launches are bitwise equal).  Leaving out a (pair,
warp) whose pixels all have g = 0 changes no float, so the cull changes no
gradient and no exit vote.  On "NVIDIA H100 80GB HBM3, 700.00 W" at the
1M-gaussian bench scene this took the kernel from 1.54-1.99 ms to
0.65-1.11 ms (``chip_smoke.py``, the earlier kernel and this one in turns;
PERF.md).  See the source for the bounds and the design.

2DGS training with the surface maps (``tile_fwd.py``) takes a second 2DGS
instantiation: beside ``gbar`` it reads each pixel's surface cotangents and
totals (:func:`pack_surface_gbar`) and adds, for every fragment in the maps,
the gradients of N, D, the distortion and the median depth to the pair's
own: through alpha (the maps are sums of w = alpha T times per-fragment
values, so they join the colour's running suffix), through the depth z =
det T0 / q0.z into the depth's four coefficients, and into the normal.
Its rows and gradients have ``param_width(MODE_2D, True)`` = 23 columns.

``composite_backward`` launches the kernel for CUDA tensors and runs the
plain version, ``composite_backward_plain``, for CPU tensors.
``composite_backward.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bevy_gaussian_splatting_tpu_torch.ops.cuda import build
from bevy_gaussian_splatting_tpu_torch.ops.gaussian_2d import DEPTH_EPS
from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import (
    ALPHA_CAP,
    MAX_CHUNK,
    MODE_2D,
    MODE_AABB,
    MODE_OBB,
    MODES,
    PIX,
    TRANS_EPS,
    _check_inputs,
    _coord_constants,
    _surfel_constants,
    rgb_row,
    splat_falloff,
    surface_fragments,
    tile_pixel_coords,
)

GBAR_ROWS = 8  # [ghat_r, ghat_g, ghat_b, ghat_T, total_r, total_g, total_b, T_fin]
# [gN.xyz, gD, g_dist, g_median, sum w, sum w / z, sum w / z^2, median slot,
#  gN . N + gD D + 2 g_dist dist]
SURFACE_GBAR_ROWS = 11

_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 2
    + [ctypes.c_float] * 7
    + [ctypes.c_int] * 3
    + [ctypes.c_float]
    + [ctypes.c_void_p] * 2
    + [ctypes.c_float]
    + [ctypes.c_void_p]
)


def pack_gbar(grad_raw: torch.Tensor, out_raw: torch.Tensor) -> torch.Tensor:
    """Per-pixel backward inputs [T, 8, 256] from the cotangent of the raw
    forward output and the output itself (both [T, 4, 256]): rows 0-2 the
    rgb cotangent, 3 the transmittance cotangent, 4-6 the rgb totals, 7 the
    final transmittance (core.py:386-389 of the JAX package)."""
    return torch.cat([grad_raw, out_raw], dim=1).contiguous()


def pack_surface_gbar(grad_maps: torch.Tensor, maps: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """Per-pixel surface inputs of the backward [T, 11, 256] from the
    cotangent of the surface maps and the maps themselves (both [T, 6,
    256]) and the forward's totals [T, 4, 256]: the cotangents of N, D, the
    distortion and the median depth, the totals, and the maps' share of the
    running suffix's total, gN . N + gD D + 2 g_dist dist (the distortion's
    gradient in a fragment's weight, summed against the weights, is twice
    the distortion)."""
    s_extra = ((grad_maps[:, 0] * maps[:, 0] + grad_maps[:, 1] * maps[:, 1]) + grad_maps[:, 2] * maps[:, 2]
               + grad_maps[:, 3] * maps[:, 3]) + 2.0 * grad_maps[:, 4] * maps[:, 4]
    return torch.cat([grad_maps, totals, s_extra[:, None]], dim=1).contiguous()


def _check_gbar(gbar, tile_start, rows: int = GBAR_ROWS):
    if gbar.dtype != torch.float32:
        raise TypeError(f"gbar must be float32, got {gbar.dtype}")
    if tuple(gbar.shape) != (tile_start.shape[0], rows, PIX):
        raise ValueError(f"gbar must be [T, {rows}, {PIX}], got {tuple(gbar.shape)}")
    if gbar.device != tile_start.device:
        raise ValueError(f"gbar is on {gbar.device}, tile_start on {tile_start.device}")
    if not gbar.is_contiguous():
        raise ValueError("gbar must be contiguous")


def composite_backward_plain(
    params: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    gbar: torch.Tensor,
    tx_count: int,
    width: int,
    full_height: int,
    y0: int = 0,
    chunk: int = MAX_CHUNK,
    mode: int = MODE_OBB,
    tile_batch: int = 128,
    gaux: Optional[torch.Tensor] = None,
    aux_near: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version, vectorized over [tiles, chunk, 256] in batches
    of ``tile_batch`` tiles with the forward's chunk grid and exit rule
    (``composite_tiles_raw_plain``).  Within a chunk the transmittance is an
    exclusive ``cumprod`` and the running ``q`` prefix a ``cumsum``.
    ``gaux`` (:func:`pack_surface_gbar`) with ``aux_near`` adds the surface
    maps' gradients."""
    surface = gaux is not None
    dev = params.device
    num_tiles = tile_start.shape[0]
    p = params.shape[0]
    cols = params.shape[1]
    table = torch.cat([params, params.new_zeros((1, cols))], dim=0)
    dparams = params.new_zeros((p, cols))
    ro = rgb_row(mode)
    lane = torch.arange(chunk, device=dev)
    for b0 in range(0, num_tiles, tile_batch):
        tids = torch.arange(b0, min(b0 + tile_batch, num_tiles), device=dev)
        start = tile_start[tids].to(torch.int64)
        count = tile_count[tids].to(torch.int64)
        base = start // 128 * 128
        prefix = start - base
        total = count + prefix
        n_chunks = torch.where(count > 0, (total + chunk - 1) // chunk, torch.zeros_like(total))
        px, py = tile_pixel_coords(tids, tx_count, width, full_height, y0, mode)
        px, py = px[:, None, :], py[:, None, :]
        gb = gbar[tids]  # [B, 8, 256]
        ghat = [gb[:, ch, None, :] for ch in range(3)]  # [B, 1, 256]
        q_total = gb[:, 0] * gb[:, 4] + gb[:, 1] * gb[:, 5] + gb[:, 2] * gb[:, 6]
        s_total = q_total + gb[:, 3] * gb[:, 7]  # [B, 256]
        if surface:
            ga = gaux[tids]  # [B, 11, 256]
            s_total = s_total + ga[:, 10]
            gn = ga[:, :3]  # [B, 3, 256]
            gd, gl, gz, ad_t, z1_t, z2_t, med = (ga[:, k, None, :] for k in range(3, 10))
        trans = torch.ones((tids.shape[0], PIX), dtype=torch.float32, device=dev)
        q_acc = torch.zeros_like(trans)
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
            in_rng = (lane_idx >= prefix[:, None]) & (lane_idx < total[:, None]) & running[:, None]
            idx = (base[:, None] + lane_idx).clamp(max=p)
            q = table[idx]  # [B, chunk, cols]
            c2, c3, c4 = (q[..., i : i + 1] for i in range(2, 5))
            cr, cg, cb, op = (q[..., ro + i : ro + i + 1] for i in range(4))
            g, inside, aux = splat_falloff(q, px, py, mode, width, full_height)
            inside = inside & in_rng[..., None]
            g = torch.where(inside, g, 0.0)
            raw = g * op
            alpha = torch.clamp(raw, max=ALPHA_CAP)  # [B, chunk, 256]
            cum = torch.cumprod(1.0 - alpha, dim=1)
            excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
            t_i = excl * trans[:, None, :]
            w = alpha * t_i
            gc = ghat[0] * cr + ghat[1] * cg + ghat[2] * cb
            if surface:
                # the maps are sums of w times (n, z, the distortion's weight
                # gradient): they join the colour in gc
                z, inside_s, inv_z, q0z, inv_p0 = surface_fragments(q, aux, alpha, aux_near)
                gnn = (gn[:, None, 0] * q[..., 20:21] + gn[:, None, 1] * q[..., 21:22]) + gn[:, None, 2] * q[..., 22:23]
                lam = ((inv_z * inv_z) * ad_t - 2.0 * inv_z * z1_t) + z2_t
                gc = gc + torch.where(inside_s, (gnn + gd * z) + gl * lam, 0.0)
            qv = gc * w
            q_incl = q_acc[:, None, :] + torch.cumsum(qv, dim=1)
            inv_om = 1.0 / torch.clamp(1.0 - alpha, min=1e-6)
            dalpha = gc * t_i - (s_total[:, None, :] - q_incl) * inv_om
            dalpha = torch.where(raw >= ALPHA_CAP, 0.0, dalpha)
            dag = dalpha * g
            dpower = dag * op
            if mode == MODE_2D:
                # power = -0.5 min(s3d, d2x2), s3d = (qx^2 + qy^2) / qz^2 with
                # q = dxn A + dyn B + C (tile_bwd.py:333-366); the radius only
                # masks: no gradient
                dxn, dyn, qz, inv_pz, us, vs, s3d, d2x2 = aux
                take3d = s3d <= d2x2
                ds3d = torch.where(take3d, -0.5 * dpower, 0.0)
                dd2 = torch.where(take3d, 0.0, -dpower)
                dus = ds3d * 2.0 * us
                dvs = ds3d * 2.0 * vs
                dq2 = -(dus * us + dvs * vs) * inv_pz
                if surface:
                    # z = det T0 / q0.z, into det T0 and q0.z's coefficients
                    dzeta = gl * (2.0 * w * (inv_z * ad_t - z1_t))
                    dz = torch.where(inside_s, gd * w - dzeta * (inv_z * inv_z), 0.0)
                    slot = (base[:, None] + lane_idx).to(torch.float32)[..., None]
                    dz = torch.where(slot == med, dz + gz, dz)
                    dq0 = torch.where(q0z.abs() > DEPTH_EPS, -(dz * z) * inv_p0, 0.0)
                dq = (dus * inv_pz, dvs * inv_pz, torch.where(qz.abs() > 1e-12, dq2, 0.0))
                w2 = float(width) * float(width)
                ddxn = dd2 * 2.0 * w2 * dxn + (dq[0] * q[..., 3:4] + dq[1] * q[..., 4:5] + dq[2] * q[..., 5:6])
                ddyn = dd2 * 2.0 * w2 * dyn + (dq[0] * q[..., 6:7] + dq[1] * q[..., 7:8] + dq[2] * q[..., 8:9])
                if surface:  # q0.z = (dxn A0.z + dyn B0.z) + C0.z moves with the centre
                    ddxn = ddxn + dq0 * q[..., 17:18]
                    ddyn = ddyn + dq0 * q[..., 18:19]
                head = (
                    [torch.sum(-ddxn, dim=2), torch.sum(-ddyn, dim=2), torch.zeros_like(dpower[..., 0])]
                    + [torch.sum(dq[k] * dxn, dim=2) for k in range(3)]
                    + [torch.sum(dq[k] * dyn, dim=2) for k in range(3)]
                    + [torch.sum(dq[k], dim=2) for k in range(3)]
                )
            elif mode == MODE_AABB:
                # power = -0.5 (a dx^2 + c dy^2) + b dx dy with dx = cx - px
                # (tile_bwd.py:320-332); the radius only masks: no gradient
                dx, dy = aux
                head = [
                    torch.sum(dpower * (-c2 * dx + c3 * dy), dim=2),
                    torch.sum(dpower * (-c4 * dy + c3 * dx), dim=2),
                    torch.sum(dpower * (-0.5 * dx * dx), dim=2),
                    torch.sum(dpower * (dx * dy), dim=2),
                    torch.sum(dpower * (-0.5 * dy * dy), dim=2),
                    torch.zeros_like(dpower[..., 0]),
                ]
            else:
                dx, dy, u, v, inv_b1, inv_b2 = aux
                dub = (dpower * u) * (-9.0 * inv_b1)
                dvb = (dpower * v) * (-9.0 * inv_b2)
                head = [
                    -torch.sum(dub * c2 + dvb * c3, dim=2),
                    torch.sum(dvb * c2 - dub * c3, dim=2),
                    torch.sum(dub * dx - dvb * dy, dim=2),
                    torch.sum(dub * dy + dvb * dx, dim=2),
                    -torch.sum(dub * u, dim=2),
                    -torch.sum(dvb * v, dim=2),
                ]
            tail = []
            if surface:
                we = torch.where(inside_s, w, 0.0)
                tail = [torch.sum(dz * inv_p0, dim=2), torch.sum(dq0 * dxn, dim=2), torch.sum(dq0 * dyn, dim=2),
                        torch.sum(dq0, dim=2)]
                tail += [torch.sum(we * gn[:, None, k], dim=2) for k in range(3)]
            grads = torch.stack(
                head + [
                    torch.sum(w * ghat[0], dim=2),
                    torch.sum(w * ghat[1], dim=2),
                    torch.sum(w * ghat[2], dim=2),
                    torch.sum(dag, dim=2),
                ] + tail,
                dim=-1,
            )  # [B, chunk, cols]
            dparams[idx[in_rng]] = grads[in_rng]
            q_acc = q_incl[:, -1, :]
            trans = trans * cum[:, -1, :]
    return dparams


def composite_backward(
    params: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    gbar: torch.Tensor,
    tx_count: int,
    width: int,
    full_height: int,
    y0: int = 0,
    chunk: int = MAX_CHUNK,
    mode: int = MODE_OBB,
    gaux: Optional[torch.Tensor] = None,
    aux_near: Optional[float] = None,
) -> torch.Tensor:
    """Per-pair gradients [P, param_width(mode)] of the tile blend, in the
    pair-sorted layout of ``params``.

    Takes the forward's inputs (``composite_tiles_raw``) and ``gbar`` [T, 8,
    256] from :func:`pack_gbar`.  Pairs the forward did not blend (past the
    clipped count or the early exit, or in no tile) get exact zeros, and so
    do the columns that only mask: the AABB radius (5) and the 2DGS surfel
    radius (2).  ``gaux`` [T, 11, 256] from :func:`pack_surface_gbar`, with
    the forward's ``aux_near``, adds the surface maps' gradients to 2DGS
    rows of 23 columns (the last seven: the depth's coefficients and n)."""
    surface = gaux is not None
    if surface != (aux_near is not None):
        raise ValueError("gaux and aux_near go together")
    _check_inputs(params, tile_start, tile_count, chunk, mode, surface)
    _check_gbar(gbar, tile_start)
    if surface:
        _check_gbar(gaux, tile_start, SURFACE_GBAR_ROWS)
    if params.device.type == "cpu":
        return composite_backward_plain(
            params, tile_start, tile_count, gbar, tx_count, width, full_height, y0, chunk, mode,
            gaux=gaux, aux_near=aux_near,
        )
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    dev = params.device
    num_tiles = tile_start.shape[0]
    dparams = torch.zeros_like(params)
    inv_w2, inv_h2 = _coord_constants(width, full_height)
    inv_w, inv_h, two_w2 = _surfel_constants(width, full_height)
    lib = build.load("tile_bwd")
    fn = lib.bgs_composite_bwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            params.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(), gbar.data_ptr(),
            num_tiles, tx_count, float(width), float(full_height), inv_w2, inv_h2,
            inv_w, inv_h, two_w2, int(y0), chunk, mode, TRANS_EPS, dparams.data_ptr(),
            gaux.data_ptr() if surface else None, float(aux_near) if surface else 0.0, stream,
        )
    build.check(status, "composite_backward")
    if num_tiles > 0:
        composite_backward.launches += 1
    return dparams


def occupancy() -> dict:
    """Per mode name, the kernel's resident blocks per SM and dynamic shared
    memory (bytes) on the current CUDA device: ``{"obb": (blocks, bytes),
    ...}``, ``"2d_surface"`` the 2DGS instantiation with the surface
    maps."""
    fn = build.load("tile_bwd").bgs_composite_bwd_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for mode, name in {**MODES, MODE_2D + 1: "2d_surface"}.items():
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        build.check(fn(mode, ctypes.byref(blocks), ctypes.byref(smem)), "composite_backward occupancy")
        out[name] = (blocks.value, smem.value)
    return out


composite_backward.launches = 0
