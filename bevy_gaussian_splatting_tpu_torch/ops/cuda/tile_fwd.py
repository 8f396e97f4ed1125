"""Forward tile compositor and its epilogue.

Replaces the TPU kernel ``bevy_gaussian_splatting_tpu/ops/pallas/tile_fwd.py``
``_composite_kernel`` (``pallas_forward_raw`` / ``pallas_composite_tiles``)
with ``csrc/tile_fwd.cu``: one block of 256 threads per 16x16 tile, one
thread per pixel, parameter rows staged chunk by chunk into shared memory and
blended in sequence.  On the H100 it is bound by FP32 operations (about 25
per pair and pixel, plus one ``expf``); see the source for the design and
for what it keeps of the TPU kernel (chunk grid, between-chunk early exit,
pixel coordinates).

``composite_tiles_raw`` launches the kernel for CUDA tensors and runs the
plain version, ``composite_tiles_raw_plain``, for CPU tensors.
``composite_tiles_raw.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.ops.cuda import build

TILE = 16
PIX = TILE * TILE  # 256
N_COLS = 10  # [cx_vp, cy_vp, e1x, e1y, b1, b2, r, g, b, alpha]
ALPHA_CAP = 0.999
TRANS_EPS = float(np.float32(1.0 / 255.0))
MAX_CHUNK = 512

_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2
    + [ctypes.c_float] * 4
    + [ctypes.c_int] * 2
    + [ctypes.c_float]
    + [ctypes.c_void_p] * 2
)


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


def tile_pixel_coords(tids, tx_count: int, width: int, full_height: int, y0: int = 0):
    """vp-unit pixel centers of tiles ``tids`` [B] -> ([B, 256], [B, 256]),
    the expressions of ``_tile_pixel_coords`` (tile_fwd.py:87-103) with the
    multiply-add fused, ``fma(px, 2/width, -1) * width``, as the compiled JAX
    kernel evaluates them (XLA contracts it) and as csrc/tile_fwd.cu does
    with ``fmaf``.  The float64 product and sum are exact here (at most 35
    significant bits), so rounding them once to float32 is the fused
    result."""
    inv_w2, inv_h2 = _coord_constants(width, full_height)
    sub = torch.arange(PIX, device=tids.device)
    px = (tids % tx_count)[:, None] * TILE + (sub % TILE) + 0.5
    py = (tids // tx_count)[:, None] * TILE + (sub // TILE) + 0.5 + y0
    px_vp = (px.double() * inv_w2 - 1.0).float() * float(width)
    py_vp = (1.0 - py.double() * inv_h2).float() * float(full_height)
    return px_vp, py_vp


def _check_inputs(params, tile_start, tile_count, chunk):
    if params.dtype != torch.float32:
        raise TypeError(f"params must be float32, got {params.dtype}")
    if params.dim() != 2 or params.shape[1] != N_COLS:
        raise ValueError(f"params must be [P, {N_COLS}], got {tuple(params.shape)}")
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


def composite_tiles_raw_plain(
    params: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tx_count: int,
    width: int,
    full_height: int,
    y0: int = 0,
    chunk: int = MAX_CHUNK,
    tile_batch: int = 128,
    walked: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version, vectorized over [tiles, chunk, 256] in batches
    of ``tile_batch`` tiles, with the kernel's chunk grid and exit rule.
    Within a chunk the blend is an exclusive ``cumprod``.

    ``walked``, if given ([T] int64), receives the number of in-range pairs
    each tile evaluated before its early exit."""
    dev = params.device
    num_tiles = tile_start.shape[0]
    p = params.shape[0]
    # one zero row past the end keeps every clamped gather in bounds
    table = torch.cat([params, params.new_zeros((1, N_COLS))], dim=0)
    out = torch.empty((num_tiles, 4, PIX), dtype=torch.float32, device=dev)
    lane = torch.arange(chunk, device=dev)
    for b0 in range(0, num_tiles, tile_batch):
        tids = torch.arange(b0, min(b0 + tile_batch, num_tiles), device=dev)
        start = tile_start[tids].to(torch.int64)
        base = start // 128 * 128
        prefix = start - base
        total = tile_count[tids].to(torch.int64) + prefix
        n_chunks = (total + chunk - 1) // chunk
        px_vp, py_vp = tile_pixel_coords(tids, tx_count, width, full_height, y0)
        px_vp, py_vp = px_vp[:, None, :], py_vp[:, None, :]
        trans = torch.ones((tids.shape[0], PIX), dtype=torch.float32, device=dev)
        accum = torch.zeros((tids.shape[0], 3, PIX), dtype=torch.float32, device=dev)
        for c in range(int(n_chunks.max()) if tids.numel() else 0):
            running = c < n_chunks
            if c > 0:
                running = running & (trans.amax(dim=1) > TRANS_EPS)
            if not bool(running.any()):
                break
            lane_idx = c * chunk + lane
            in_rng = (
                (lane_idx >= prefix[:, None])
                & (lane_idx < total[:, None])
                & running[:, None]
            )  # [B, chunk]
            if walked is not None:
                walked[tids] += in_rng.sum(dim=1)
            idx = (base[:, None] + lane_idx).clamp(max=p)
            q = table[idx]  # [B, chunk, 10]
            cx, cy, e1x, e1y, b1, b2 = (q[..., i : i + 1] for i in range(6))
            dx = px_vp - cx
            dy = py_vp - cy
            inv_b1 = 1.0 / torch.clamp(b1, min=1e-12)
            inv_b2 = 1.0 / torch.clamp(b2, min=1e-12)
            u = (dx * e1x + dy * e1y) * inv_b1
            v = (dx * e1y - dy * e1x) * inv_b2
            inside = (u.abs() <= 1.0) & (v.abs() <= 1.0) & (b1 > 0.0)
            g = torch.where(inside, torch.exp(-4.5 * (u * u + v * v)), 0.0)
            alpha = torch.clamp(g * q[..., 9:10], max=ALPHA_CAP)
            alpha = torch.where(in_rng[..., None], alpha, 0.0)  # [B, chunk, 256]
            cum = torch.cumprod(1.0 - alpha, dim=1)
            excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
            w = alpha * excl * trans[:, None, :]
            for ch in range(3):
                accum[:, ch] += torch.sum(w * q[..., 6 + ch : 7 + ch], dim=1)
            trans = trans * cum[:, -1]
        out[tids, :3] = accum
        out[tids, 3] = trans
    return out


def composite_tiles_raw(
    params: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tx_count: int,
    width: int,
    full_height: int,
    y0: int = 0,
    chunk: int = MAX_CHUNK,
) -> torch.Tensor:
    """Composite every tile -> raw [T, 4, 256]: rows 0-2 premultiplied rgb,
    row 3 final transmittance.

    ``params`` [P, 10] f32: pair-sorted OBB rows; ``tile_start`` /
    ``tile_count`` [T] int32: each tile's range in ``params`` (counts already
    clipped to the per-tile budget).  ``full_height`` and ``y0`` place the
    tile grid in the full image (``y0`` = 0 for one device)."""
    _check_inputs(params, tile_start, tile_count, chunk)
    if params.device.type == "cpu":
        return composite_tiles_raw_plain(
            params, tile_start, tile_count, tx_count, width, full_height, y0, chunk
        )
    if params.device.type != "cuda":
        raise ValueError(f"unsupported device {params.device}")
    dev = params.device
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, 4, PIX), dtype=torch.float32, device=dev)
    inv_w2, inv_h2 = _coord_constants(width, full_height)
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
            int(y0), chunk, TRANS_EPS, out.data_ptr(), stream,
        )
    build.check(status, "composite_tiles_raw")
    if num_tiles > 0:
        composite_tiles_raw.launches += 1
    return out


composite_tiles_raw.launches = 0


def composite_epilogue(out_raw: torch.Tensor, background, width: int, height: int) -> torch.Tensor:
    """Raw kernel rows [T, 4, 256] -> [H, W, 4] with a solid [4] background
    blended under the splats (tile_fwd.py:435-472)."""
    tx_count = width // TILE
    ty_count = height // TILE
    accum = out_raw[:, :3, :].transpose(1, 2)  # [T, 256, 3]
    trans = out_raw[:, 3, :]  # [T, 256]
    alpha_out = 1.0 - trans
    if background is not None:
        if background.dim() != 1:
            raise NotImplementedError(
                "full-image [H, W, 4] backgrounds arrive with slice 3 of the port"
            )
        accum = accum + trans[..., None] * background[:3]
        alpha_out = alpha_out + trans * background[3]
    tile_img = torch.cat([accum, alpha_out[..., None]], dim=-1)
    return (
        tile_img.reshape(ty_count, tx_count, TILE, TILE, 4)
        .permute(0, 2, 1, 3, 4)
        .reshape(height, width, 4)
    )
