"""Pair expansion: slot -> (tile id, cloud index, depth rank).

Replaces the TPU kernel ``bevy_gaussian_splatting_tpu/ops/pallas/expand.py``
``_expand_kernel`` (``pallas_expand_pairs``) with ``csrc/expand.cu``: one
thread per slot binary-searches the depth-ordered inclusive pair counts.  On
the H100 it is bound by memory (12 bytes written per slot plus the table
reads); see the source for the design.

``expand_pairs`` launches the kernel for CUDA tensors and runs the plain
version, ``expand_pairs_plain``, for CPU tensors.  ``expand_pairs.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from bevy_gaussian_splatting_tpu_torch.ops.cuda import build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4


def _lib():
    lib = build.load("expand")
    fn = lib.bgs_expand_pairs
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(cum, rect_w, tx0, ty0, perm, p_max):
    n = cum.shape[0]
    for name, t in (("cum", cum), ("rect_w", rect_w), ("tx0", tx0), ("ty0", ty0), ("perm", perm)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must have shape [{n}], got {tuple(t.shape)}")
        if t.device != cum.device:
            raise ValueError(f"{name} is on {t.device}, cum on {cum.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p_max < 0:
        raise ValueError("p_max must be >= 0")


def expand_pairs_plain(cum, rect_w, tx0, ty0, perm, p_max: int, tx_count: int, sentinel: int):
    """Plain PyTorch version: ``searchsorted`` plus integer arithmetic."""
    n = cum.shape[0]
    dev = cum.device
    slots = torch.arange(p_max, dtype=torch.int32, device=dev)
    if n == 0:
        return (
            torch.full((p_max,), sentinel, dtype=torch.int32, device=dev),
            torch.zeros((p_max,), dtype=torch.int32, device=dev),
            torch.zeros((p_max,), dtype=torch.int32, device=dev),
        )
    total = cum[-1]
    owner = torch.searchsorted(cum, slots, right=True)  # = n past the total
    valid = slots < total
    own = owner.clamp(max=n - 1)
    prev = cum[(own - 1).clamp(min=0)]
    k = slots - torch.where(own > 0, prev, torch.zeros_like(prev))
    w = rect_w[own].clamp(min=1)
    tile = (ty0[own] + torch.div(k, w, rounding_mode="floor")) * tx_count + tx0[own] + k % w
    tile = torch.where(valid, tile, torch.full_like(tile, sentinel))
    g_cloud = torch.where(valid, perm[own], torch.zeros_like(perm[own]))
    return tile.to(torch.int32), g_cloud.to(torch.int32), owner.to(torch.int32)


def expand_pairs(cum, rect_w, tx0, ty0, perm, p_max: int, tx_count: int, sentinel: int):
    """Expand depth-ordered gaussians into ``p_max`` pair slots.

    ``cum`` [N] int32: inclusive pair counts in depth order (values above
    ``p_max`` may be clamped); ``rect_w``, ``tx0``, ``ty0`` [N] int32: each
    gaussian's tile rectangle; ``perm`` [N] int32: its cloud index.  Returns
    ``(tile, g_cloud, rank)``, int32 [p_max]; slots past the total get
    ``sentinel``, 0 and N."""
    _check_inputs(cum, rect_w, tx0, ty0, perm, p_max)
    if cum.device.type == "cpu":
        return expand_pairs_plain(cum, rect_w, tx0, ty0, perm, p_max, tx_count, sentinel)
    if cum.device.type != "cuda":
        raise ValueError(f"unsupported device {cum.device}")
    n = cum.shape[0]
    dev = cum.device
    tile = torch.empty((p_max,), dtype=torch.int32, device=dev)
    g_cloud = torch.empty_like(tile)
    rank = torch.empty_like(tile)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.bgs_expand_pairs(
            cum.data_ptr(), rect_w.data_ptr(), tx0.data_ptr(), ty0.data_ptr(),
            perm.data_ptr(), n, p_max, tx_count, sentinel,
            tile.data_ptr(), g_cloud.data_ptr(), rank.data_ptr(), stream,
        )
    build.check(status, "expand_pairs")
    if p_max > 0:
        expand_pairs.launches += 1
    return tile, g_cloud, rank


expand_pairs.launches = 0
