"""Pair expansion: slot -> (tile id, cloud index, depth rank).

Replaces the TPU kernel ``bevy_gaussian_splatting_tpu/ops/pallas/expand.py``
``_expand_kernel`` (``pallas_expand_pairs``) with ``csrc/expand.cu``: a block
owns ``BLOCK_SLOTS`` consecutive slots, finds the owners of its first and
last pair once, stages that owner window of the depth-ordered table in
shared memory and walks its slots through it.  On the H100 it is bound by
memory (12 bytes written per slot plus the table reads); see the source for
the design.

``expand_pairs`` launches the kernel for CUDA tensors and runs the plain
version, ``expand_pairs_plain``, for CPU tensors.  ``expand_pairs.launches``
counts kernel launches.  :func:`block_windows` is the plain twin of the
kernel's per-block decisions (window and path), which the tests hold.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bevy_gaussian_splatting_tpu_torch.ops.cuda import build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4

# csrc/expand.cu's constants: slots a block owns (kSlots, four a thread) and
# ranks it can stage (kWindow)
BLOCK_SLOTS = 1024
WINDOW = 1024
# a block's path: no pair (sentinel fill only), its owners staged, or each
# slot searched in device memory (a window longer than WINDOW ranks)
PATH_FILL, PATH_WINDOW, PATH_SEARCH = 0, 1, 2


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


class BlockWindows(NamedTuple):
    """The expansion kernel's decisions, one entry per block (int64)."""

    first: torch.Tensor  # the block's first slot
    live: torch.Tensor  # its pair-holding slots are [first, live)
    owner0: torch.Tensor  # the owner of slot first (where live > first)
    owner1: torch.Tensor  # the owner of slot live - 1 (where live > first)
    path: torch.Tensor  # PATH_FILL, PATH_WINDOW or PATH_SEARCH


def block_windows(cum: torch.Tensor, p_max: int) -> BlockWindows:
    """Plain twin of the per-block decisions of ``csrc/expand.cu`` for the
    inclusive counts ``cum`` [N] and ``p_max`` slots: each block's slots,
    the owners of its first and last pair (owner = #{r : cum[r] <= s}; a
    table of at most ``WINDOW`` ranks is its own window, [0, N - 1]) and
    the path it takes.  The kernel stages ranks [owner0, owner1] when there
    are at most ``WINDOW``, which holds whenever every rank after the
    block's first owner owns a slot or lies past the total."""
    cum = cum.to(torch.int64)
    first = torch.arange(-(-p_max // BLOCK_SLOTS), dtype=torch.int64, device=cum.device) * BLOCK_SLOTS
    total = cum[-1] if cum.numel() else cum.new_zeros(())
    live = torch.minimum(torch.clamp(first + BLOCK_SLOTS, max=p_max), total)
    holds = first < live
    owner0 = torch.where(holds, torch.searchsorted(cum, first, right=True), 0)
    owner1 = torch.where(holds, torch.searchsorted(cum, live - 1, right=True), 0)
    if cum.numel() <= WINDOW:
        owner0, owner1 = torch.zeros_like(owner0), torch.where(holds, cum.numel() - 1, 0)
    path = torch.where(owner1 - owner0 + 1 <= WINDOW, PATH_WINDOW, PATH_SEARCH)
    return BlockWindows(first, live, owner0, owner1, torch.where(holds, path, PATH_FILL))


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
