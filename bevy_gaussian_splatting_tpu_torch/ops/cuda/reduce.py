"""Segmented gradient reduce: per-pair rows in slot order -> per depth rank.

Replaces the TPU kernel ``bevy_gaussian_splatting_tpu/ops/pallas/reduce.py``
``_reduce_kernel`` (``pallas_segment_reduce``) with ``csrc/reduce.cu``: a
block owns up to ``BLOCK_RANKS`` consecutive ranks, stages their contiguous run
of slot rows in shared memory (in windows of whole ranks where the run is
longer than its ``STAGE_FLOATS`` buffer, as the 4DGS scene's are), and each
(rank, column) sums its slots in slot order.  The row width is ``dslot``'s: 10 columns for OBB and AABB
gradients, 16 for 2DGS, 23 for 2DGS with the surface maps.  On the H100 it is bound by memory (each owned slot
row read once, each rank row written once); see the source for the design.

``segment_reduce`` launches the kernel for CUDA tensors and runs the plain
version, ``segment_reduce_plain``, for CPU tensors; both add in slot order,
so they agree bit for bit.  ``segment_reduce.launches`` counts kernel
launches.  :func:`rank_runs` is the plain twin of the kernel's per-block
decisions (rank range, slot run, staged or not), which the tests hold.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bevy_gaussian_splatting_tpu_torch.ops.cuda import build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2

# csrc/reduce.cu's constants: threads a block (kThreads), the most ranks a
# block owns (kRanks), the blocks below which it owns fewer (kMinBlocks) and
# the floats of its staging buffer (kStage)
THREADS = 256
BLOCK_RANKS = 128
MIN_BLOCKS = 264
STAGE_FLOATS = 6144


def segment_bounds(cum: torch.Tensor):
    """Each rank's slot range from the inclusive counts ``cum`` [N] ->
    (first slot, slot count), int64 [N]."""
    cum = cum.to(torch.int64)
    first = torch.cat([cum.new_zeros(1), cum[:-1]])
    return first, cum - first


class RankRuns(NamedTuple):
    """The reduce kernel's decisions, one entry per block (int64 but
    ``staged``)."""

    first: torch.Tensor  # the block's first rank
    end: torch.Tensor  # its ranks are [first, end)
    slot0: torch.Tensor  # their slots are the run [slot0, slot1) of dslot
    slot1: torch.Tensor
    staged: torch.Tensor  # bool: the run is summed from shared memory, else from device memory
    windows: torch.Tensor  # the staged run's windows of whole ranks (0 where not staged)
    alone: torch.Tensor  # ranks longer than the buffer, summed from device memory


def rank_runs(cum: torch.Tensor, n: int, cols: int) -> RankRuns:
    """Plain twin of the per-block decisions of ``csrc/reduce.cu`` for the
    inclusive counts ``cum`` [n] and rows of ``cols`` floats whose first
    float is 16-byte aligned (as a fresh tensor's is): each block's ranks
    (``BLOCK_RANKS``, fewer where that leaves under ``MIN_BLOCKS`` blocks,
    but at least a (rank, column) for each of its ``THREADS`` threads),
    their run of slots, whether it stages the run (where its ranks give a
    thread more than one (rank, column)), in how many windows, and how many
    of its ranks it sums from device memory instead.  A window holds the
    most whole ranks from its first whose run, from the aligned float at or
    below its start, fits the ``STAGE_FLOATS`` buffer (all of the block's
    where they fit, one window even for a run of no slots); a rank that
    alone passes the buffer is summed from device memory."""
    ranks = min(BLOCK_RANKS, max(-(-n // MIN_BLOCKS), THREADS // cols, 1))
    first = torch.arange(-(-n // ranks), dtype=torch.int64, device=cum.device) * ranks
    end = torch.clamp(first + ranks, max=n)
    bounds = torch.cat([cum.new_zeros(1), cum]).to(torch.int64)  # bounds[r] = cum[r - 1]
    slot0, slot1 = bounds[first], bounds[end]
    staged = torch.full_like(first, ranks * cols > THREADS, dtype=torch.bool)
    windows = torch.zeros_like(first)
    alone = torch.zeros_like(first)
    floats = bounds * cols  # floats[r]: the first float of rank r's slots
    i0, stop = first[staged], end[staged]
    w, a = torch.zeros_like(i0), torch.zeros_like(i0)
    while True:  # a window (or a rank alone) of every unfinished block a pass
        live = i0 < stop
        if not bool(live.any()):
            break
        wb = floats[i0] - floats[i0] % 4
        # the last rank end whose run from wb fits, at most the block's end
        i1 = torch.minimum(torch.searchsorted(floats, wb + STAGE_FLOATS, right=True) - 1, stop)
        single = live & (i1 == i0)
        w = w + (live & ~single).to(w.dtype)
        a = a + single.to(a.dtype)
        i0 = torch.where(single, i0 + 1, torch.where(live, i1, i0))
    windows[staged] = w
    alone[staged] = a
    return RankRuns(first, end, slot0, slot1, staged, windows, alone)


def _check_inputs(dslot, cum, n):
    if dslot.dtype != torch.float32:
        raise TypeError(f"dslot must be float32, got {dslot.dtype}")
    if dslot.dim() != 2 or dslot.shape[1] == 0:
        raise ValueError(f"dslot must be [P, cols] with cols > 0, got {tuple(dslot.shape)}")
    if cum.dtype != torch.int32:
        raise TypeError(f"cum must be int32, got {cum.dtype}")
    if cum.dim() != 1 or cum.shape[0] != n:
        raise ValueError(f"cum must be [{n}], got {tuple(cum.shape)}")
    if cum.device != dslot.device:
        raise ValueError(f"cum is on {cum.device}, dslot on {dslot.device}")
    if not (dslot.is_contiguous() and cum.is_contiguous()):
        raise ValueError("dslot and cum must be contiguous")


def segment_reduce_plain(dslot: torch.Tensor, cum: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version: step k adds every rank's k-th slot, so each
    rank's sum runs in slot order, as the kernel's does."""
    out = dslot.new_zeros((n, dslot.shape[1]))
    if n == 0:
        return out
    first, length = segment_bounds(cum)
    for k in range(int(length.max())):
        live = torch.nonzero(length > k).squeeze(1)
        out[live] += dslot[first[live] + k]
    return out


def segment_reduce(dslot: torch.Tensor, cum: torch.Tensor, n: int) -> torch.Tensor:
    """Per-rank gradient sums [n, cols] of slot-ordered rows ``dslot``
    [P, cols] (``cols`` 10 for OBB and AABB, 16 for 2DGS, 23 for 2DGS with
    the surface maps).

    ``cum`` [n] int32 holds the inclusive pair counts in depth order,
    clamped at P: rank r owns slots [cum[r-1], cum[r]).  Ranks with no slots
    get exact zeros."""
    _check_inputs(dslot, cum, n)
    if dslot.device.type == "cpu":
        return segment_reduce_plain(dslot, cum, n)
    if dslot.device.type != "cuda":
        raise ValueError(f"unsupported device {dslot.device}")
    dev = dslot.device
    cols = dslot.shape[1]
    drank = torch.empty((n, cols), dtype=torch.float32, device=dev)
    lib = build.load("reduce")
    fn = lib.bgs_segment_reduce
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(dslot.data_ptr(), cum.data_ptr(), n, cols, drank.data_ptr(), stream)
    build.check(status, "segment_reduce")
    if n > 0:
        segment_reduce.launches += 1
    return drank


segment_reduce.launches = 0
