"""PyTorch port: the per-block decisions of the pair expansion
(``csrc/expand.cu``) and the segmented reduce (``csrc/reduce.cu``), through
their plain twins ``expand.block_windows`` and ``reduce.rank_runs``, and the
premise of the expansion's fast path on the port's own binning.

The expansion kernel stages each block's owner window; the window holds at
most ``BLOCK_SLOTS`` ranks when no rank after the block's first owner has
zero pairs, except past the capped total.  The binning gives such counts:
inactive gaussians sort first and every active one covers at least one
tile.  The reduce kernel owns ranks in blocks whose slots are one contiguous
run, staged in windows of whole ranks where the run passes its buffer.  No JAX: the port's projection and binning alone, on the CPU."""

import pytest
import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import expand as ex
from bevy_gaussian_splatting_tpu_torch.ops.cuda import reduce as rd
from torch_port_cases import (
    CASES,
    EXPAND_COUNT_CASES,
    EYE,
    cloud_arrays,
    expand_counts,
    long_run_counts,
    reduce_counts,
    torch_cloud,
)

SETTINGS = {
    "obb": CloudSettings(),
    "aabb": CloudSettings(aabb=True),
    "2d": CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D),
}


def _arrays(kind, n, seed, offscreen=None):
    a = cloud_arrays(kind, n, seed)
    if offscreen is not None:
        a["position_visibility"][offscreen, 0] += 1e4
    return a


# the binning cases of tests/test_torch_binning.py: CASES at their budgets,
# the cap binding (512 and 1000 slots), every gaussian off screen, every
# third one off screen; (id, arrays builder, width, height, p_max or None)
SCENES = [(f"{k}{n}-{w}x{h}", (k, n, s, None), w, h, None) for k, n, s, w, h in CASES] + [
    ("cap512", ("wide", 400, 1, None), 128, 128, 512),
    ("cap1000", ("wide", 400, 1, None), 128, 128, 1000),
    ("all-inactive", ("wide", 400, 1, slice(None)), 128, 128, 1 << 12),
    ("mixed-offscreen", ("wide", 400, 1, slice(None, None, 3)), 128, 120, 1 << 13),
]
SCENE_IDS = [s[0] for s in SCENES]


def _table(scene, mode):
    """The expansion's inputs for ``scene`` in ``mode`` -> (table, p_max)."""
    _, spec, width, height, p_max = scene
    cloud = torch_cloud(_arrays(*spec))
    cam = Camera.create(eye=EYE, target=(0.0, 0.0, 0.0), width=width, height=height, device="cpu")
    settings = SETTINGS[mode]
    if p_max is None:
        p_max = rt.pairs_budget(len(cloud), int(rt.pair_count(cloud, cam, settings)))
    splats = rt.project_for_binning(cloud, cam, settings)
    return rt.expansion_inputs(splats, width, height, p_max)[0], p_max


def _owners(cum, p_max):
    """Each slot's owner #{r : cum[r] <= s}, int64 [p_max]."""
    return torch.searchsorted(cum.to(torch.int64), torch.arange(p_max, dtype=torch.int64), right=True)


@pytest.mark.parametrize("mode", list(SETTINGS))
@pytest.mark.parametrize("scene", SCENES, ids=SCENE_IDS)
def test_zero_count_ranks_lead_or_trail_the_cap(scene, mode):
    table, p_max = _table(scene, mode)
    cum = table[0].to(torch.int64)
    counts = torch.diff(cum, prepend=cum.new_zeros(1))
    assert bool((counts >= 0).all())
    active = counts > 0
    lead = torch.cumsum(active.to(torch.int64), 0) == 0  # before the first rank with a pair
    capped = torch.cat([torch.zeros(1, dtype=torch.bool), cum[:-1] >= p_max])  # after the cap is reached
    assert bool((active | lead | capped).all()), "a zero-count rank between two ranks with pairs"
    if scene[0].startswith("cap"):
        assert bool(capped.any()) and int(cum[-1]) == p_max
    if scene[0] == "all-inactive":
        assert not bool(active.any())


@pytest.mark.parametrize("mode", list(SETTINGS))
@pytest.mark.parametrize("scene", SCENES, ids=SCENE_IDS)
def test_block_windows_hold_their_slots_on_the_binning(scene, mode):
    table, p_max = _table(scene, mode)
    cum = table[0]
    w = ex.block_windows(cum, p_max)
    assert w.first.shape[0] == -(-p_max // ex.BLOCK_SLOTS)
    # the fast path's premise: no block searches device memory
    assert not bool((w.path == ex.PATH_SEARCH).any())
    holds = w.path != ex.PATH_FILL
    assert bool(((w.owner1 - w.owner0 + 1)[holds] <= ex.WINDOW).all())
    owner = _owners(cum, p_max)
    block = torch.arange(p_max) // ex.BLOCK_SLOTS
    live = torch.arange(p_max) < w.live[block]
    assert bool((owner[live] >= w.owner0[block][live]).all() and (owner[live] <= w.owner1[block][live]).all())
    # the slots past each block's pairs are the sentinel fill
    total = int(cum[-1]) if cum.numel() else 0
    assert torch.equal(live, torch.arange(p_max) < total)
    _, _, rank = ex.expand_pairs_plain(*table, p_max, 8, 64)
    assert torch.equal(rank[live].to(torch.int64), owner[live])


@pytest.mark.parametrize("case", EXPAND_COUNT_CASES)
@pytest.mark.parametrize("p_max", [777, 1500, 20480])
def test_block_windows_on_adversarial_counts(case, p_max):
    cum = expand_counts(case, p_max)
    w = ex.block_windows(cum, p_max)
    total = int(cum[-1]) if cum.numel() else 0
    holds = w.first < min(total, p_max)
    assert torch.equal(w.path == ex.PATH_FILL, ~holds)
    owner = _owners(cum, p_max)
    block = torch.arange(p_max) // ex.BLOCK_SLOTS
    live = torch.arange(p_max) < w.live[block]
    assert bool((owner[live] >= w.owner0[block][live]).all() and (owner[live] <= w.owner1[block][live]).all())
    window = w.path == ex.PATH_WINDOW
    assert torch.equal(window, holds & (w.owner1 - w.owner0 + 1 <= ex.WINDOW))
    if case.startswith("zero-runs") and p_max == 20480:
        assert bool((w.path == ex.PATH_SEARCH).any()), "no block left the fast path"
    if case in ("whole-frame", "n1"):
        assert bool(window[holds].all()) and bool((w.owner0[holds] == 0).all())


def _assert_runs_tile(runs, cum, n):
    """The blocks' rank ranges cover [0, n) once, and their slot runs tile
    [0, cum[n - 1]) once, each the slots of its own ranks."""
    assert int(runs.first[0]) == 0 and int(runs.end[-1]) == n
    assert torch.equal(runs.first[1:], runs.end[:-1])
    assert bool((runs.end - runs.first <= rd.BLOCK_RANKS).all())
    assert int(runs.slot0[0]) == 0 and int(runs.slot1[-1]) == int(cum[-1])
    assert torch.equal(runs.slot0[1:], runs.slot1[:-1])
    first, length = rd.segment_bounds(cum)
    assert torch.equal(runs.slot0, first[runs.first])
    assert torch.equal(runs.slot1, first[runs.end - 1] + length[runs.end - 1])


@pytest.mark.parametrize("cols", [10, 16])
@pytest.mark.parametrize("scene", SCENES[:4] + SCENES[5:6], ids=SCENE_IDS[:4] + SCENE_IDS[5:6])
def test_rank_runs_cover_their_slots_on_the_binning(scene, cols):
    mode = "2d" if cols == 16 else "obb"
    table, _ = _table(scene, mode)
    cum = table[0]
    runs = rd.rank_runs(cum, cum.shape[0], cols)
    _assert_runs_tile(runs, cum, cum.shape[0])
    # at most 2,000 ranks: a (rank, column) a thread, summed from device memory
    assert not bool(runs.staged.any())


@pytest.mark.parametrize("cols", [10, 16, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_runs_on_adversarial_counts(seed, cols):
    cum = reduce_counts(seed, cols, rd.STAGE_FLOATS)
    n = cum.shape[0]
    runs = rd.rank_runs(cum, n, cols)
    _assert_runs_tile(runs, cum, n)
    long_rank = int(torch.argmax(torch.diff(cum, prepend=cum.new_zeros(1))))
    long_block = (runs.first <= long_rank) & (long_rank < runs.end)
    # every block stages; the long rank, twice the buffer, alone from device
    # memory between two windows of the other ranks (or one at an end)
    assert bool(runs.staged.all())
    assert torch.equal(runs.alone, long_block.to(torch.int64))
    assert 1 <= int(runs.windows[long_block]) <= 2
    assert bool((runs.windows[~long_block] == 1).all())
    # odd first slots: 10-column runs that start 8-byte aligned
    assert bool((runs.slot0 % 2 == 1).any())
    # a block in one window: its run, from the aligned float at or below
    # its start, fits the buffer
    f0 = runs.slot0 * cols
    one = (runs.windows == 1) & (runs.alone == 0)
    assert bool(((runs.slot1 * cols - (f0 - f0 % 4))[one] <= rd.STAGE_FLOATS).all())


@pytest.mark.parametrize("cols", [10, 16])
def test_rank_runs_stage_long_runs_in_windows(cols):
    """Counts shaped like the 4DGS scene's (``long_run_counts``): most
    blocks' runs pass the staging buffer and stage in two to four windows
    of whole ranks, where they used to be summed from device memory."""
    cum = long_run_counts()
    n = cum.shape[0]
    runs = rd.rank_runs(cum, n, cols)
    _assert_runs_tile(runs, cum, n)
    assert bool(runs.staged.all()) and not bool(runs.alone.any())
    # windows of whole ranks: at least the run's floats over the buffer, and
    # one where the run fits
    f0 = runs.slot0 * cols
    span = runs.slot1 * cols - (f0 - f0 % 4)
    assert bool((runs.windows >= -(-span // rd.STAGE_FLOATS)).all())
    assert torch.equal(runs.windows == 1, span <= rd.STAGE_FLOATS)
    counts = torch.bincount(runs.windows).tolist()
    print(f"\n[{cols} columns] blocks by windows: {counts}")
    assert counts[0] == 0 and counts[2] > runs.windows.shape[0] // 4 and len(counts) <= 5


@pytest.mark.parametrize("n", [1, 192, 512, 20000, 33792, 1_000_000])
def test_rank_runs_spread_small_problems(n):
    # one slot a rank: the rank ranges alone decide the blocks
    cum = torch.arange(1, n + 1, dtype=torch.int32)
    runs = rd.rank_runs(cum, n, 10)
    _assert_runs_tile(runs, cum, n)
    blocks = runs.first.shape[0]
    ranks = int((runs.end - runs.first).max())
    # a (rank, column) for each thread at least, and one block an SM
    # (MIN_BLOCKS is two for each of the 132) until that leaves a block
    # more than BLOCK_RANKS
    assert min(n, rd.THREADS // 10) <= ranks <= rd.BLOCK_RANKS
    assert blocks >= min(-(-n // (rd.THREADS // 10)), rd.MIN_BLOCKS // 2)
    # the blocks that give a thread one sum read device memory; the others stage
    assert torch.equal(runs.staged, torch.full_like(runs.staged, ranks * 10 > rd.THREADS))
