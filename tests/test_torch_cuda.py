"""PyTorch port on the card: each CUDA kernel against its plain version (the
compositors in OBB, AABB and 2DGS mode, the forward's bounding-box overlay
instantiation in each, the reduce at 10 and 16 columns, also on runs
longer than its staging buffer; each compositor's
second launch bitwise equal to its first, and both on the adversarial rows
of their per-warp cull), ``render()`` on the card against the same call on the CPU (also with the
overlay, in the other rasterize and draw modes, for 4DGS and for f16 and
bf16 storage), the training
gradients of every cloud field, card against CPU, and the fused serving
projection against the eager chain on the card, bit for bit, the
training colour stage's kernels (``csrc/sh.cu``) against the eager chain
and its autograd, and the 3DGS training projection (``ProjectCore``): its
forward bit for bit the eager chain's and the serving kernel's, its
backward against its twin, three training steps at 1M against the eager
chain, and ptxas's report of the projection's kernels.

These skip without an NVIDIA card.  On one, run them without the JAX-side
conftest: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
They import neither JAX nor the JAX package."""

import statistics

import numpy as np
import pytest
import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    cloud_from_numpy,
    random_arrays_3d_seeded,
    random_arrays_4d_seeded,
    surfel_grid_arrays,
)
from bevy_gaussian_splatting_tpu_torch.models.settings import (
    CloudSettings,
    DrawMode,
    GaussianColorSpace,
    GaussianMode,
    RadixSortDepthBits,
    RasterizeMode,
)
from bevy_gaussian_splatting_tpu_torch.ops import covariance as cov_ops
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import build
from bevy_gaussian_splatting_tpu_torch.ops.cuda import cull
from bevy_gaussian_splatting_tpu_torch.ops.cuda import expand as ex
from bevy_gaussian_splatting_tpu_torch.ops.cuda import project as pj
from bevy_gaussian_splatting_tpu_torch.ops.cuda import reduce as rd
from bevy_gaussian_splatting_tpu_torch.ops.cuda import sh as sh_fn
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_bwd as tb
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf
from bevy_gaussian_splatting_tpu_torch.render.api import render
from bevy_gaussian_splatting_tpu_torch.train.losses import gaussian_splatting_loss, mse
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, shifted_arrays, train_step
from bevy_gaussian_splatting_tpu_torch.utils import trace
from torch_port_cases import (
    EXPAND_COUNT_CASES,
    EYE,
    MODE,
    SH_GRAD_REL,
    SH_KINDS,
    adversarial_rows,
    edge_cloud_arrays,
    expand_counts,
    expand_table,
    long_run_counts,
    reduce_counts,
    rel_gap,
    sh_stage_grads,
    sh_stage_inputs,
    sh_stage_tensors,
    special_rows,
)

FIELDS = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")
GRAD_BAR = 1e-4  # chip_smoke.py's bar: per column or field, of its largest |plain|
SURFELS = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)
SURFEL_BAR = 1e-4  # chip_smoke.py's 2DGS image bar (the JAX package's)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _scene(kind, n, seed):
    a = random_arrays_3d_seeded(n, seed=seed)
    if kind == "wide":  # the raw draw: large splats spanning many tiles
        return a
    if kind.startswith("bench"):
        a["position_visibility"] *= np.array([1, 1, 0.25, 1], np.float32)
        a["scale_opacity"] *= np.array([0.05, 0.05, 0.05, 1], np.float32)
    else:  # heavy occlusion: whole tiles saturate, the early exit binds
        a["position_visibility"] *= np.array([0.05, 0.05, 0.2, 1], np.float32)
        a["scale_opacity"] = a["scale_opacity"] * np.array([3, 3, 3, 1], np.float32) + np.array(
            [0, 0, 0, 0.6], np.float32
        )
    return a


def _inputs(arrays, width, height, device, settings=CloudSettings(), eye=(0.0, 0.0, 60.0)):
    cloud = cloud_from_numpy(arrays, device)
    cam = Camera.create(eye=eye, width=width, height=height, device=device)
    p_max = rt.pairs_budget(len(cloud), int(rt.pair_count(cloud, cam, settings)))
    return rt.project_for_binning(cloud, cam, settings), p_max


@pytest.mark.parametrize("kind,n,height", [("bench", 20000, 256), ("occluded", 1000, 120), ("wide", 400, 256)])
def test_expand_kernel_equals_plain(card, kind, n, height):
    splats, p_max = _inputs(_scene(kind, n, 3), 256, height, card)
    table, _ = rt.expansion_inputs(splats, 256, height, p_max)
    for budget in (p_max, 777, 1500):  # the last two cap the pairs; neither is a multiple of a block
        args = (*table, budget, 16, 16 * (rt.pad_to_tile(height) // 16))
        before = ex.expand_pairs.launches
        got = ex.expand_pairs(*args)
        assert ex.expand_pairs.launches == before + 1
        for g, r in zip(got, ex.expand_pairs_plain(*args)):
            assert torch.equal(g, r)


@pytest.mark.parametrize("case", EXPAND_COUNT_CASES)
@pytest.mark.parametrize("p_max", [777, 1500, 20480])
def test_expand_kernel_on_adversarial_counts(card, case, p_max):
    """Counts the binning never gives: interior zero runs longer than a
    block's window (those blocks search device memory), a splat over the
    whole 1080p frame, one gaussian, none, all inactive."""
    table = tuple(t.to(card) for t in expand_table(expand_counts(case, p_max)))
    tx_count, sentinel = 120, 120 * 68
    before = ex.expand_pairs.launches
    got = ex.expand_pairs(*table, p_max, tx_count, sentinel)
    assert ex.expand_pairs.launches == before + 1
    for g, r in zip(got, ex.expand_pairs_plain(*table, p_max, tx_count, sentinel)):
        assert torch.equal(g, r)
    if case.startswith("zero-runs") and p_max == 20480:
        assert bool((ex.block_windows(table[0], p_max).path == ex.PATH_SEARCH).any())


@pytest.mark.parametrize("cols", [10, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_reduce_kernel_on_adversarial_counts(card, seed, cols):
    """Runs that start at odd slots (10-column runs 8-byte aligned), empty
    ranks, a rank whose run is twice the staging buffer (its block sums it
    from device memory between windows of the other ranks), also from a
    row view that starts one row into its storage."""
    cum = reduce_counts(seed, cols, rd.STAGE_FLOATS).to(card)
    n = cum.shape[0]
    assert int(rd.rank_runs(cum, n, cols).alone.sum()) == 1
    rows = torch.randn((int(cum[-1]) + 38, cols), generator=torch.Generator().manual_seed(seed)).to(card)
    for dslot in (rows[:-1], rows[1:]):
        before = rd.segment_reduce.launches
        got = rd.segment_reduce(dslot, cum, n)
        assert rd.segment_reduce.launches == before + 1
        assert torch.equal(got.view(torch.int32), rd.segment_reduce_plain(dslot, cum, n).view(torch.int32))


@pytest.mark.parametrize("cols", [10, 16])
def test_reduce_kernel_stages_long_runs_in_windows(card, cols):
    """The 4DGS scene's shape at 1920x1080 (``long_run_counts``: 1M ranks,
    about 6 slots each), where most blocks' runs pass the staging buffer:
    bit-equal to the plain version, from an aligned and an unaligned row
    view."""
    cum = long_run_counts().to(card)
    n = cum.shape[0]
    assert int((rd.rank_runs(cum, n, cols).windows >= 2).sum()) > 1000
    rows = torch.randn((int(cum[-1]) + 1, cols), generator=torch.Generator().manual_seed(cols)).to(card)
    for dslot in (rows[:-1], rows[1:]):
        got = rd.segment_reduce(dslot, cum, n)
        assert torch.equal(got.view(torch.int32), rd.segment_reduce_plain(dslot, cum, n).view(torch.int32))


@pytest.mark.parametrize("kind,n,height,chunk", [
    ("bench", 20000, 256, None), ("occluded", 1000, 120, None), ("occluded", 1000, 120, 128),
])
def test_composite_kernel_matches_plain(card, kind, n, height, chunk):
    splats, p_max = _inputs(_scene(kind, n, 4), 256, height, card)
    bins = rt.tile_bins(splats, 256, height, p_max)
    params = splats["params"][bins.g_s].contiguous()
    start, count = bins.start, bins.count
    if chunk is None:
        chunk = tf.preferred_chunk(p_max, start.shape[0])
    args = (params, start, count, 16, 256, height)
    before = tf.composite_tiles_raw.launches
    got = tf.composite_tiles_raw(*args, chunk=chunk)
    assert tf.composite_tiles_raw.launches == before + 1
    ref = tf.composite_tiles_raw_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 2e-5
    _forward_again(got, *args, chunk=chunk)


@pytest.mark.parametrize("height", [128, 120])
def test_render_card_matches_cpu(card, height):
    a = _scene("bench", 5000, 7)
    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=128, height=height, device="cpu")
    cpu = render(cloud_from_numpy(a, "cpu"), cam, background=bg, device="cpu")
    gpu = render(cloud_from_numpy(a, card), cam.to(card), background=bg.to(card))
    assert gpu.device.type == "cuda"
    assert float((gpu.cpu() - cpu).abs().max()) <= 2e-5


# the backward's cases: the bench scene, heavy occlusion with short chunks,
# large splats spanning the tile, the bench scene with short chunks; for OBB
# also rows with b1 <= 0 (every fifth negated, every seventh 0)
BWD_CASES = [("bench", 20000, 256, None), ("occluded", 1000, 120, 128), ("wide", 400, 256, None),
             ("bench", 20000, 256, 128)]


def _bitwise_again(got, *args, **kwargs):
    """A second launch on the same inputs gives the same bits."""
    again = tb.composite_backward(*args, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def _forward_again(got, *args, **kwargs):
    """A second forward launch on the same inputs gives the same bits."""
    again = tf.composite_tiles_raw(*args, **kwargs)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _matches_twin(got, plain, params, start, count, gbar, tx_count, width, full_height, y0=0, mode=tb.MODE_OBB):
    """The kernel against the twin of its cull (``warp_masks``): a row whose
    mask holds no warp gets no gradient from the kernel, and every row with a
    plain gradient is held by some warp's mask -> the rows culled whole."""
    culled = cull.warp_masks(params, start, count, tx_count, width, full_height, y0, mode) == 0
    assert not bool(got[culled].any())
    assert not bool(((plain != 0).any(dim=1) & culled).any())
    return int(culled.sum())


@pytest.mark.parametrize("kind,n,height,chunk", BWD_CASES + [("bench-b1", 20000, 256, None)])
def test_backward_and_reduce_kernels_match_plain(card, kind, n, height, chunk):
    splats, p_max = _inputs(_scene(kind, n, 5), 256, height, card)
    bins = rt.tile_bins(splats, 256, height, p_max)
    params = splats["params"][bins.g_s].contiguous()
    if kind == "bench-b1":
        params[::5, 4] = -params[::5, 4]
        params[1::7, 4] = 0.0
    if chunk is None:
        chunk = tf.preferred_chunk(p_max, bins.start.shape[0])
    raw = tf.composite_tiles_raw(params, bins.start, bins.count, 16, 256, height, chunk=chunk)
    cotangent = torch.randn(raw.shape, generator=torch.Generator().manual_seed(0)) * 1e-3
    gbar = tb.pack_gbar(cotangent.to(card), raw)
    args = (params, bins.start, bins.count, gbar, 16, 256, height)
    before = tb.composite_backward.launches
    got = tb.composite_backward(*args, chunk=chunk)
    assert tb.composite_backward.launches == before + 1
    ref = tb.composite_backward_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    col_max = ref.abs().amax(dim=0)
    assert bool(((got - ref).abs().amax(dim=0) <= GRAD_BAR * col_max).all())
    _matches_twin(got, ref, *args)
    _bitwise_again(got, *args, chunk=chunk)

    dslot = torch.empty_like(got)
    dslot[bins.order] = got
    n_ranks = bins.cum.shape[0]
    before = rd.segment_reduce.launches
    drank = rd.segment_reduce(dslot, bins.cum, n_ranks)
    assert rd.segment_reduce.launches == before + 1
    assert torch.equal(drank, rd.segment_reduce_plain(dslot, bins.cum, n_ranks))


@pytest.mark.parametrize("mode", ["obb", "aabb", "2d"])
def test_backward_kernel_on_adversarial_rows(card, mode):
    # tests/test_torch_cull.py's rows on one tile: splats straddling warp
    # strips with extents at a pixel's offset +- 2 ulps, b1 <= 0, r = 0, a
    # zero axis, whole-tile splats; kernel within GRAD_BAR of the plain
    # version per column, zero on every row the twin of its cull leaves to
    # no warp (some are), bitwise equal twice
    width, height, y0 = 32, 48, 8
    rows = adversarial_rows(mode, width, height, y0, 480, seed=5)  # one chunk: no early exit
    params = torch.cat([rows, torch.stack([r for r, _ in special_rows(mode, width, height, y0)])]).to(card)
    n = params.shape[0]
    start = torch.tensor([0, n, n, n, n, n], dtype=torch.int32, device=card)
    count = torch.tensor([n, 0, 0, 0, 0, 0], dtype=torch.int32, device=card)
    gbar = (torch.rand((6, tb.GBAR_ROWS, tb.PIX), generator=torch.Generator().manual_seed(3)) - 0.5).to(card)
    args = (params, start, count, gbar, width // 16, width, height, y0)
    got = tb.composite_backward(*args, chunk=512, mode=MODE[mode])
    plain = tb.composite_backward_plain(*args, chunk=512, mode=MODE[mode])
    torch.cuda.synchronize()
    col_max = plain.abs().amax(dim=0)
    assert bool(((got - plain).abs().amax(dim=0) <= GRAD_BAR * col_max).all())
    assert int((got != 0).any(dim=1).sum()) > n // 4  # the rows reach the tile
    assert _matches_twin(got, plain, *args, mode=MODE[mode]) > 0
    _bitwise_again(got, *args, chunk=512, mode=MODE[mode])


def _grads(arrays, camera, background, device, settings=CloudSettings()):
    with torch.no_grad():
        target = rt.render_tiled(cloud_from_numpy(shifted_arrays(arrays), device), camera.to(device),
                                 settings, background=background.to(device))
    model = TrainableCloud.from_numpy(arrays, device)
    img = rt.render_tiled(model.cloud(), camera.to(device), settings, background=background.to(device))
    mse(img, target).backward()
    return {f: getattr(model, f).grad.cpu() for f in FIELDS}


@pytest.mark.parametrize("height", [128, 120])
def test_training_gradients_card_match_cpu(card, height):
    a = _scene("bench", 2000, 3)
    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=128, height=height, device="cpu")
    before = (tb.composite_backward.launches, rd.segment_reduce.launches)
    gpu = _grads(a, cam, bg, card)
    assert tb.composite_backward.launches == before[0] + 1
    assert rd.segment_reduce.launches == before[1] + 1
    cpu = _grads(a, cam, bg, "cpu")
    for f in FIELDS:
        assert bool(torch.isfinite(gpu[f]).all()), f
        assert float((gpu[f] - cpu[f]).abs().max()) <= GRAD_BAR * float(cpu[f].abs().max()), f


@pytest.mark.parametrize("kind,n,height,chunk", BWD_CASES)
def test_aabb_compositor_kernels_match_plain(card, kind, n, height, chunk):
    # chip_smoke.py's bars: forward within 2e-5, backward within 1e-4 of each
    # column's largest |plain|, the radius column (5) exactly 0 in both
    settings = CloudSettings(aabb=True)
    splats, p_max = _inputs(_scene(kind, n, 8), 256, height, card, settings)
    bins = rt.tile_bins(splats, 256, height, p_max)
    params = splats["params"][bins.g_s].contiguous()
    if chunk is None:
        chunk = tf.preferred_chunk(p_max, bins.start.shape[0])
    args = (params, bins.start, bins.count, 16, 256, height)
    before = (tf.composite_tiles_raw.launches, tb.composite_backward.launches)
    raw = tf.composite_tiles_raw(*args, chunk=chunk, mode=tf.MODE_AABB)
    ref = tf.composite_tiles_raw_plain(*args, chunk=chunk, mode=tf.MODE_AABB)
    torch.cuda.synchronize()
    assert float((raw - ref).abs().max()) <= 2e-5
    _forward_again(raw, *args, chunk=chunk, mode=tf.MODE_AABB)
    cotangent = torch.randn(raw.shape, generator=torch.Generator().manual_seed(1)) * 1e-3
    gbar = tb.pack_gbar(cotangent.to(card), raw)
    bwd_args = (params, bins.start, bins.count, gbar, 16, 256, height)
    got = tb.composite_backward(*bwd_args, chunk=chunk, mode=tb.MODE_AABB)
    plain = tb.composite_backward_plain(*bwd_args, chunk=chunk, mode=tb.MODE_AABB)
    torch.cuda.synchronize()
    assert (tf.composite_tiles_raw.launches, tb.composite_backward.launches) == (before[0] + 2, before[1] + 1)
    assert not bool(got[:, 5].any()) and not bool(plain[:, 5].any())
    col_max = plain.abs().amax(dim=0)
    assert bool(((got - plain).abs().amax(dim=0) <= GRAD_BAR * col_max).all())
    _matches_twin(got, plain, *bwd_args, mode=tb.MODE_AABB)
    _bitwise_again(got, *bwd_args, chunk=chunk, mode=tb.MODE_AABB)


@pytest.mark.parametrize("height", [128, 120])
def test_aabb_render_and_gradients_card_match_cpu(card, height):
    settings = CloudSettings(aabb=True)
    a = _scene("bench", 2000, 3)
    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=128, height=height, device="cpu")
    cpu = render(cloud_from_numpy(a, "cpu"), cam, settings, background=bg, device="cpu")
    gpu = render(cloud_from_numpy(a, card), cam.to(card), settings, background=bg.to(card))
    assert float((gpu.cpu() - cpu).abs().max()) <= 2e-5
    g_gpu = _grads(a, cam, bg, card, settings)
    g_cpu = _grads(a, cam, bg, "cpu", settings)
    for f in FIELDS:
        assert bool(torch.isfinite(g_gpu[f]).all()), f
        assert float((g_gpu[f] - g_cpu[f]).abs().max()) <= GRAD_BAR * float(g_cpu[f].abs().max()), f


@pytest.mark.parametrize("time", [0.25, 0.75])
def test_4d_aabb_render_card_matches_cpu(card, time):
    """4DGS serves through the OBB / AABB kernels; AABB has no footprint
    axis, so its card and CPU images agree to the fixed bar (the OBB axis of
    a 4D splat is ill-conditioned, ROADMAP Queue 3: chip_smoke.py holds it
    to the CPU's own spread)."""
    settings = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D, aabb=True, time=time)
    a = random_arrays_4d_seeded(500, seed=3)
    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=128, height=120, device="cpu")
    cpu = render(cloud_from_numpy(a, "cpu"), cam, settings, background=bg, device="cpu")
    before = tf.composite_tiles_raw.instances.get(("aabb", False), 0)
    gpu = render(cloud_from_numpy(a, card), cam.to(card), settings, background=bg.to(card))
    assert tf.composite_tiles_raw.instances.get(("aabb", False), 0) == before + 1
    oracle = render(cloud_from_numpy(a, card), cam.to(card), settings, background=bg.to(card), impl="oracle")
    assert float((gpu.cpu() - cpu).abs().max()) <= 2e-5
    assert float((gpu - oracle).abs().max()) <= 3e-5


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16], ids=["f16", "bf16"])
def test_half_storage_render_on_the_card(card, dtype):
    """f16 and bf16 storage reach the kernels as the rounded cloud's float32
    values: the image is bit for bit the float32 render of the rounded
    cloud."""
    cloud = cloud_from_numpy(_scene("bench", 2000, 3), card)
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=128, height=120, device=card)
    half = cloud.astype(dtype)
    assert torch.equal(render(half, cam), render(half.astype(torch.float32), cam))


@pytest.mark.parametrize("kind,n,height,chunk", BWD_CASES + [("surfels", 16, 120, None)])
def test_2dgs_kernels_match_plain(card, kind, n, height, chunk):
    # chip_smoke.py's bars: forward within 1e-4, backward within 1e-4 of each
    # column's largest |plain| with the surfel radius column (2) exactly 0 in
    # both, the reduce at 16 columns equal
    if kind == "surfels":
        splats, p_max = _inputs(surfel_grid_arrays(), 256, height, card, SURFELS, eye=(2.5, 2.0, 6.0))
    else:
        splats, p_max = _inputs(_scene(kind, n, 9), 256, height, card, SURFELS)
    bins = rt.tile_bins(splats, 256, height, p_max)
    params = splats["params"][bins.g_s].contiguous()
    assert params.shape[1] == 16
    if chunk is None:
        chunk = tf.preferred_chunk(p_max, bins.start.shape[0])
    args = (params, bins.start, bins.count, 16, 256, height)
    before = (tf.composite_tiles_raw.launches, tb.composite_backward.launches, rd.segment_reduce.launches)
    raw = tf.composite_tiles_raw(*args, chunk=chunk, mode=tf.MODE_2D)
    ref = tf.composite_tiles_raw_plain(*args, chunk=chunk, mode=tf.MODE_2D)
    torch.cuda.synchronize()
    assert float((raw - ref).abs().max()) <= SURFEL_BAR
    assert float((ref[:, 3] < 0.99).sum()) > 100  # the surfels cover part of the frame
    _forward_again(raw, *args, chunk=chunk, mode=tf.MODE_2D)
    cotangent = torch.randn(raw.shape, generator=torch.Generator().manual_seed(2)) * 1e-3
    gbar = tb.pack_gbar(cotangent.to(card), raw)
    bwd_args = (params, bins.start, bins.count, gbar, 16, 256, height)
    got = tb.composite_backward(*bwd_args, chunk=chunk, mode=tf.MODE_2D)
    plain = tb.composite_backward_plain(*bwd_args, chunk=chunk, mode=tf.MODE_2D)
    torch.cuda.synchronize()
    assert not bool(got[:, 2].any()) and not bool(plain[:, 2].any())
    col_max = plain.abs().amax(dim=0)
    assert bool(((got - plain).abs().amax(dim=0) <= GRAD_BAR * col_max).all())
    _matches_twin(got, plain, *bwd_args, mode=tf.MODE_2D)
    dslot = torch.empty_like(got)
    dslot[bins.order] = got
    n_ranks = bins.cum.shape[0]
    drank = rd.segment_reduce(dslot, bins.cum, n_ranks)
    assert torch.equal(drank, rd.segment_reduce_plain(dslot, bins.cum, n_ranks))
    after = (tf.composite_tiles_raw.launches, tb.composite_backward.launches, rd.segment_reduce.launches)
    assert after == (before[0] + 2, before[1] + 1, before[2] + 1)
    _bitwise_again(got, *bwd_args, chunk=chunk, mode=tf.MODE_2D)


@pytest.mark.parametrize("height", [128, 120])
def test_2dgs_render_and_gradients_card_match_cpu(card, height):
    a = _scene("bench", 2000, 3)
    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=128, height=height, device="cpu")
    cpu = render(cloud_from_numpy(a, "cpu"), cam, SURFELS, background=bg, device="cpu")
    gpu = render(cloud_from_numpy(a, card), cam.to(card), SURFELS, background=bg.to(card))
    assert float((gpu.cpu() - cpu).abs().max()) <= SURFEL_BAR
    g_gpu = _grads(a, cam, bg, card, SURFELS)
    g_cpu = _grads(a, cam, bg, "cpu", SURFELS)
    for f in FIELDS:
        assert bool(torch.isfinite(g_gpu[f]).all()), f
        assert float((g_gpu[f] - g_cpu[f]).abs().max()) <= GRAD_BAR * float(g_cpu[f].abs().max()), f
    assert not bool(g_gpu["scale_opacity"][:, 2].any())  # the flat surfel's scale z


OVERLAY = {"obb": CloudSettings(visualize_bounding_box=True),
           "aabb": CloudSettings(aabb=True, visualize_bounding_box=True),
           "2d": CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D, visualize_bounding_box=True)}


@pytest.mark.parametrize("mode", list(OVERLAY))
@pytest.mark.parametrize("kind,n,height,chunk", [("bench", 20000, 256, None), ("occluded", 1000, 120, 128)])
def test_overlay_kernel_matches_plain(card, mode, kind, n, height, chunk):
    # chip_smoke.py's bars: within 2e-5 (2DGS 1e-4) of the plain overlay,
    # counted under its own instantiation, with edges that close pixels
    settings = OVERLAY[mode]
    splats, p_max = _inputs(_scene(kind, n, 10), 256, height, card, settings)
    bins = rt.tile_bins(splats, 256, height, p_max)
    params = splats["params"][bins.g_s].contiguous()
    if chunk is None:
        chunk = tf.preferred_chunk(p_max, bins.start.shape[0])
    kmode = rt.kernel_mode(settings)
    args = (params, bins.start, bins.count, 16, 256, height)
    before = (tf.composite_tiles_raw.instances.get((mode, True), 0), tf.composite_tiles_raw.instances.get((mode, False), 0))
    got = tf.composite_tiles_raw(*args, chunk=chunk, mode=kmode, bbox=True)
    after = (tf.composite_tiles_raw.instances.get((mode, True), 0), tf.composite_tiles_raw.instances.get((mode, False), 0))
    assert after == (before[0] + 1, before[1])
    ref = tf.composite_tiles_raw_plain(*args, chunk=chunk, mode=kmode, bbox=True)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= (SURFEL_BAR if mode == "2d" else 2e-5)
    assert int((got[:, 3] == 0.0).sum()) > 0
    _forward_again(got, *args, chunk=chunk, mode=kmode, bbox=True)


@pytest.mark.parametrize("bbox", [False, True], ids=["plain", "bbox"])
@pytest.mark.parametrize("mode", ["obb", "aabb", "2d"])
def test_forward_kernel_on_adversarial_rows(card, mode, bbox):
    # tests/test_torch_cull.py's rows on one tile, which the culled forward
    # skips per warp: splats straddling warp strips with extents at a
    # pixel's offset +- 2 ulps, b1 <= 0, r = 0, a zero axis, whole-tile
    # splats; kernel within the bar of the plain version (with and without
    # the overlay), bitwise equal twice
    width, height, y0 = 32, 48, 8
    rows = adversarial_rows(mode, width, height, y0, 480, seed=5)  # one chunk: no early exit
    params = torch.cat([rows, torch.stack([r for r, _ in special_rows(mode, width, height, y0)])]).to(card)
    n = params.shape[0]
    start = torch.tensor([0, n, n, n, n, n], dtype=torch.int32, device=card)
    count = torch.tensor([n, 0, 0, 0, 0, 0], dtype=torch.int32, device=card)
    args = (params, start, count, width // 16, width, height, y0)
    kw = dict(chunk=512, mode=MODE[mode], bbox=bbox)
    got = tf.composite_tiles_raw(*args, **kw)
    plain = tf.composite_tiles_raw_plain(*args, **kw)
    torch.cuda.synchronize()
    assert float((got - plain).abs().max()) <= (SURFEL_BAR if mode == "2d" else 2e-5)
    assert float(plain[0, 3].max()) < 1.0  # the rows reach every pixel of the tile
    masks = cull.warp_masks(params, start, count, width // 16, width, height, y0, MODE[mode])
    assert int((masks[:n] != 0xFF).sum()) > n // 2  # and most rows are culled in some warp
    _forward_again(got, *args, **kw)


@pytest.mark.parametrize("name,settings", [
    ("obb-bbox", OVERLAY["obb"]), ("aabb-bbox", OVERLAY["aabb"]), ("2d-bbox", OVERLAY["2d"]),
    ("depth", CloudSettings(rasterize_mode=RasterizeMode.DEPTH)),
    ("normal", CloudSettings(rasterize_mode=RasterizeMode.NORMAL)),
    ("classification", CloudSettings(rasterize_mode=RasterizeMode.CLASSIFICATION, num_classes=4)),
    ("highlight", CloudSettings(draw_mode=DrawMode.HIGHLIGHT_SELECTED)),
])
def test_views_render_card_match_cpu(card, name, settings):
    a = _scene("bench", 2000, 3)
    a["position_visibility"][:, 3] = np.random.default_rng(11).choice(
        np.array([0.0, 0.25, 0.5, 1.0, 2.0, 3.0, 4.0], np.float32), 2000)
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=128, height=120, device="cpu")
    cpu = render(cloud_from_numpy(a, "cpu"), cam, settings, device="cpu")
    gpu = render(cloud_from_numpy(a, card), cam.to(card), settings)
    bar = SURFEL_BAR if settings.gaussian_mode == GaussianMode.GAUSSIAN_2D else 2e-5
    assert float((gpu.cpu() - cpu).abs().max()) <= bar


# The fused serving projection (ops/cuda/project.py, csrc/project.cu) against
# the eager chain it replaces, both on the card: the chain's own arithmetic,
# so every output bit for bit.  exp, log, cos and pow are the same CUDA
# math-library routines in the kernel and in PyTorch's kernels, so they are
# held bitwise too: no ulp allowance is taken for them.
def _model_transform(device):
    """A rotation about a tilted axis, an anisotropic scale and a shift."""
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]) @ np.array(
        [[1.0, 0.0, 0.0], [0.0, np.cos(0.3), -np.sin(0.3)], [0.0, np.sin(0.3), np.cos(0.3)]]
    )
    m = np.eye(4)
    m[:3, :3] = rot * np.array([1.3, 0.8, 1.1])
    m[:3, 3] = [1.5, -2.0, 0.5]
    return torch.tensor(m, dtype=torch.float32, device=device)


def _fused_cloud(kind, n, seed):
    if kind == "4d":
        return random_arrays_4d_seeded(n, seed=seed)
    if kind == "edge":
        return edge_cloud_arrays(n, seed)
    if kind.startswith("sh"):  # a storage degree other than 3
        return random_arrays_3d_seeded(n, seed=seed, sh_degree=int(kind[2:]))
    return _scene(kind, n, seed)


# (kind, n, width, height, settings, model transform, time)
_G4 = GaussianMode.GAUSSIAN_4D
_LINEAR = GaussianColorSpace.LIN_REC709_DISPLAY
FUSED_CASES = {
    "bench-512": ("bench", 20000, 512, 512, CloudSettings(), False, None),
    "bench-1080p": ("bench", 20000, 1920, 1080, CloudSettings(), False, None),
    "wide-1080p-transform": ("wide", 4000, 1920, 1080, CloudSettings(), True, None),
    "occluded-512-aabb": ("occluded", 2000, 512, 512, CloudSettings(aabb=True), False, None),
    "bench-512-aabb-transform": ("bench", 20000, 512, 512, CloudSettings(aabb=True), True, None),
    "bench-512-fixed-cutoff": ("bench", 20000, 512, 512, CloudSettings(opacity_adaptive_radius=False), False, None),
    "bench-512-selected": ("bench", 20000, 512, 512, CloudSettings(draw_mode=DrawMode.SELECTED), False, None),
    "bench-1080p-highlight": (
        "bench", 20000, 1920, 1080, CloudSettings(draw_mode=DrawMode.HIGHLIGHT_SELECTED), True, None),
    "bench-512-linear": ("bench", 20000, 512, 512, CloudSettings(color_space=_LINEAR), False, None),
    "bench-512-16bit-keys": (
        "bench", 20000, 512, 512, CloudSettings(radix_sort_depth_bits=RadixSortDepthBits.BITS_16), False, None),
    "sh1-512": ("sh1", 4000, 512, 512, CloudSettings(), False, None),
    "sh4-512-transform": ("sh4", 4000, 512, 512, CloudSettings(), True, None),
    "edge-512": ("edge", 4096, 512, 512, CloudSettings(), False, None),
    "edge-1080p-aabb-transform": ("edge", 4096, 1920, 1080, CloudSettings(aabb=True), True, None),
    "4d-512": ("4d", 20000, 512, 512, CloudSettings(gaussian_mode=_G4), False, 0.25),
    "4d-1080p-transform-tensor-time": ("4d", 20000, 1920, 1080, CloudSettings(gaussian_mode=_G4), True, "tensor"),
    "4d-512-aabb-selected": ("4d", 20000, 512, 512, CloudSettings(
        gaussian_mode=_G4, aabb=True, draw_mode=DrawMode.SELECTED, opacity_adaptive_radius=False), False, 0.75),
    "4d-512-highlight-linear": ("4d", 20000, 512, 512, CloudSettings(
        gaussian_mode=_G4, draw_mode=DrawMode.HIGHLIGHT_SELECTED, color_space=_LINEAR, time=0.4), True, None),
}


def _fused_inputs(card, case):
    kind, n, width, height, settings, transform, time = FUSED_CASES[case]
    a = _fused_cloud(kind, n, 21)
    a["position_visibility"][:, 3] = np.random.default_rng(12).choice(np.array([0.0, 0.5, 0.75, 1.0], np.float32), n)
    cloud = cloud_from_numpy(a, card)
    # the edge cloud's rows at and beside the camera need its own eye
    cam = Camera.create(eye=EYE if kind == "edge" else (3.0, 4.0, 60.0), width=width, height=height, device=card)
    if time == "tensor":
        time = torch.tensor(0.6, device=card)
    return cloud, cam, settings, (_model_transform(card) if transform else None), time


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _fused_launches():
    return trace.counters().get("project.fused", 0)


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_projection_equals_the_eager_chain(card, case):
    cloud, cam, settings, model, time = _fused_inputs(card, case)
    assert pj.fused_projection_applies(cloud, settings, model, time)
    before = _fused_launches()
    got = pj.project_splats(cloud, cam, settings, model, time)
    assert _fused_launches() == before + 1
    # the kernel packs for the camera's size by default
    ref = pj.project_splats_plain(cloud, cam, settings, model, time, size=(cam.width, cam.height))
    torch.cuda.synchronize()
    assert set(got) == set(ref)
    differ = {}
    for name in sorted(ref):
        a, b = _bits(got[name]), _bits(ref[name])
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if not torch.equal(a, b):
            rows = (a != b).reshape(a.shape[0], -1).any(dim=1)
            differ[name] = (int(rows.sum()), int((a.long() - b.long()).abs().max()))
    assert not differ, f"rows that differ and the most ulps by field: {differ}"
    assert int(ref["mask"].sum()) > 0


@pytest.mark.parametrize("case", ["bench-1080p", "wide-1080p-transform", "occluded-512-aabb", "bench-1080p-highlight",
                                  "4d-512", "4d-1080p-transform-tensor-time"])
def test_fused_render_matches_the_eager_chain(card, case, monkeypatch):
    """``render_tiled`` through the kernel against the same call with the
    eager chain (the dispatch rule forced off): within 2e-5, and the kernel
    took every projection of the frame."""
    cloud, cam, settings, model, time = _fused_inputs(card, case)
    before = _fused_launches()
    got = rt.render_tiled(cloud, cam, settings, model, differentiable=False, time=time)
    assert _fused_launches() == before + 1
    monkeypatch.setattr(pj, "fused_projection_applies", lambda *args: False)
    ref = rt.render_tiled(cloud, cam, settings, model, differentiable=False, time=time)
    assert _fused_launches() == before + 1
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 2e-5
    assert float(ref[..., 3].max()) > 0.5


# the SH colour stage's kernels at the parity shapes (an N that leaves a
# ragged last block) and at 1M
SH_CASES = [(kind, 4099) for kind in SH_KINDS] + [(kind, 1 << 20) for kind in ("deg0", "deg1", "deg2", "deg3", "4d")]


def _sh_fused():
    return trace.counters().get("sh.fused", 0)


@pytest.mark.parametrize("kind,n", SH_CASES)
def test_sh_kernels_match_the_eager_chain(card, kind, n):
    """The forward kernel's colour is the eager chain's bits; the backward
    kernel's d_sh is autograd's bits through the eager chain, its d_dir and
    d_dir_t within SH_GRAD_REL of float64 autograd."""
    inp = sh_stage_inputs(kind, n, 4)
    fused = sh_stage_tensors(inp, card)
    before = _sh_fused()
    rgb = sh_fn.sh_colour(*fused)
    assert _sh_fused() == before + 1
    eager = sh_stage_tensors(inp, card)
    rgb_eager = sh_fn.sh_colour_plain(*eager)
    assert torch.equal(_bits(rgb.detach()), _bits(rgb_eager.detach()))
    got = sh_stage_grads(rgb, fused, inp["g"])
    want = sh_stage_grads(rgb_eager, eager, inp["g"])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    wide = sh_stage_tensors(inp, card, torch.float64)
    exact = sh_stage_grads(sh_fn.sh_colour_plain(*wide), wide, inp["g"])
    torch.cuda.synchronize()
    if kind == "deg0":  # the constant basis reads no direction
        assert got[0] is None and exact[0] is None
    else:
        assert rel_gap(got[0], exact[0]) <= SH_GRAD_REL
    if kind == "4d":
        assert rel_gap(got[2], exact[2]) <= SH_GRAD_REL


FIELDS_4D = ("position_visibility", "spherindrical_harmonic", "isotropic_rotations", "scale_opacity",
             "timestamp_timescale")


def test_4d_training_gradients_card_match_cpu(card):
    """A 4DGS training render's gradients through the colour stage's kernels
    against the same on the CPU (the plain versions), AABB (the OBB axis of
    a 4D splat is ill-conditioned, see test_4d_aabb_render_card_matches_cpu)."""
    settings = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D, aabb=True, time=0.4)
    a = random_arrays_4d_seeded(2000, seed=3)
    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=128, height=120, device="cpu")

    def grads(device):
        with torch.no_grad():
            target = rt.render_tiled(cloud_from_numpy(a, device), cam.to(device), settings.replace(time=0.5),
                                     background=bg.to(device))
        model = TrainableCloud.from_numpy(a, device)
        img = rt.render_tiled(model.cloud(), cam.to(device), settings, background=bg.to(device))
        mse(img, target).backward()
        return {f: getattr(model, f).grad.cpu() for f in FIELDS_4D}

    before = _sh_fused()
    gpu = grads(card)
    assert _sh_fused() == before + 1  # the training render; the target's is the fused projection
    cpu = grads("cpu")
    for f in FIELDS_4D:
        assert bool(torch.isfinite(gpu[f]).all()), f
        assert float((gpu[f] - cpu[f]).abs().max()) <= GRAD_BAR * float(cpu[f].abs().max()), f


# The 3DGS training projection (ops/cuda/project.py ProjectCore, csrc/project.cu
# project_train_kernel and project_bwd_kernel): a trained Gaussian3dCloud in
# COLOR on the card takes it.
TRAIN_CASES = [name for name, case in FUSED_CASES.items() if case[0] != "4d"]
LEAVES = ("position_visibility", "rotation", "scale_opacity")
TWIN_BAR = 1e-3  # tests/test_torch_project_grad.py F32_BAR: the twin against autograd


def _trained_inputs(card, case):
    cloud, cam, settings, model, _ = _fused_inputs(card, case)
    return TrainableCloud(cloud), cam, settings, model


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_trained_projection_forward_equals_the_eager_chain_and_the_serving_kernel(card, case):
    """The forward kernel's rows and binning fields (its geometry, alpha and
    the colour stage along its direction) are the eager chain's bits with
    grad, and the serving kernel's without."""
    model, cam, settings, mt = _trained_inputs(card, case)
    cloud = model.cloud()
    assert pj.trained_projection_applies(cloud, settings, mt)
    before = _fused_launches()
    got = pj.project_splats(cloud, cam, settings, mt)
    assert _fused_launches() == before + 1
    assert got["params"].requires_grad
    eager = pj.project_splats_plain(cloud, cam, settings, mt)
    with torch.no_grad():
        served = pj.project_splats(cloud, cam, settings, mt)
    assert _fused_launches() == before + 2
    torch.cuda.synchronize()
    for label, ref in (("eager", eager), ("served", served)):
        assert set(got) == set(ref), label
        differ = [k for k in ref if not torch.equal(_bits(got[k].detach()), _bits(ref[k].detach()))]
        assert not differ, (label, differ)
    assert int(eager["mask"].sum()) > 0


def _projection_grads(model, cam, settings, mt, g):
    out = pj.project_splats(model.cloud(), cam, settings, mt)
    grads = torch.autograd.grad((out["params"] * g).sum(), [getattr(model, k) for k in LEAVES])
    return out["params"].detach(), grads


@pytest.mark.parametrize("case", ["bench-512", "occluded-512-aabb", "bench-512-aabb-transform",
                                  "bench-512-fixed-cutoff", "bench-512-selected", "bench-1080p-highlight",
                                  "wide-1080p-transform", "sh1-512", "sh4-512-transform", "bench-1m"])
def test_trained_projection_backward_matches_its_twin(card, case, monkeypatch):
    """The backward kernel's leaf gradients under a seeded cotangent of the
    rows against the twin (``project_backward_plain``, run on the card
    after the same forward), within TWIN_BAR (norm of the difference over
    norm) on the rows the forward leaves finite; the visibility channel's
    gradient is 0."""
    if case == "bench-1m":
        model = TrainableCloud(cloud_from_numpy(_scene("bench", 1 << 20, 0), card))
        cam = Camera.create(eye=(3.0, 4.0, 60.0), width=512, height=512, device=card)
        settings, mt = CloudSettings(), None
    else:
        model, cam, settings, mt = _trained_inputs(card, case)
    n = len(model.cloud())
    g = torch.randn((n, 10), generator=torch.Generator(card).manual_seed(3), device=card)
    g[::5] = 0.0
    rows, got = _projection_grads(model, cam, settings, mt, g)
    monkeypatch.setattr(pj, "_backward_kernel", pj.project_backward_plain)
    _, twin = _projection_grads(model, cam, settings, mt, g)
    torch.cuda.synchronize()
    finite = torch.isfinite(rows).all(dim=1)
    assert int(finite.sum()) >= 0.99 * n
    gaps = {k: rel_gap(a[finite], b[finite]) for k, a, b in zip(LEAVES, got, twin)}
    assert all(v <= TWIN_BAR for v in gaps.values()), gaps
    assert not bool(got[0][:, 3].any())


def _ring_camera(k, device):
    az = 2.0 * np.pi * k / 8
    return Camera.create(eye=(60.0 * np.sin(az), 0.0, 60.0 * np.cos(az)), width=512, height=512, device=device)


def _norm_gaps(got: dict, ref: dict, keys) -> float:
    """The worst leaf's gap of norms over the reference leaf's norm or the
    median leaf's (benchmark/traffic/train.py leaf_gaps)."""
    med = statistics.median(ref[k] for k in keys)
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def test_three_train_steps_at_1m_match_the_eager_chain(card, monkeypatch):
    """Three ``train_step``s (the 3DGS loss, Adam at 0.02) on a seeded 1M
    scene through the kernels against the same steps through the eager
    chain (the rule forced off), by the gs3d-1m.train-512 cell's gaps and
    limits (PERF.md section 2): ``loss_gap`` 2e-3, ``grad_gap`` 1e-3 (the
    first gradient's norms over the splats whose OBB axis is
    well-conditioned), ``change_gap`` 1e-2."""
    a = _scene("bench", 1 << 20, 4)
    cams = [_ring_camera(k, card) for k in range(3)]
    settings = CloudSettings()
    with torch.no_grad():
        moved = cloud_from_numpy(shifted_arrays(a), card)
        targets = [rt.render_tiled(moved, c, settings) for c in cams]
        cloud = cloud_from_numpy(a, card)
        world = cloud.position
        sxx, sxy, syy = cov_ops.cov2d(world, cov_ops.compute_cov3d(cloud.rotation, cloud.scale),
                                      cams[0].view_from_world, cams[0].clip_from_view, cams[0].viewport[2:]).unbind(-1)
        well = sxy.abs() >= 1e-3 * (sxx + syy)

    def steps():
        model = TrainableCloud.from_numpy(a, card)
        opt = adam(model, 0.02)
        before = _fused_launches()
        losses, grads = [], None
        for s, (c, t) in enumerate(zip(cams, targets)):
            losses.append(float(train_step(model, opt, c, t, settings, gaussian_splatting_loss)))
            if s == 0:
                grads = {k: float(getattr(model, k).grad[well].norm()) for k in model.fields}
        change = {k: float((getattr(model, k).detach() - getattr(cloud, k)).norm()) for k in model.fields}
        return losses, grads, change, _fused_launches() - before

    losses, grads, change, launched = steps()
    assert launched == 3
    monkeypatch.setattr(pj, "trained_projection_applies", lambda *args: False)
    ref_losses, ref_grads, ref_change, ref_launched = steps()
    assert ref_launched == 0
    loss_gap = max(abs(x - y) / abs(y) for x, y in zip(losses, ref_losses))
    grad_gap = _norm_gaps(grads, ref_grads, list(ref_grads))
    med = statistics.median(ref_grads.values())
    change_gap = _norm_gaps(change, ref_change, [k for k, v in ref_grads.items() if v >= 1e-3 * med])
    print(f"loss_gap {loss_gap:.3e} grad_gap {grad_gap:.3e} change_gap {change_gap:.3e}, {int((~well).sum())} "
          "ill-conditioned splats")
    assert loss_gap <= 2e-3 and grad_gap <= 1e-3 and change_gap <= 1e-2, (loss_gap, grad_gap, change_gap)


def test_projection_kernels_do_not_spill(card):
    """ptxas's report of csrc/project.cu: every kernel, the training forward
    and backward among them, without a spill."""
    build.load("project")
    usage = dict(build.ptxas_usage("project"))
    assert sum("project_train_kernel" in k or "project_bwd_kernel" in k for k in usage) == 4, list(usage)
    for kernel, line in usage.items():
        print(f"{kernel}: {line}")
        assert "0 bytes spill stores" in line and "0 bytes spill loads" in line, (kernel, line)
