"""PyTorch port, the training backward piece by piece, on the CPU:

  - the backward compositor's plain version (csrc/tile_bwd.cu's twin)
    against the JAX package's Pallas backward kernel in interpret mode, on
    the same pair-sorted parameters, tile ranges and cotangents;
  - the segmented reduce's plain version (csrc/reduce.cu's twin) against
    the Pallas reduce kernel in interpret mode;
  - the binning's inverse maps against the JAX training binning;
  - the hand-derived backward against autograd through the port's oracle.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops.pallas.reduce import pallas_segment_reduce
from bevy_gaussian_splatting_tpu.ops.pallas.tile_bwd import pallas_composite_backward
from bevy_gaussian_splatting_tpu.ops.pallas.tile_fwd import pallas_forward_raw
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import core as tcore
from bevy_gaussian_splatting_tpu_torch.ops.cuda import reduce as tred
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_bwd as tbwd
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tfwd
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_ref import render_oracle
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, shifted_arrays
from torch_port_cases import cameras, cloud_arrays, jax_cloud, jax_splats, torch_cloud

FIELDS = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")
# backward kernel, plain vs Pallas: per gradient column, of its largest |JAX|
# (the blend and the pixel sums associate differently: sequential products
# and sums against lane scans and sublane reductions)
BWD_BAR = 1e-4

# (kind, n, seed, width, height, chunk): test_pallas.py's sizes, the non-16
# height, and heavy occlusion with short chunks so the early exit binds
BWD_CASES = [
    ("wide", 400, 1, 64, 64, None),
    ("wide", 400, 1, 128, 120, None),
    ("occluded", 1000, 4, 128, 128, 128),
]
BWD_IDS = [f"{k}{n}-{w}x{h}-chunk{c}" for k, n, _, w, h, c in BWD_CASES]


@functools.lru_cache(maxsize=None)
def _jax_bins(kind, n, seed, width, height, p_max=None):
    """The JAX package's training binning (Pallas expansion) and its inputs,
    as numpy: (splats for the port, p_max, bins)."""
    jc, _ = cameras(width, height)
    settings = bgs.CloudSettings()
    cloud = jax_cloud(cloud_arrays(kind, n, seed))
    js = jax_splats(cloud, jc, settings)
    if p_max is None:
        p_max = jrt.pairs_budget(n, int(jrt.pair_count(cloud, jc, settings)))
    bins = jrt.bin_gaussians(
        js, settings, width, height, p_max, with_inverse=True, expand="pallas", interpret=True
    )
    shared = {k: torch.from_numpy(np.array(js[k])) for k in ("center_ndc", "obb_axis", "obb_bounds", "mask")}
    shared["sort_key"] = torch.from_numpy(np.asarray(js["sort_key"]).astype(np.int64))
    params = np.asarray(jrt.pack_raster_params(js, settings, width, height))
    return shared, p_max, tuple(np.asarray(b) for b in bins), params


@functools.lru_cache(maxsize=None)
def _backward_inputs(kind, n, seed, width, height, chunk):
    """Pair-sorted params, tile ranges and gbar: rows 0-3 seeded cotangents,
    rows 4-7 the Pallas forward's true totals."""
    _, p_max, bins, params = _jax_bins(kind, n, seed, width, height)
    g_s, tile_s = bins[0], bins[1]
    h_pad = jrt.pad_to_tile(height)
    num_tiles = (width // 16) * (h_pad // 16)
    start, end = (np.asarray(x) for x in jrt.tile_ranges(jnp.asarray(tile_s), num_tiles))
    count = np.minimum(end - start, jrt.tile_budget(n)).astype(np.int32)
    params_sorted = params[g_s]
    if chunk is None:
        chunk = tfwd.preferred_chunk(p_max, num_tiles)
    raw = np.asarray(pallas_forward_raw(
        jnp.asarray(params_sorted), jnp.asarray(start), jnp.asarray(count), bgs.CloudSettings(), width, h_pad,
        interpret=True, chunk_size=chunk, full_height=height,
    )).reshape(num_tiles, 8, 256)
    rng = np.random.default_rng(seed + 100)
    gbar = np.concatenate([
        rng.normal(0.0, 1e-3, (num_tiles, 4, 256)).astype(np.float32), raw[:, :3], raw[:, 3:4],
    ], axis=1)
    return params_sorted, start.astype(np.int32), count, gbar, chunk


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_plain_backward_matches_pallas(case):
    kind, n, seed, width, height, chunk = case
    params, start, count, gbar, chunk = _backward_inputs(kind, n, seed, width, height, chunk)
    h_pad = jrt.pad_to_tile(height)
    ref = np.asarray(pallas_composite_backward(
        jnp.asarray(params), jnp.asarray(start), jnp.asarray(count), jnp.asarray(gbar), bgs.CloudSettings(),
        width, h_pad, interpret=True, full_height=height, chunk_size=chunk,
    ))
    got = tbwd.composite_backward(
        torch.from_numpy(params), torch.from_numpy(start), torch.from_numpy(count),
        torch.from_numpy(gbar), width // 16, width, height, chunk=chunk,
    ).numpy()
    assert got.shape == ref.shape == (params.shape[0], 10)
    scale = np.abs(ref).max(axis=0)
    assert (scale > 0).all(), "a gradient column is identically zero"
    err = np.abs(got - ref).max(axis=0)
    assert (err <= BWD_BAR * scale).all(), f"per-column error / max: {err / scale}"
    # pairs no tile covers (past the total) get exact zeros on both sides
    covered = np.zeros(params.shape[0], bool)
    for s, c in zip(start, count):
        covered[s:s + c] = True
    assert not got[~covered].any() and not ref[~covered].any()
    assert tbwd.composite_backward.launches == 0  # CPU tensors never launch


def test_plain_backward_band_offset():
    # band geometry: the first four tile rows evaluated as rows 16.. of the
    # frame (y0, full_height), as multi-device bands will call it
    params, start, count, gbar, chunk = _backward_inputs("wide", 400, 1, 128, 120, None)
    s, c, g = start[:32].copy(), count[:32].copy(), gbar[:32].copy()
    ref = np.asarray(pallas_composite_backward(
        jnp.asarray(params), jnp.asarray(s), jnp.asarray(c), jnp.asarray(g), bgs.CloudSettings(), 128, 64,
        interpret=True, y0=jnp.array([16], jnp.int32), full_height=120, chunk_size=chunk,
    ))
    got = tbwd.composite_backward_plain(
        torch.from_numpy(params), torch.from_numpy(s), torch.from_numpy(c), torch.from_numpy(g),
        8, 128, 120, y0=16, chunk=chunk,
    ).numpy()
    scale = np.abs(ref).max(axis=0)
    assert (scale > 0).all()
    assert (np.abs(got - ref).max(axis=0) <= BWD_BAR * scale).all()


def test_plain_backward_stops_where_the_forward_stops():
    # heavy occlusion: pairs past each tile's early exit keep zero gradients
    params, start, count, gbar, chunk = _backward_inputs("occluded", 1000, 4, 128, 128, 128)
    walked = torch.zeros(start.shape[0], dtype=torch.int64)
    tfwd.composite_tiles_raw_plain(
        torch.from_numpy(params), torch.from_numpy(start), torch.from_numpy(count), 8, 128, 128,
        chunk=chunk, walked=walked,
    )
    got = tbwd.composite_backward_plain(
        torch.from_numpy(params), torch.from_numpy(start), torch.from_numpy(count),
        torch.from_numpy(gbar), 8, 128, 128, chunk=chunk,
    ).numpy()
    walked = walked.numpy()
    assert (walked < count).any(), "the early exit never bound"
    for t in range(start.shape[0]):
        tail = got[start[t] + walked[t]:start[t] + count[t]]
        assert not tail.any(), f"tile {t} has gradients past its early exit"


# the row width: 10 columns for OBB and AABB gradients, 16 for 2DGS
@pytest.mark.parametrize("p_max,cols", [(None, 10), (1000, 10), (None, 16)], ids=["budget", "cap-binds", "budget-2dgs"])
def test_plain_reduce_matches_pallas(p_max, cols):
    shared, p_max, bins, _ = _jax_bins("wide", 400, 1, 128, 128, p_max)
    n = shared["mask"].shape[0]
    total = int(bins[3])
    _, table, g0s = bins[4], bins[5], bins[6]
    rng = np.random.default_rng(7)
    dslot = rng.normal(0.0, 1.0, (p_max, cols)).astype(np.float32)
    dslot[min(total, p_max):] = 0.0  # invalid pairs carry zero gradients
    dslot_t = np.concatenate([dslot.T, np.zeros((16 - cols, p_max), np.float32)])
    ref = np.asarray(pallas_segment_reduce(
        jnp.asarray(dslot_t), jnp.asarray(table), jnp.asarray(g0s), n, interpret=True
    ))[:cols].T
    cum = trt.bin_gaussians(shared, 128, 128, p_max)[6]
    got = tred.segment_reduce(torch.from_numpy(dslot), cum, n).numpy()
    assert got.shape == (n, cols)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    empty = np.diff(np.concatenate([[0], cum.numpy()])) == 0
    assert empty.any() and not got[empty].any()
    assert tred.segment_reduce.launches == 0


def test_reduce_adds_in_slot_order():
    # one long segment of values whose sum depends on the order of the adds
    vals = np.array([1e8, 1.0, -1e8, 1.0] * 8, np.float32)
    dslot = np.repeat(vals[:, None], 10, axis=1)
    cum = torch.tensor([0, 32, 32], dtype=torch.int32)
    got = tred.segment_reduce_plain(torch.from_numpy(dslot), cum, 3).numpy()
    acc = np.float32(0.0)
    for v in vals:
        acc = np.float32(acc + v)
    assert (got[1] == acc).all() and not got[0].any() and not got[2].any()


@pytest.mark.parametrize("case,p_max", [
    (("wide", 400, 1, 128, 128), None), (("bench", 2000, 3, 128, 120), None), (("wide", 400, 1, 128, 128), 1000),
], ids=["wide400-128x128", "bench2000-128x120", "wide400-cap-binds"])
def test_inverse_maps_match_jax_training_binning(case, p_max):
    kind, n, seed, width, height = case
    shared, p_max, bins, _ = _jax_bins(kind, n, seed, width, height, p_max)
    g_s, tile_s, _, total, order, rank, cum, perm = trt.bin_gaussians(shared, width, height, p_max)
    j_gs, j_tile, _, j_total, gidx_s, table, _, j_rank = bins
    assert int(total) == int(j_total)
    np.testing.assert_array_equal(g_s.numpy(), j_gs)
    np.testing.assert_array_equal(tile_s.numpy(), j_tile)
    # the per-pair depth rank in sorted order is the JAX package's gidx_s
    np.testing.assert_array_equal(rank[order].numpy(), gidx_s)
    # the clamped counts are the expansion table's row 0, clamped the same way
    np.testing.assert_array_equal(cum.numpy(), np.minimum(table[0, :n], p_max).astype(np.int32))
    # perm is the depth pre-sort the JAX package inverts into its rank map
    inv = np.empty(n, np.int64)
    inv[perm.numpy()] = np.arange(n)
    np.testing.assert_array_equal(inv, j_rank)
    # order is the inverse of the stable tile sort: sorted pair i sits in slot order[i]
    assert sorted(order.tolist()) == list(range(p_max))


def test_core_backward_is_the_hand_derived_one():
    a = cloud_arrays("wide", 400, 1)
    _, tc = cameras(64, 64)
    splats = trt.project_for_binning(torch_cloud(a), tc, TSettings())
    bins = trt.tile_bins(splats, 64, 64, 1 << 14)
    params = splats["params"].detach().requires_grad_()
    out = tcore.composite_core(params, *bins, tx_count=4, width=64, full_height=64)
    assert type(out.grad_fn).__name__ == "CompositeCoreBackward"
    out.sum().backward()
    assert params.grad.shape == (400, 10) and torch.isfinite(params.grad).all()


# (kind, n, seed, width, height, background)
ORACLE_CASES = [
    ("wide", 400, 1, 64, 64, None),
    ("bench", 2000, 3, 128, 120, (0.3, 0.2, 0.1, 1.0)),
]


@pytest.mark.parametrize("case", ORACLE_CASES, ids=["wide400-64x64", "bench2000-128x120-bg"])
def test_backward_matches_autograd_through_oracle(case):
    kind, n, seed, width, height, bg = case
    a = cloud_arrays(kind, n, seed)
    a["scale_opacity"] = a["scale_opacity"] * np.array([1, 2, 0.5, 1], np.float32)
    _, tc = cameras(width, height)
    settings = TSettings()
    background = None if bg is None else torch.tensor(bg)
    with torch.no_grad():
        target = render_oracle(torch_cloud(shifted_arrays(a)), tc, settings, background=background)

    def grads(render):
        model = TrainableCloud.from_numpy(a, "cpu")
        loss = torch.mean((render(model.cloud()) - target) ** 2)
        loss.backward()
        return float(loss.detach()), {f: getattr(model, f).grad.numpy() for f in FIELDS}

    l_tiled, g_tiled = grads(lambda c: trt.render_tiled(c, tc, settings, background=background))
    l_oracle, g_oracle = grads(lambda c: render_oracle(c, tc, settings, background=background))
    assert abs(l_tiled - l_oracle) <= 1e-5 * l_oracle
    for f in FIELDS:
        scale = np.abs(g_oracle[f]).max()
        assert scale > 0 and np.isfinite(g_tiled[f]).all(), f
        assert np.abs(g_tiled[f] - g_oracle[f]).max() <= 1e-4 * scale, f


def test_backward_checks_inputs():
    p = torch.zeros(10, 10)
    s = torch.zeros(4, dtype=torch.int32)
    g = torch.zeros(4, 8, 256)
    with pytest.raises(ValueError):
        tbwd.composite_backward(p, s, s, torch.zeros(4, 4, 256), 2, 32, 32)
    with pytest.raises(TypeError):
        tbwd.composite_backward(p, s, s, g.double(), 2, 32, 32)
    with pytest.raises(TypeError):
        tred.segment_reduce(p, s.long(), 4)
    with pytest.raises(ValueError):
        tred.segment_reduce(p, s, 5)
    with pytest.raises(ValueError):
        tred.segment_reduce(p[:, :0], s, 4)
    assert tbwd.composite_backward(p, s, s, g, 2, 32, 32).abs().sum() == 0
