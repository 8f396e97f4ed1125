"""PyTorch port, binning (ops/rasterize_tile.py + the expansion's plain
version) against the JAX package's Pallas-expansion binning, run in
interpret mode.  Every integer artifact is array-equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops.pallas.expand import CHUNK, CUM_PAD, WIN, pallas_expand_pairs
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import expand as texp
from torch_port_cases import CASE_IDS, CASES, cameras, cloud_arrays, jax_cloud, jax_splats, torch_cloud

SPLAT_KEYS = ("center_ndc", "obb_axis", "obb_bounds", "mask")


def _shared_splats(js):
    """The JAX splats as the port's binning inputs (keys carried in int64)."""
    out = {k: torch.from_numpy(np.array(js[k])) for k in SPLAT_KEYS}
    out["sort_key"] = torch.from_numpy(np.asarray(js["sort_key"]).astype(np.int64))
    return out


def _compare_bins(arrays, width, height, p_max=None):
    jc, _ = cameras(width, height)
    settings = bgs.CloudSettings()
    js = jax_splats(jax_cloud(arrays), jc, settings)
    n = arrays["position_visibility"].shape[0]
    if p_max is None:
        p_max = jrt.pairs_budget(n, int(jrt.pair_count(jax_cloud(arrays), jc, settings)))
    ref = jrt.bin_gaussians(js, settings, width, height, p_max, expand="pallas", interpret=True)
    got = trt.bin_gaussians(_shared_splats(js), width, height, p_max)
    assert int(got[3]) == int(ref[3]), "total"
    for i, name in ((0, "g_s"), (1, "tile_s"), (2, "valid_s")):
        assert got[i].shape == (p_max,)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]), err_msg=name)
    num_tiles = (width // 16) * (trt.pad_to_tile(height) // 16)
    js_start, js_end = jrt.tile_ranges(ref[1], num_tiles)
    start, end = trt.tile_ranges(got[1], num_tiles)
    np.testing.assert_array_equal(start.numpy(), np.asarray(js_start), err_msg="start")
    np.testing.assert_array_equal(end.numpy(), np.asarray(js_end), err_msg="end")
    return int(ref[3]), p_max


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bin_gaussians_equal(case):
    kind, n, seed, w, h = case
    total, p_max = _compare_bins(cloud_arrays(kind, n, seed), w, h)
    assert 0 < total < p_max


@pytest.mark.parametrize("p_max", [512, 1000])
def test_bin_gaussians_cap_binds(p_max):
    # budget far below the real pair count: the farthest pairs drop
    total, _ = _compare_bins(cloud_arrays("wide", 400, 1), 128, 128, p_max)
    assert total > p_max


def test_bin_gaussians_all_inactive():
    a = cloud_arrays("wide", 400, 1)
    a["position_visibility"][:, 0] += 1e4  # every gaussian off screen
    total, _ = _compare_bins(a, 128, 128, 1 << 12)
    assert total == 0


def test_bin_gaussians_mixed_offscreen():
    a = cloud_arrays("wide", 400, 1)
    a["position_visibility"][::3, 0] += 1e4
    _compare_bins(a, 128, 120, 1 << 13)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_pair_count_and_budgets(case):
    kind, n, seed, w, h = case
    a = cloud_arrays(kind, n, seed)
    jc, tc = cameras(w, h)
    j = int(jrt.pair_count(jax_cloud(a), jc, bgs.CloudSettings()))
    t = int(trt.pair_count(torch_cloud(a), tc, TSettings()))
    assert t == j
    assert trt.pairs_budget(n, t) == jrt.pairs_budget(n, j)


@pytest.mark.parametrize("n", [0, 1, 100, 5000, 1_000_000, 5_000_000])
def test_budget_functions(n):
    assert trt.pairs_budget(n) == jrt.pairs_budget(n)
    for hint in (0, 17, 12_345, 2_000_000, 9_000_000):
        assert trt.pairs_budget(n, hint) == jrt.pairs_budget(n, hint)
    assert trt.tile_budget(n) == jrt.tile_budget(n)
    for v in (1, 15, 16, 17, 120, 1080):
        assert trt.pad_to_tile(v) == jrt.pad_to_tile(v)


def test_front_depth_perm_ties_and_inactive():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, 3000).astype(np.uint32)  # many ties
    keys[::7] = 0xFFFFFFFF
    active = rng.random(3000) > 0.3
    for act in (None, active):
        ref = jrt.front_depth_perm(jnp.asarray(keys), None if act is None else jnp.asarray(act))
        got = trt.front_depth_perm(
            torch.from_numpy(keys.astype(np.int64)), None if act is None else torch.from_numpy(act)
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _expansion_inputs(seed, n, n_inactive, tx_count, ty_count):
    rng = np.random.default_rng(seed)
    rect_w = rng.integers(1, 7, n).astype(np.int32)
    rect_h = rng.integers(1, 5, n).astype(np.int32)
    tx0 = np.minimum(rng.integers(0, tx_count, n), tx_count - rect_w).astype(np.int32)
    ty0 = np.minimum(rng.integers(0, ty_count, n), ty_count - rect_h).astype(np.int32)
    counts = rect_w * rect_h
    counts[:n_inactive] = 0  # inactive gaussians lead the depth order
    rect_w[:n_inactive] = 0
    perm = rng.permutation(n).astype(np.int32)
    return np.cumsum(counts).astype(np.int32), rect_w, tx0, ty0, perm


@pytest.mark.parametrize("seed,n,n_inactive,p_max", [
    (0, 700, 100, 4096),  # budget above the total
    (1, 900, 0, 1500),    # cap binds, unaligned budget
    (2, 300, 300, 1024),  # all inactive
])
def test_expand_plain_matches_pallas_kernel(seed, n, n_inactive, p_max):
    tx_count, ty_count = 8, 8
    cum, rect_w, tx0, ty0, perm = _expansion_inputs(seed, n, n_inactive, tx_count, ty_count)
    table = np.stack([
        np.minimum(cum, 1 << 24).astype(np.float32), rect_w, tx0, ty0,
        perm & 0xFF, (perm >> 8) & 0xFF, (perm >> 16) & 0xFF, np.zeros(n),
    ]).astype(np.float32)
    pad = np.zeros((8, WIN), np.float32)
    pad[0] = CUM_PAD
    table = np.concatenate([table, pad], axis=1)
    g0s = np.searchsorted(cum, np.arange(-(-p_max // CHUNK)) * CHUNK, side="right")
    j_tile, j_g, j_rank = (np.asarray(x) for x in pallas_expand_pairs(
        jnp.asarray(table), jnp.asarray(g0s, jnp.int32), p_max, tx_count, interpret=True
    ))
    sentinel = tx_count * ty_count
    t_tile, t_g, t_rank = texp.expand_pairs(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (cum, rect_w, tx0, ty0, perm)),
        p_max, tx_count, sentinel,
    )
    valid = np.arange(p_max) < cum[-1]
    np.testing.assert_array_equal(t_tile.numpy()[valid], j_tile[valid], err_msg="tile")
    assert (t_tile.numpy()[~valid] == sentinel).all()
    np.testing.assert_array_equal(t_g.numpy(), j_g, err_msg="g_cloud")
    np.testing.assert_array_equal(t_rank.numpy(), j_rank, err_msg="rank")
    assert texp.expand_pairs.launches == 0  # CPU tensors never launch


def test_expand_checks_inputs():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        texp.expand_pairs(x.to(torch.int64), x, x, x, x, 8, 2, 4)
    with pytest.raises(ValueError):
        texp.expand_pairs(x, x[:3], x, x, x, 8, 2, 4)


def test_full_port_binning_matches_on_own_splats():
    # the port's own projection feeds its binning; same artifacts as JAX
    a = cloud_arrays("wide", 400, 1)
    jc, tc = cameras(128, 120)
    p_max = 1 << 13
    js = jax_splats(jax_cloud(a), jc, bgs.CloudSettings())
    ref = jrt.bin_gaussians(js, bgs.CloudSettings(), 128, 120, p_max, expand="pallas", interpret=True)
    got = trt.bin_gaussians(trt.project_for_binning(torch_cloud(a), tc, TSettings()), 128, 120, p_max)
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))


def test_dataclass_fields_unchanged():
    # the carry-across relies on the two cloud classes sharing field names
    from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud as T3

    assert [f.name for f in dataclasses.fields(bgs.Gaussian3dCloud)] == [f.name for f in dataclasses.fields(T3)]
