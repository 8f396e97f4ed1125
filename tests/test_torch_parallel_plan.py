"""PyTorch port, the sharded path's planning without a world: the exchange
planner (parallel/render.py ``plan_exchange``), band-windowed binning and
``tile_row_range`` (ops/rasterize_tile.py), the scaling models and the
work-ratio protocol (parallel/scaling.py), and the explicit backends of
``initialize`` (parallel/distributed.py), against the JAX package: the
plan and the binning array-equal, the models within 1e-6.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.parallel import render as jpr
from bevy_gaussian_splatting_tpu.parallel import scaling as jsc
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.parallel import render as tpr
from bevy_gaussian_splatting_tpu_torch.parallel import scaling as tsc
from bevy_gaussian_splatting_tpu_torch.parallel.distributed import initialize
from torch_port_cases import cameras, cloud_arrays, jax_cloud, jax_splats, torch_cloud

S = 4  # bands
WIDTH, HEIGHT = 64, 128


def _scene(n=512, seed=0):
    """tests/test_distributed.py's scene: sizes and opacities kept in range."""
    a = random_arrays_3d_seeded(n, seed=seed)
    so = a["scale_opacity"].copy()
    so[:, :3] = np.abs(so[:, :3]) * 0.3 + 0.1
    so[:, 3] = np.clip(np.abs(so[:, 3]), 0.2, 0.9)
    a["scale_opacity"] = so
    return a


def test_plan_exchange_matches_jax():
    arrays = _scene(2048)
    jc, tc = cameras(WIDTH, HEIGHT)
    ref = jpr.plan_exchange(jax_cloud(arrays), jc, bgs.CloudSettings(), WIDTH, HEIGHT, jpr.make_mesh(S),
                            with_pairs=True)
    got = tpr.plan_exchange(torch_cloud(arrays), tc, TSettings(), WIDTH, HEIGHT, S, with_pairs=True)
    assert got == ref
    assert got[2] > 0


@pytest.fixture(scope="module")
def bench_splats():
    """bench2000 at 128x128, projected by each package for binning."""
    arrays = cloud_arrays("bench", 2000, 3)
    jc, tc = cameras(128, 128)
    return jax_splats(jax_cloud(arrays), jc, bgs.CloudSettings()), trt.project_for_binning(
        torch_cloud(arrays), tc, TSettings())


@pytest.mark.parametrize("band", range(4))
def test_band_binning_matches_jax(bench_splats, band):
    # 4 bands of 2 tile rows: the pair lists and tile ranges of JAX's
    # band-windowed binning (Pallas expansion, interpret mode)
    js, ts = bench_splats
    settings = bgs.CloudSettings()
    rows, p_max = 2, 1 << 14
    ref = jrt.bin_gaussians(js, settings, 128, 128, p_max, tile_row0=jnp.int32(band * rows), band_tile_rows=rows,
                            expand="pallas", interpret=True)
    got = trt.bin_gaussians(ts, 128, 128, p_max, tile_row0=band * rows, band_tile_rows=rows)
    assert int(got[3]) == int(ref[3]) > 0
    for i, what in ((0, "g_s"), (1, "tile_s"), (2, "valid_s")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]), err_msg=what)
    num_tiles = 8 * rows
    for a, b, what in zip(trt.tile_ranges(got[1], num_tiles), jrt.tile_ranges(ref[1], num_tiles), ("start", "end")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)
    # the tile rows the band window reads, on the active rows
    ty0, ty1, act = jrt.tile_row_range(js, settings, 128, 128)
    t0, t1, tact = trt.tile_row_range(ts, 128, 128)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(act))
    m = tact.numpy()
    np.testing.assert_array_equal(t0.numpy()[m], np.asarray(ty0)[m])
    np.testing.assert_array_equal(t1.numpy()[m], np.asarray(ty1)[m])


def test_band_window_default_is_unchanged():
    # tile_row0=None is the whole padded grid, bit for bit
    arrays = cloud_arrays("wide", 400, 1)
    _, tc = cameras(128, 120)
    ts = trt.project_for_binning(torch_cloud(arrays), tc, TSettings())
    whole = trt.bin_gaussians(ts, 128, 120, 1 << 13)
    one_band = trt.bin_gaussians(ts, 128, 120, 1 << 13, tile_row0=0, band_tile_rows=8)
    for a, b in zip(whole, one_band):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _links(params=jsc.V5P):
    return tsc.Links(params["ici_bytes_per_s"], params["dcn_bytes_per_s"], params["launch_s"])


def test_scaling_models_match_jax():
    links = _links()
    n, cols = 1_000_000, 14
    for bands, budget, link in ((8, None, "ici"), (8, 20_000, "ici"), (4, 50_000, "dcn"), (2, None, "dcn")):
        tlink = "intra" if link == "ici" else "inter"
        assert tsc.exchange_time_s(n, bands, cols, links, budget, tlink) == pytest.approx(
            jsc.exchange_time_s(n, bands, cols, budget, link), rel=1e-6)
        for ratio in (1.0, 1.5):
            assert tsc.modeled_efficiency(0.0426, n, bands, links, cols, budget, tlink, ratio) == pytest.approx(
                jsc.modeled_efficiency(0.0426, n, bands, cols, budget, link, ratio), rel=1e-6)
    for bands, budget, cams in ((1, None, 2), (4, None, 1), (4, 50_000, 1), (4, None, 2), (4, None, 4)):
        t = tsc.train_comm_bytes_per_chip(n, bands, cols, budget, n_camera=cams)
        j = jsc.train_comm_bytes_per_chip(n, bands, cols, budget, n_camera=cams)
        assert (t["intra"], t["inter"], t["fwd_exchange"], t["cloud_shard_bytes"]) == \
            (j["ici"], j["dcn"], j["fwd_exchange"], j["cloud_shard_bytes"])
    free = dict(ici_bytes_per_s=1e30, dcn_bytes_per_s=1e30, launch_s=0.0)
    for hosts, per, budget, ratio, overlap, params in (
        (1, 8, 250_000, 1.0, False, jsc.V5P), (2, 4, 250_000, 1.0, False, jsc.V5P),
        (2, 4, 250_000, 1.0, True, jsc.V5P), (1, 8, 250_000, 1.5, False, jsc.V5P), (2, 4, None, 1.0, False, free),
    ):
        assert tsc.modeled_efficiency_train(0.0994, n, hosts, per, _links(params), budget=budget, work_ratio=ratio,
                                            overlap_inter=overlap) == pytest.approx(
            jsc.modeled_efficiency_train(0.0994, n, hosts, per, budget=budget, work_ratio=ratio, overlap_dcn=overlap,
                                         params=params), rel=1e-6)


def test_serialized_median_discards_cold_first_run():
    seq = iter([{"work_ratio": r, "exchange": "bounded", "band_pairs": 1} for r in (0.852, 1.072, 1.051, 1.060)])
    with mock.patch.object(tsc, "serialized_work_ratio", lambda *a, **k: next(seq)):
        out = tsc.serialized_work_ratio_median(8, 1000, runs=4)
    assert out["work_ratio"] == 1.060
    assert out["work_ratio_runs"] == [1.051, 1.06, 1.072]
    assert out["work_ratio_spread"] < 0.03


def test_backends_are_explicit():
    with pytest.raises(ValueError, match="backend"):
        initialize("file:///nonexistent/rendezvous", 1, 0, "mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize("file:///nonexistent/rendezvous", 1, 0, "nccl")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no card")
def test_entry_points_default_to_the_card():
    # the dry run and the serialized work ratio run on the card unless the
    # caller passes device="cpu": without a card they raise, before any rank spawns
    from bevy_gaussian_splatting_tpu_torch.parallel import distributed as tdi

    with pytest.raises(RuntimeError, match="CUDA"):
        tdi.spawn_multihost_dryrun()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdi.run_multihost_dryrun("file:///nonexistent/rendezvous", 4, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsc.serialized_work_ratio(4, 100)
    assert not tdi.is_initialized()


def test_photometric_loss_matches_jax():
    rng = np.random.default_rng(5)
    a, b = (rng.random((16, 16, 4), np.float32) for _ in range(2))
    assert float(tpr.photometric_loss(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        float(jpr.photometric_loss(jnp.asarray(a), jnp.asarray(b))), rel=1e-6)
