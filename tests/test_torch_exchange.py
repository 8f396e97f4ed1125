"""PyTorch port, the bounded band exchange (parallel/exchange.py) against
the JAX package's.

Without a world: the plan, the slot owners, the send buffer (bit for bit,
NaN-coded keys included), the budgets, byte counts and pair counts and the
host planner are array-equal to JAX's.  With one gloo world of 4 spawned
ranks, shared by every case of the file (meeting through a file under the
test's temporary directory): the exchange's forward and bits against JAX's
``band_exchange`` under ``shard_map`` on 4 CPU devices, its gradient within
1e-5, the bounded sharded render against JAX's (3e-5, 2DGS 3e-4) and
bitwise against the port's all-gather, a truncating budget, the host-aware
mesh (parallel/distributed.py) and the measured work ratio
(parallel/scaling.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import bevy_gaussian_splatting_tpu as bgs
import torch_parallel_ranks as ranks
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.parallel import exchange as jex
from bevy_gaussian_splatting_tpu.parallel import render as jpr
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.models.settings import GaussianMode as TMode
from bevy_gaussian_splatting_tpu_torch.parallel import exchange as tex
from bevy_gaussian_splatting_tpu_torch.parallel import render as tpr
from bevy_gaussian_splatting_tpu_torch.parallel.distributed import World
from torch_port_cases import cameras, jax_cloud, torch_cloud

S = 4  # ranks = bands
WIDTH, HEIGHT = 64, 128


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    address = "file://" + str(tmp_path_factory.mktemp("world") / "rendezvous")
    with World(S, "gloo", address, timeout_s=120.0) as w:
        yield w


# ---------------------------------------------------------------------------
# Exchange inputs (tests/test_distributed.py's cases, at 4 bands)
# ---------------------------------------------------------------------------


def _case_near_capacity():
    """Every splat spans all bands: the pair cap truncates and the late
    destinations' segments end at the buffer's end."""
    rng = np.random.default_rng(7)
    n_local, cols = 40, 5
    payloads = [rng.standard_normal((n_local, cols)).astype(np.float32) for _ in range(S)]
    b0s = [np.zeros(n_local, np.int32) for _ in range(S)]
    b1s = [np.full(n_local, S - 1, np.int32) for _ in range(S)]
    acts = [np.ones(n_local, bool) for _ in range(S)]
    acts[3][::5] = False
    return payloads, b0s, b1s, acts, 24  # budget under the 32 rows a destination would take


def _case_random():
    rng = np.random.default_rng(11)
    n_local, cols = 64, 6
    payloads = [rng.standard_normal((n_local, cols)).astype(np.float32) for _ in range(S)]
    b0s, b1s, acts = [], [], []
    for _ in range(S):
        b0 = rng.integers(0, S, n_local).astype(np.int32)
        b0s.append(b0)
        b1s.append(np.minimum(b0 + rng.integers(0, 3, n_local), S - 1).astype(np.int32))
        acts.append(rng.random(n_local) < 0.8)
    return payloads, b0s, b1s, acts, 64


CASES = {"near_capacity": _case_near_capacity, "random": _case_random}


def _t(a, dtype=torch.int64):
    return torch.from_numpy(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("name", list(CASES))
def test_plan_matches_jax(name):
    payloads, b0s, b1s, acts, _ = CASES[name]()
    for b0, b1, act in zip(b0s, b1s, acts):
        n_local = len(b0)
        p_band = tex.band_pairs_budget(n_local)
        ref = jex._plan(jnp.asarray(b0), jnp.asarray(b1), jnp.asarray(act), n_local, p_band, S)
        got = tex._plan(_t(b0), _t(b1), torch.from_numpy(act), n_local, p_band, S)
        names = ("gidx", "gidx_s", "dest_s", "inv_pair", "seg_starts", "seg_ends", "offsets", "span")
        for r, g, what in zip(ref, got, names):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=what)


def test_slot_owners_matches_jax_scan():
    rng = np.random.default_rng(3)
    span = rng.integers(0, 4, 300) * (rng.random(300) < 0.7)
    offsets = np.cumsum(span) - span
    for p_max in (64, 256, int(span.sum()) + 17):
        starts = np.where(span > 0, offsets, p_max).astype(np.int32)
        ref = jrt.slot_owner_scan(jnp.asarray(starts), jnp.arange(300, dtype=jnp.int32), p_max)
        np.testing.assert_array_equal(tex.slot_owners(_t(starts), p_max).numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", list(CASES))
def test_send_buffer_matches_jax_bitwise(name):
    payloads, b0s, b1s, acts, budget = CASES[name]()
    payload = payloads[1].copy()
    payload[:, 2] = np.frombuffer(np.full(len(payload), 0x7FC00123, np.uint32).tobytes(), np.float32)
    n_local = len(payload)
    p_band = tex.band_pairs_budget(n_local)
    jplan = jex._plan(jnp.asarray(b0s[1]), jnp.asarray(b1s[1]), jnp.asarray(acts[1]), n_local, p_band, S)
    ref = jex._send_buffer(jnp.asarray(payload)[jplan[1]], jplan[4], jplan[5], S, budget)
    tplan = tex._plan(_t(b0s[1]), _t(b1s[1]), torch.from_numpy(acts[1]), n_local, p_band, S)
    got = tex._send_buffer(torch.from_numpy(payload)[tplan[1]], tplan[4], tplan[5], S, budget)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(ref).view(np.uint32))


def test_budgets_bytes_and_pair_count_match_jax():
    for n in (1, 100, 4096, 250_000):
        for hint in (None, 0, 77, 10_000, 10**7):
            assert tex.band_pairs_budget(n, hint) == jex.band_pairs_budget(n, hint), (n, hint)
    for n_total, bands, cols, budget in ((1_000_000, 4, 14, None), (1_000_000, 4, 14, 20_000), (4096, 8, 20, 256)):
        assert tex.exchange_bytes_per_device(n_total, bands, cols, budget) == \
            jex.exchange_bytes_per_device(n_total, bands, cols, budget)
    _, b0s, b1s, acts, _ = _case_random()
    b0, b1, act = (np.concatenate(v) for v in (b0s, b1s, acts))
    assert int(tex.band_pair_count(_t(b0), _t(b1), torch.from_numpy(act))) == \
        int(jex.band_pair_count(jnp.asarray(b0), jnp.asarray(b1), jnp.asarray(act)))
    np.testing.assert_array_equal(tex.band_interval(_t([0, 5, 15, 31]), _t([3, 9, 16, 31]), 8)[1].numpy(),
                                  np.asarray(jex.band_interval(jnp.asarray([0, 5, 15, 31]),
                                                               jnp.asarray([3, 9, 16, 31]), 8)[1]))


@pytest.mark.parametrize("headroom,quantum", [(1.25, 256), (1.0, 1), (2.0, 64)])
def test_auto_exchange_plan_matches_jax(headroom, quantum):
    _, b0s, b1s, acts, _ = _case_random()
    b0, b1, act = (np.concatenate(v) for v in (b0s, b1s, acts))
    for n_local in (64, 128):
        ref = jex.auto_exchange_plan(b0, b1, act, S, n_local, headroom=headroom, quantum=quantum)
        got = tex.auto_exchange_plan(_t(b0), _t(b1), torch.from_numpy(act), S, n_local, headroom=headroom,
                                     quantum=quantum)
        assert got == ref


# ---------------------------------------------------------------------------
# With the world
# ---------------------------------------------------------------------------


def _scene(n=512, seed=0):
    """tests/test_distributed.py's scene: sizes and opacities kept in range."""
    a = random_arrays_3d_seeded(n, seed=seed)
    so = a["scale_opacity"].copy()
    so[:, :3] = np.abs(so[:, :3]) * 0.3 + 0.1
    so[:, 3] = np.clip(np.abs(so[:, 3]), 0.2, 0.9)
    a["scale_opacity"] = so
    return a


def _jax_exchange(payloads, b0s, b1s, acts, budget, weights=None):
    """JAX's band_exchange under shard_map on 4 CPU devices -> received
    [S, S * budget, C], or with ``weights`` the payload's gradient."""
    from jax import shard_map

    mesh = JMesh(np.asarray(jax.devices())[:S], ("x",))
    cat = [jnp.concatenate([jnp.asarray(v) for v in vs]) for vs in (b0s, b1s, acts)]

    @partial(shard_map, mesh=mesh, in_specs=(P("x"),) * 5, out_specs=P("x"), check_vma=False)
    def body(payload, b0, b1, active, w):
        received = jex.band_exchange(payload, b0, b1, active, S, budget, "x")
        return received if weights is None else jax.lax.psum(jnp.sum(received * w[0]), "x")[None]

    payload = jnp.concatenate([jnp.asarray(p) for p in payloads])
    w = jnp.asarray(weights if weights is not None else np.zeros((S, 1, 1), np.float32))
    if weights is None:
        return np.asarray(jax.jit(body)(payload, *cat, w)).reshape(S, S * budget, -1)
    return np.asarray(jax.jit(jax.grad(lambda p: body(p, *cat, w)[0]))(payload))


@pytest.mark.parametrize("name", list(CASES))
def test_exchange_forward_matches_jax(world, name):
    payloads, b0s, b1s, acts, budget = CASES[name]()
    world.submit(ranks.exchange, payloads, b0s, b1s, acts, S, budget)
    ref = _jax_exchange(payloads, b0s, b1s, acts, budget)
    got = world.results()
    for d in range(S):
        np.testing.assert_array_equal(got[d], ref[d], err_msg=f"destination {d}")


def test_exchange_nan_bit_patterns_survive(world):
    payloads, b0s, b1s, acts, budget = _case_random()
    for p in payloads:
        p[:, 2] = np.frombuffer(np.full(len(p), 0x7FC00123, np.uint32).tobytes(), np.float32)
    world.submit(ranks.exchange, payloads, b0s, b1s, acts, S, budget)
    ref = _jax_exchange(payloads, b0s, b1s, acts, budget)
    got = world.results()
    for d in range(S):
        np.testing.assert_array_equal(got[d].view(np.uint32), ref[d].view(np.uint32), err_msg=f"destination {d}")
    assert any((g.view(np.uint32)[:, 2] == 0x7FC00123).any() for g in got)


def test_exchange_gradient_matches_jax(world):
    payloads, b0s, b1s, acts, budget = _case_near_capacity()
    cols = payloads[0].shape[1]
    weights = np.random.default_rng(3).standard_normal((S, S * budget, cols)).astype(np.float32)
    world.submit(ranks.exchange, payloads, b0s, b1s, acts, S, budget, weights=weights)
    ref = _jax_exchange(payloads, b0s, b1s, acts, budget, weights=weights)
    got = np.concatenate([r[1] for r in world.results()])
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("mode,bar", [("obb", 3e-5), ("aabb", 3e-5), ("2d", 3e-4)])
def test_bounded_render_matches_jax(world, mode, bar):
    # the budget from the planner; the bounded frame is the all-gather frame
    arrays = _scene()
    js = {"obb": bgs.CloudSettings(), "aabb": bgs.CloudSettings(aabb=True),
          "2d": bgs.CloudSettings(gaussian_mode=bgs.GaussianMode.GAUSSIAN_2D)}[mode]
    ts = {"obb": TSettings(), "aabb": TSettings(aabb=True), "2d": TSettings(gaussian_mode=TMode.GAUSSIAN_2D)}[mode]
    jc, tc = cameras(WIDTH, HEIGHT)
    _, budget, pairs = tpr.plan_exchange(torch_cloud(arrays), tc, ts, WIDTH, HEIGHT, S, with_pairs=True)
    world.submit(ranks.render, arrays, ts, (0.0, 0.0, 60.0), WIDTH, HEIGHT, exchange="bounded", band_budget=budget,
                 pairs_hint=pairs)
    mesh = jpr.make_mesh(S)
    ref = np.asarray(jpr.make_sharded_render(mesh, js, WIDTH, HEIGHT, exchange="bounded", band_budget=budget,
                                             pairs_hint=pairs)(jpr.shard_cloud(jax_cloud(arrays), mesh), jc))
    got = world.results()[0][0]
    np.testing.assert_allclose(got, ref, atol=bar)
    full = world.run(ranks.render, arrays, ts, (0.0, 0.0, 60.0), WIDTH, HEIGHT, pairs_hint=pairs)[0][0]
    np.testing.assert_array_equal(got, full)


def test_truncating_budget_still_renders(world):
    arrays = _scene()
    img = world.run(ranks.render, arrays, TSettings(), (0.0, 0.0, 60.0), WIDTH, HEIGHT, exchange="bounded",
                    band_budget=8)[0][0]
    assert np.isfinite(img).all() and (img[..., 3] > 0).any()


def test_multihost_mesh_layouts(world):
    out = world.run(ranks.multihost_meshes)
    assert out[0][:4] == [{"camera": 2, "tiles": 2}, {"camera": 4, "tiles": 1}, {"camera": 1, "tiles": 4},
                          "ValueError"]
    assert [o[4] for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    whole = np.arange(16).reshape(4, 4)
    for (c, t), o in zip([(0, 0), (0, 1), (1, 0), (1, 1)], out):
        np.testing.assert_array_equal(o[5], whole[2 * c : 2 * c + 2, 2 * t : 2 * t + 2])


def test_measured_work_ratio_runs(world):
    out = world.run(ranks.work_ratio, _scene(256), WIDTH, HEIGHT)
    assert out[0]["unit"] == "host s" and all(o == out[0] for o in out)
    assert out[0]["work_ratio"] > 0.0 and np.isfinite(out[0]["work_ratio"])


