"""PyTorch port, sharded rendering and training (parallel/render.py) on a
gloo world of 4 spawned ranks, against the JAX package's sharded path on
``make_mesh(4)`` of the conftest's CPU devices with its XLA compositor
(JAX's own tests tie that compositor to the Pallas one).

One world serves every case of the file, so that the ranks' ``import
torch`` is paid once; the ranks meet through a file under the test's
temporary directory.  Each case submits its rank-side work first
(tests/torch_parallel_ranks.py) and builds the JAX side while the ranks
run.  Bars are the JAX package's own (tests/test_parallel.py): images 3e-5
(2DGS 3e-4), gradients 1e-3 of each field's
largest magnitude.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import bevy_gaussian_splatting_tpu as bgs
import torch_parallel_ranks as ranks
from bevy_gaussian_splatting_tpu.parallel import render as jpr
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.models.settings import GaussianMode as TMode
from bevy_gaussian_splatting_tpu_torch.parallel.distributed import World
from torch_port_cases import jax_cloud

W = H = 128
EYE = (0.0, 0.0, 60.0)
N_RANKS = 4
FIELDS = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    address = "file://" + str(tmp_path_factory.mktemp("world") / "rendezvous")
    with World(N_RANKS, "gloo", address, timeout_s=120.0) as w:
        yield w


def _settings(mode: str):
    if mode == "obb":
        return bgs.CloudSettings(), TSettings()
    if mode == "aabb":
        return bgs.CloudSettings(aabb=True), TSettings(aabb=True)
    return (bgs.CloudSettings(gaussian_mode=bgs.GaussianMode.GAUSSIAN_2D),
            TSettings(gaussian_mode=TMode.GAUSSIAN_2D))


def _jax_camera(eye=EYE, width=W, height=H):
    return bgs.Camera.create(eye=eye, target=(0.0, 0.0, 0.0), width=width, height=height)


def _port_frame(arrays, settings):
    """The port's one-device frame of the padded cloud (a training target)."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, pad_cloud
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled

    cloud = pad_cloud(cloud_from_numpy(arrays, "cpu"), 256)
    return render_tiled(cloud, ranks.camera(EYE, W, H), settings, differentiable=False).numpy()


def _jax_render(arrays, settings, time=0.0, **kw):
    mesh = jpr.make_mesh(N_RANKS)
    fn = jpr.make_sharded_render(mesh, settings, W, H, **kw)
    return np.asarray(fn(jpr.shard_cloud(jax_cloud(arrays), mesh), _jax_camera(), time=time))


@pytest.mark.parametrize("mode,bar", [("obb", 3e-5), ("aabb", 3e-5), ("2d", 3e-4)])
def test_sharded_render_matches_jax(world, mode, bar):
    arrays = random_arrays_3d_seeded(300, seed=1)
    js, ts = _settings(mode)
    world.submit(ranks.render, arrays, ts, EYE, W, H)
    ref = _jax_render(arrays, js)
    got = world.results()[0][0]
    assert got.shape == (H, W, 4)
    np.testing.assert_allclose(got, ref, atol=bar)
    assert (got[..., 3] > 0).mean() > 0.05  # the frame is lit


def _jax_grads(arrays, settings, target):
    """The JAX package's sharded gradient of the band-local squared error
    (tests/test_parallel.py:208-267), cloud-shaped, padded rows included."""
    from jax import shard_map

    mesh = jpr.make_mesh(N_RANKS)
    cam = _jax_camera()

    @partial(shard_map, mesh=mesh, in_specs=(P(jpr.TILES_AXIS), P(jpr.TILES_AXIS)), out_specs=P(jpr.TILES_AXIS),
             check_vma=False)
    def grads_fn(cloud_shard, target_band):
        def local_loss(shard):
            img_band = jpr._local_band_render(shard, cam, settings, jnp.eye(4), jnp.zeros(4), jnp.float32(0.0),
                                              W, H, N_RANKS)
            return jnp.sum((img_band - target_band) ** 2) / (H * W * 4)

        return jax.grad(local_loss)(cloud_shard)

    return jax.jit(grads_fn)(jpr.shard_cloud(jax_cloud(arrays), mesh), jnp.asarray(target))


@pytest.mark.parametrize("mode", ["obb", "aabb"])
def test_sharded_grads_match_jax(world, mode):
    arrays = random_arrays_3d_seeded(200, seed=2)
    js, ts = _settings(mode)
    target = _port_frame(arrays, ts) * 0.9
    world.submit(ranks.train, arrays, ts, EYE, W, H, target)
    g_jax = _jax_grads(arrays, js, target)
    out = world.results()
    n = len(arrays["position_visibility"])
    for f in FIELDS:
        # the padded rows carry NaN in JAX (opacity 0, no SH direction)
        a = np.asarray(getattr(g_jax, f))[:n]
        b = np.concatenate([r[1][f] for r in out])[:n]
        scale = np.abs(a).max()
        assert scale > 0, f
        np.testing.assert_allclose(b, a, atol=1e-3 * scale, err_msg=f)
        print(f"{mode} {f}: max |port - jax| / max |jax| = {np.abs(b - a).max() / scale:.3e}")


def test_sharded_train_loss_falls(world):
    # the JAX test's protocol (tests/test_parallel.py:168-190), 3 steps
    arrays = random_arrays_3d_seeded(120, seed=7)
    _, ts = _settings("aabb")
    target = _port_frame(arrays, ts)
    start = dict(arrays)
    start["position_visibility"] = arrays["position_visibility"] + np.array([0.5, 0.0, 0.0, 0.0], np.float32)
    losses = world.run(ranks.train, start, ts, EYE, W, H, target, steps=3, lr=5e-3)[0][0]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_sharded_train_skips_nonfinite(world):
    # optax.apply_if_finite's semantics (tests/test_parallel.py:335): a
    # poisoned position makes the gradients non-finite on some rank; the
    # step is skipped on every rank, so no parameter moves
    arrays = random_arrays_3d_seeded(64, seed=0)
    _, ts = _settings("obb")
    target = _port_frame(arrays, ts)
    bad = dict(arrays)
    bad["position_visibility"] = arrays["position_visibility"].copy()
    bad["position_visibility"][0, 0] = np.nan
    out = world.run(ranks.train, bad, ts, EYE, W, H, target, steps=1, lr=1e-2, skip_nonfinite=3)
    finite = [all(np.isfinite(g).all() for g in r[1].values() if g is not None) for r in out]
    assert not all(finite)  # some rank saw a non-finite gradient
    start = np.concatenate([bad["rotation"], np.tile([1.0, 0.0, 0.0, 0.0], (256 - 64, 1)).astype(np.float32)])
    np.testing.assert_array_equal(np.concatenate([r[2]["rotation"] for r in out]), start)
    assert all(r[3] == (1, 1, False) for r in out)
    # without the guard the same step moves every rank's rotations
    out = world.run(ranks.train, bad, ts, EYE, W, H, target, steps=1, lr=1e-2)
    assert not np.array_equal(np.concatenate([r[2]["rotation"] for r in out]), start)


def test_sharded_render_deterministic(world):
    arrays = random_arrays_3d_seeded(200, seed=2)
    frames = world.run(ranks.render, arrays, TSettings(), EYE, W, H, repeat=2)[0]
    np.testing.assert_array_equal(frames[0], frames[1])


def test_mesh_layout(world):
    expect = [({"tiles": 4}, {"camera": 2, "tiles": 2}, r // 2, r % 2) for r in range(N_RANKS)]
    assert world.run(ranks.mesh_shapes) == expect
