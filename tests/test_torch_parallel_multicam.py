"""PyTorch port, camera-parallel and pixel-parallel rendering and training
(parallel/render.py ``make_sharded_render_multicam``,
``make_train_step_multicam``) on a gloo world of 4 spawned ranks as a
(camera 2, tiles 2) mesh, against the JAX package's on ``make_mesh(4,
camera_parallel=2)`` of the conftest's CPU devices (tests/test_parallel.py:98-162's
bars: images 3e-5, parameters after one Adam step 2e-4, loss 1e-5
relative; the step's gradients within 1e-3 of each field's largest); the
sharded 4DGS frame at time 0.4 on the 4-rank tiles mesh
(tests/test_parallel.py:71-93's bars); and the 4-rank multi-host dry run
(parallel/distributed.py, 2 hosts x 2 ranks) in processes of its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import bevy_gaussian_splatting_tpu as bgs
import torch_parallel_ranks as ranks
from bevy_gaussian_splatting_tpu.parallel import render as jpr
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded, random_arrays_4d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.models.settings import GaussianMode as TMode
from bevy_gaussian_splatting_tpu_torch.parallel.distributed import World, spawn_multihost_dryrun
from torch_port_cases import jax_cloud

N_RANKS = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    address = "file://" + str(tmp_path_factory.mktemp("world") / "rendezvous")
    with World(N_RANKS, "gloo", address, timeout_s=120.0) as w:
        yield w


def _jax_camera(eye, width, height):
    return bgs.Camera.create(eye=eye, target=(0.0, 0.0, 0.0), width=width, height=height)


@pytest.mark.parametrize("exchange", ["allgather", "bounded"])
def test_sharded_4dgs_temporal(world, exchange):
    # the JAX test's bars (tests/test_parallel.py:71-93): an OBB axis of a
    # near-isotropic 4D splat is decided by rounding, so a few quad-edge
    # pixels may flip between two programs
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.parallel.render import plan_exchange

    arrays = random_arrays_4d_seeded(300, seed=4)
    js = bgs.CloudSettings(gaussian_mode=bgs.GaussianMode.GAUSSIAN_4D, time=0.4)
    ts = TSettings(gaussian_mode=TMode.GAUSSIAN_4D, time=0.4)
    eye = (0.0, 0.0, 60.0)
    budget = None
    if exchange == "bounded":
        _, budget = plan_exchange(cloud_from_numpy(arrays, "cpu"), ranks.camera(eye, 128, 128), ts, 128, 128,
                                  N_RANKS, time=0.4)
    world.submit(ranks.render, arrays, ts, eye, 128, 128, exchange=exchange, band_budget=budget, time=0.4)
    mesh = jpr.make_mesh(N_RANKS)
    fn = jpr.make_sharded_render(mesh, js, 128, 128, exchange=exchange, band_budget=budget)
    ref = np.asarray(fn(jpr.shard_cloud(jax_cloud(arrays), mesh), _jax_camera(eye, 128, 128), time=0.4))
    got = world.results()[0][0]
    diff = np.abs(got - ref)
    assert np.isfinite(got).all()
    assert (diff > 3e-5).mean() < 0.01, (diff > 3e-5).mean()
    assert diff.max() < 0.1, diff.max()


MC_EYES = ((0.0, 0.0, 60.0), (30.0, 10.0, 50.0))


def test_multicam_render_and_step_match_jax(world):
    # (camera 2, tiles 2): tests/test_parallel.py:98-162 against the JAX
    # package's own multi-camera sharded render and train step
    from bevy_gaussian_splatting_tpu.render.multi_camera import stack_cameras

    arrays = random_arrays_3d_seeded(300, seed=5)
    world.submit(ranks.multicam, arrays, TSettings(), MC_EYES, 64, 64)
    mesh2d = jpr.make_mesh(N_RANKS, camera_parallel=2)
    cams = stack_cameras([_jax_camera(e, 64, 64) for e in MC_EYES])
    sharded = jpr.shard_cloud(jax_cloud(arrays), mesh2d)
    ref = np.asarray(jpr.make_sharded_render_multicam(mesh2d, bgs.CloudSettings(), 64, 64)(sharded, cams))
    got = world.results()[0]
    assert got.shape == (2, 64, 64, 4)
    np.testing.assert_allclose(got, ref, atol=3e-5)

    targets = ref * 0.9
    world.submit(ranks.multicam, arrays, TSettings(), MC_EYES, 64, 64, targets=targets)
    step, init = jpr.make_train_step_multicam(mesh2d, bgs.CloudSettings(), 64, 64, learning_rate=1e-3)
    c_jax, opt_jax, loss_jax = step(sharded, init(sharded), cams, jnp.asarray(targets))
    out = world.results()
    # camera row 0 holds ranks 0 and 1, the two tiles shards; row 1 the same rows
    np.testing.assert_allclose(out[0][0], float(loss_jax), rtol=1e-5)
    n = len(arrays["position_visibility"])
    for f in ("position_visibility", "scale_opacity", "spherical_harmonic"):
        got_f = np.concatenate([out[0][1][f], out[1][1][f]])
        np.testing.assert_array_equal(got_f, np.concatenate([out[2][1][f], out[3][1][f]]), err_msg=f)
        # JAX's padded rows turn NaN (their gradients are NaN): compare the cloud's rows
        np.testing.assert_allclose(got_f[:n], np.asarray(getattr(c_jax, f))[:n], atol=2e-4, err_msg=f)
    # Adam's first step moves each parameter by about lr * sign(g): the
    # parameters alone cannot see the gradient's size.  Hold the gradients,
    # summed over the camera axis and normalised by every view, to JAX's:
    # optax's first moment after one step is (1 - b1) * g, b1 = 0.9.
    mu = opt_jax[0].mu
    for f in ("position_visibility", "scale_opacity", "spherical_harmonic", "rotation"):
        g_jax = np.asarray(getattr(mu, f))[:n] / np.float32(0.1)
        g_got = np.concatenate([out[0][2][f], out[1][2][f]])
        np.testing.assert_array_equal(g_got, np.concatenate([out[2][2][f], out[3][2][f]]), err_msg=f)
        scale = np.abs(g_jax).max()
        assert scale > 0, f
        np.testing.assert_allclose(g_got[:n], g_jax, atol=1e-3 * scale, err_msg=f)


def test_spawned_multihost_dryrun(tmp_path):
    # 4 ranks as 2 hosts x 2 (JAX: 2 processes x 2 devices), bounded exchange
    msg = spawn_multihost_dryrun(world_size=4, ranks_per_host=2, exchange="bounded",
                                 address="file://" + str(tmp_path / "rendezvous"), device="cpu")
    assert "multihost dryrun OK" in msg
    assert "'camera': 2" in msg and "'tiles': 2" in msg
