"""The port's query/ (select, sparse, raycast), morph/ (interpolate,
particle) and ops/noise.py against the JAX package's, on inputs drawn from a
seed: selections and outlier sets equal, point-in-mesh parity array-equal,
interpolation and ten particle steps within 1e-6, the lattice hash bit-equal
(negative lattice coordinates included), the noise within 1e-6 and the
noised SH within 1e-5 (``ROADMAP.md``'s bars for this slice).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
import torch_port_cases as cases
from bevy_gaussian_splatting_tpu.io import gcloud as jgc
from bevy_gaussian_splatting_tpu.morph import interpolate as jinterp
from bevy_gaussian_splatting_tpu.morph import particle as jparticle
from bevy_gaussian_splatting_tpu.ops import noise as jnoise
from bevy_gaussian_splatting_tpu.query import raycast as jraycast
from bevy_gaussian_splatting_tpu.query import select as jselect
from bevy_gaussian_splatting_tpu.query import sparse as jsparse
from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, cloud_to_numpy, random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.morph import interpolate as tinterp
from bevy_gaussian_splatting_tpu_torch.morph import particle as tparticle
from bevy_gaussian_splatting_tpu_torch.ops import noise as tnoise
from bevy_gaussian_splatting_tpu_torch.query import raycast as traycast
from bevy_gaussian_splatting_tpu_torch.query import select as tselect
from bevy_gaussian_splatting_tpu_torch.query import sparse as tsparse

MORPH_BAR = 1e-6
NOISE_BAR = 1e-6
NOISE_SH_BAR = 1e-5


def jax_arrays(cloud) -> dict:
    return {f.name: np.asarray(getattr(cloud, f.name)) for f in dataclasses.fields(cloud)}


def pair(arrays):
    return cases.jax_cloud(arrays), cloud_from_numpy(arrays, "cpu")


# ---------------------------------------------------------------------------
# query/
# ---------------------------------------------------------------------------


def test_selection_matches_jax(tmp_path):
    """apply / invert / back from visibility / extract / save, as JAX."""
    jc, tc = pair(random_arrays_3d_seeded(64, seed=1))
    idx = [1, 3, 5, 40, 63]
    jsel, tsel = jselect.Select(idx), tselect.Select(idx)
    np.testing.assert_array_equal(tsel.invert(64).indices, jsel.invert(64).indices)
    np.testing.assert_array_equal(tsel.to_visibility(64, device="cpu").numpy(), np.asarray(jsel.to_visibility(64)))
    japplied, tapplied = jselect.apply_selection(jc, jsel), tselect.apply_selection(tc, tsel)
    np.testing.assert_array_equal(cloud_to_numpy(tapplied)["position_visibility"],
                                  np.asarray(japplied.position_visibility))
    np.testing.assert_array_equal(tselect.selection_from_visibility(tapplied).indices, idx)
    sub = tselect.extract_selection(tc, tsel)
    for k, v in jax_arrays(jselect.extract_selection(jc, jsel)).items():
        np.testing.assert_array_equal(cloud_to_numpy(sub)[k], v, err_msg=k)
    path = str(tmp_path / "live_output.gcloud")
    assert tselect.save_selection(tc, tsel, path) > 0
    with open(path, "rb") as f:
        saved = jgc.decode_gcloud_3d(f.read(), use_native=False)
    for k, v in jax_arrays(saved).items():
        np.testing.assert_array_equal(cloud_to_numpy(sub)[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["cluster", "random"])
def test_sparse_select_and_remove_outliers_match_jax(case):
    rng = np.random.default_rng(3)
    if case == "cluster":  # tests/test_morph_query.py's dense cluster and two far outliers
        pos = np.concatenate([rng.normal(0, 0.01, (100, 3)), [[5.0, 5.0, 5.0], [-5.0, -5.0, -5.0]]])
    else:
        pos = rng.uniform(-1.0, 1.0, (2048, 3))
    a = random_arrays_3d_seeded(len(pos), seed=4)
    a["position_visibility"][:, :3] = pos.astype(np.float32)
    jc, tc = pair(a)
    for radius, threshold in ((0.05, 3), (0.2, 5)):
        want = jsparse.sparse_select(jc, radius, threshold).indices
        np.testing.assert_array_equal(tsparse.sparse_select(tc, radius, threshold).indices, want)
        kept = tsparse.remove_outliers(tc, radius, threshold)
        for k, v in jax_arrays(jsparse.remove_outliers(jc, radius, threshold)).items():
            np.testing.assert_array_equal(cloud_to_numpy(kept)[k], v, err_msg=k)
    if case == "cluster":
        np.testing.assert_array_equal(tsparse.sparse_select(tc).indices, [100, 101])


CUBE_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                  np.float32)
CUBE_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                   [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]], np.int32)


@pytest.mark.parametrize("transformed", [False, True], ids=["unit-cube", "moved-mesh"])
def test_points_in_mesh_matches_jax(transformed):
    """The unit cube of ``tests/test_morph_query.py:150-190`` (its points, and
    2,048 drawn ones), as it is and under a mesh transform."""
    rng = np.random.default_rng(7)
    mt = None
    pts = [[0.5, 0.3, 0.7], [1.5, 0.3, 0.7], [-0.1, 0.3, 0.7], [0.9, 0.2, 0.6]]
    want_fixed = [True, False, False, True]
    drawn = rng.uniform(-0.5, 1.5, (2048, 3))
    if transformed:
        t = np.eye(4, dtype=np.float32)
        t[:3, :3] = np.array([[0.0, -2.0, 0.0], [2.0, 0.0, 0.0], [0.0, 0.0, 2.0]], np.float32)
        t[:3, 3] = [10.0, 1.0, -3.0]
        mt = t
        pts = (np.asarray(pts) @ t[:3, :3].T + t[:3, 3]).tolist()
        drawn = drawn @ t[:3, :3].T + t[:3, 3]
    pts = np.concatenate([np.asarray(pts), drawn]).astype(np.float32)
    want = np.asarray(jraycast.points_in_mesh(jnp.asarray(pts), jnp.asarray(CUBE_V), jnp.asarray(CUBE_F),
                                              None if mt is None else jnp.asarray(mt)))
    got = traycast.points_in_mesh(torch.from_numpy(pts), CUBE_V, CUBE_F, None if mt is None else torch.from_numpy(mt))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:4], want_fixed)
    assert 0 < want.sum() < len(want)
    a = random_arrays_3d_seeded(len(pts), seed=2)
    a["position_visibility"][:, :3] = pts
    jc, tc = pair(a)
    np.testing.assert_array_equal(traycast.select_in_mesh(tc, CUBE_V, CUBE_F, mt).indices,
                                  jraycast.select_in_mesh(jc, CUBE_V, CUBE_F, None if mt is None else jnp.asarray(mt)).indices)


# ---------------------------------------------------------------------------
# morph/
# ---------------------------------------------------------------------------

FACTOR_CASES = [(0.5, 0.0, 1.0), (-1.0, 0.0, 1.0), (2.0, 0.0, 1.0), (1.0, 1.0, 1.0), (0.5, 1.0, 1.0),
                (0.3, 0.1, 0.7), (0.123456, -2.0, 3.5)]


def test_interpolation_matches_jax():
    """interpolation_factor (the degenerate duration included),
    interpolate_clouds at several times with zero quaternions on both sides,
    interpolate_for_settings; the size check."""
    for case in FACTOR_CASES:
        assert tinterp.interpolation_factor(*case) == float(jinterp.interpolation_factor(*case)), case
    a, b = random_arrays_3d_seeded(512, seed=1), random_arrays_3d_seeded(512, seed=2)
    a["rotation"][:4] = 0.0
    b["rotation"][2:6] = 0.0  # rows 2, 3: zero on both sides -> the (0, 0, 0, 1) fallback
    (ja, ta), (jb, tb) = pair(a), pair(b)
    for time, start, stop in ((0.0, 0.0, 1.0), (0.37, 0.0, 1.0), (1.0, 0.0, 1.0), (0.6, 0.2, 0.9)):
        want = jax_arrays(jinterp.interpolate_clouds(ja, jb, time, start, stop))
        got = cloud_to_numpy(tinterp.interpolate_clouds(ta, tb, time, start, stop))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=MORPH_BAR, rtol=0, err_msg=f"{k} t={time}")
    np.testing.assert_array_equal(cloud_to_numpy(tinterp.interpolate_clouds(ta, tb, 0.5))["rotation"][2:4],
                                  [[0, 0, 0, 1], [0, 0, 0, 1]])
    settings = CloudSettings(time=0.25, time_start=0.0, time_stop=0.5)
    got = cloud_to_numpy(tinterp.interpolate_for_settings(ta, tb, settings))
    want = jax_arrays(jinterp.interpolate_for_settings(
        ja, jb, bgs.CloudSettings(time=0.25, time_start=0.0, time_stop=0.5)))
    np.testing.assert_allclose(got["position_visibility"], want["position_visibility"], atol=MORPH_BAR, rtol=0)
    with pytest.raises(ValueError):
        tinterp.interpolate_clouds(ta, cloud_from_numpy(random_arrays_3d_seeded(16, seed=3), "cpu"), 0.5)


def test_particle_steps_match_jax():
    """ParticleBehaviors.random draws as JAX's; ten steps with duplicate and
    negative indices within 1e-6 (positions, velocities, accelerations)."""
    n, b = 256, 320
    jc, tc = pair(random_arrays_3d_seeded(n, seed=5))
    jb, tb = jparticle.ParticleBehaviors.random(b, seed=9), tparticle.ParticleBehaviors.random(b, seed=9, device="cpu")
    for name in ("velocity", "acceleration", "jerk"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    idx = np.arange(b, dtype=np.int32) % n  # rows 0..63 driven twice
    idx[::17] = -1  # inert
    idx[5] = idx[6] = 7  # a third behaviour on row 7
    jb = dataclasses.replace(jb, indices=jnp.asarray(idx))
    tb = dataclasses.replace(tb, indices=torch.from_numpy(idx))
    for _ in range(10):
        jc, jb = jparticle.apply_particle_behaviors(jc, jb, 1.0 / 30.0)
        tc, tb = tparticle.apply_particle_behaviors(tc, tb, 1.0 / 30.0)
    np.testing.assert_allclose(cloud_to_numpy(tc)["position_visibility"], np.asarray(jc.position_visibility),
                               atol=MORPH_BAR, rtol=0)
    for name in ("velocity", "acceleration", "jerk"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), atol=MORPH_BAR,
                                   rtol=0, err_msg=name)
    inert = idx < 0
    np.testing.assert_array_equal(tb.velocity.numpy()[inert], tparticle.ParticleBehaviors.random(
        b, seed=9, device="cpu").velocity.numpy()[inert])


# ---------------------------------------------------------------------------
# ops/noise.py
# ---------------------------------------------------------------------------


def test_hash4_is_bit_equal():
    """uint32 wrap-around arithmetic in int64, negative and large lattice
    coordinates included, for several seeds."""
    rng = np.random.default_rng(11)
    lattice = rng.integers(-(2 ** 31), 2 ** 31 - 1, (4, 4096), dtype=np.int64).astype(np.int32)
    lattice[:, :64] = rng.integers(-3, 3, (4, 64))
    for seed in (0, 5, 2 ** 32 - 1):
        want = np.asarray(jnoise._hash4(*(jnp.asarray(c) for c in lattice), seed))
        got = tnoise._hash4(*(torch.from_numpy(c) for c in lattice), seed).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)
        assert got.min() >= 0 and got.max() < 2 ** 32


@pytest.fixture(scope="module")
def noise_inputs():
    rng = np.random.default_rng(1234)
    return rng.uniform(-5, 5, 1000).astype(np.float32)


def test_noise_matches_jax(noise_inputs):
    """gradient_noise_4d and ridged_multi_4d within 1e-6, on coordinates
    either side of 0 (negative lattice cells)."""
    x = noise_inputs
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jnoise.gradient_noise_4d(jx, jx * 0.7, jx * 1.3, jnp.full_like(jx, -0.5), seed=3))
    got = tnoise.gradient_noise_4d(tx, tx * 0.7, tx * 1.3, torch.full_like(tx, -0.5), seed=3).numpy()
    np.testing.assert_allclose(got, want, atol=NOISE_BAR, rtol=0)
    want = np.asarray(jnoise.ridged_multi_4d(jx, jx * 0.7, jx * 1.3, jnp.zeros_like(jx)))
    got = tnoise.ridged_multi_4d(tx, tx * 0.7, tx * 1.3, torch.zeros_like(tx)).numpy()
    np.testing.assert_allclose(got, want, atol=NOISE_BAR, rtol=0)
    assert np.isfinite(got).all() and got.std() > 0.01


@pytest.mark.parametrize("scale,seed", [(2.0, 0), (0.37, 4)])
def test_apply_noise_matches_jax(scale, seed):
    """Every SH coefficient rewritten from the position (the test model's
    duplicated corner keeps its twin's SH), within 1e-5 of JAX."""
    a = cases.cloud_arrays("bench", 256, seed=6)
    jc, tc = pair(a)
    want = np.asarray(jnoise.apply_noise(jc, scale=scale, seed=seed).spherical_harmonic)
    got = tnoise.apply_noise(tc, scale=scale, seed=seed)
    assert got.spherical_harmonic.shape == tc.spherical_harmonic.shape
    np.testing.assert_allclose(got.spherical_harmonic.numpy(), want, atol=NOISE_SH_BAR, rtol=0)
    np.testing.assert_array_equal(got.position_visibility.numpy(), a["position_visibility"])
    model = tnoise.apply_noise(cloud_from_numpy(jax_arrays(bgs.test_model_3d(seed=1)), "cpu"), scale=scale)
    sh = model.spherical_harmonic.numpy()
    np.testing.assert_array_equal(sh[0], sh[8])
    assert not np.allclose(sh[0], sh[1])
