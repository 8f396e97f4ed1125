"""PyTorch port, temporal 4DGS (``CloudSettings(gaussian_mode=GAUSSIAN_4D)``)
on the CPU against the JAX package, serving:

  - ``random_gaussians_4d_seeded`` bit-identical;
  - ``conditional_cov3d`` output by output (the marginal's mask
    array-equal) and the spherindrical colour lookup;
  - projection at times 0, 0.5 and 0.9 (the radix key, of the unshifted
    position, array-equal);
  - the port's oracle against the JAX oracle, and ``render_tiled`` (OBB and
    AABB) against JAX's ``render_tiled(compositor="pallas")``, within 2e-5
    (tests/test_pallas.py:41-47), also on the padded grid;
  - every rasterize mode beside COLOR in 4DGS (VELOCITY included) and the
    bounding-box overlay, ``render()`` against JAX's serving path
    (``differentiable=False``) and oracle against oracle;
  - ``playback_update`` in all four playback modes, and ``render()`` at
    ``settings.time`` with its budget key.

VELOCITY is a float32 finite difference of the delta mean over 1e-3 of time
(project.py:241-260), so an ulp of the delta mean moves the velocity by
about 1e3 ulps: its projected colour and its images are held to 1e-3
(measured: 0; both packages round each operation alike on the CPU, and the
delta mean is rounding noise in both, so every velocity is far below the
threshold and every opacity 0, see ``test_4d_mean_shift_is_rounding_noise``;
``pytest -s`` prints the errors).  Sizes are
test_pallas.py's 4DGS case (80 gaussians, seed 2, 64x64, time 0.5) and 128
gaussians at 128x120.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.models.settings import playback_update as j_playback
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops import sort as jsort
from bevy_gaussian_splatting_tpu.ops.gaussian_4d import conditional_cov3d as j_cond
from bevy_gaussian_splatting_tpu.ops.project import project_gaussians as jproject
from bevy_gaussian_splatting_tpu.ops.rasterize_ref import render_oracle as j_oracle
from bevy_gaussian_splatting_tpu.ops.sh import spherindrical_harmonics_lookup as j_sph
from bevy_gaussian_splatting_tpu_torch.models import cloud as tcloud
from bevy_gaussian_splatting_tpu_torch.models import settings as tsettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.ops.gaussian_4d import conditional_cov3d as t_cond
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians as tproject
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_ref import render_oracle as t_oracle
from bevy_gaussian_splatting_tpu_torch.ops.sh import spherindrical_harmonics_lookup as t_sph
from bevy_gaussian_splatting_tpu_torch.render import api
from torch_port_cases import cameras, jax_cloud, torch_cloud

IMAGE_BAR = 2e-5  # tests/test_pallas.py:41-47
VELOCITY_BAR = 1e-3
TIMES = (0.0, 0.5, 0.9)
# (n, seed, width, height): test_pallas.py's 4DGS case, the padded grid
CASES = [(80, 2, 64, 64), (128, 5, 128, 120)]
CASE_IDS = [f"4d{n}-{w}x{h}" for n, _, w, h in CASES]


@functools.lru_cache(maxsize=None)
def _arrays_cached(n: int, seed: int) -> dict:
    return tcloud.random_arrays_4d_seeded(n, seed)


def _arrays(n: int = 80, seed: int = 2) -> dict:
    return {k: v.copy() for k, v in _arrays_cached(n, seed).items()}


def _settings(time: float = 0.5, **kw):
    def build(pkg):
        out = {"gaussian_mode": pkg.GaussianMode.GAUSSIAN_4D, "time": time}
        for k, v in kw.items():
            out[k] = pkg.RasterizeMode[v] if k == "rasterize_mode" else v
        return pkg.CloudSettings(**out)

    return build(bgs), build(tsettings)


@pytest.mark.parametrize("n,seed", [(80, 2), (37, 9)])
def test_random_gaussians_4d_seeded_bit_identical(n, seed):
    j = bgs.random_gaussians_4d_seeded(n, seed=seed)
    t = tcloud.random_gaussians_4d_seeded(n, seed=seed, device="cpu")
    assert isinstance(t, tcloud.Gaussian4dCloud) and len(t) == len(j) == n
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name)), err_msg=f.name)
    for prop in ("rotation", "rotation_r", "scale", "opacity", "timestamp", "timescale", "position", "visibility"):
        np.testing.assert_array_equal(getattr(t, prop).numpy(), np.asarray(getattr(j, prop)), err_msg=prop)
    assert tcloud.SH_4D_COEFF_COUNT == bgs.models.cloud.SH_4D_COEFF_COUNT == 144


def test_4d_cloud_methods_match_jax():
    a = _arrays()
    j, t = jax_cloud(a), torch_cloud(a)
    vis = np.linspace(0.0, 2.0, 80).astype(np.float32)
    checks = [
        (t.with_visibility(torch.from_numpy(vis)), j.with_visibility(jnp.asarray(vis))),
        (t.astype(torch.float16), j.astype(jnp.float16)),
        (t.pad(), j.pad()),
        (t.to("cpu"), j),
    ]
    for got, ref in checks:
        assert type(got) is tcloud.Gaussian4dCloud
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(got, f.name).float().numpy(),
                                          np.asarray(getattr(ref, f.name)).astype(np.float32), err_msg=f.name)
    for got, ref in zip(t.compute_aabb(), j.compute_aabb()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("time", TIMES)
def test_conditional_cov3d_matches_jax(time):
    a = _arrays(128, 5)
    j4, t4 = jax_cloud(a), torch_cloud(a)
    ref = j_cond(j4.rotation, j4.rotation_r, j4.scale, j4.timescale, j4.timestamp, jnp.float32(time), 1.3)
    got = t_cond(t4.rotation, t4.rotation_r, t4.scale, t4.timescale, t4.timestamp,
                 torch.tensor(time, dtype=torch.float32), 1.3)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref["mask"]))
    assert 0 < int(np.asarray(ref["mask"]).sum()) < 128
    np.testing.assert_array_equal(got["dir_t"].numpy(), np.asarray(ref["dir_t"]))
    for k in ("cov3d", "delta_mean", "opacity_modifier"):
        r = np.asarray(ref[k])
        err = float(np.abs(got[k].numpy() - r).max())
        print(f"\n[t={time}] {k} |port - JAX| {err:.3e} of max {np.abs(r).max():.3e}")
        assert err <= 1e-6 * np.abs(r).max(), k


def test_spherindrical_lookup_matches_jax():
    rng = np.random.default_rng(4)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dir_t = rng.uniform(-1.0, 1.0, 200).astype(np.float32)
    sh = rng.uniform(-1.0, 1.0, (200, tcloud.SH_4D_COEFF_COUNT)).astype(np.float32)
    for duration in (1.0, 0.7):
        ref = np.asarray(j_sph(jnp.asarray(d), jnp.asarray(dir_t), jnp.asarray(sh), jnp.float32(duration)))
        got = t_sph(torch.from_numpy(d), torch.from_numpy(dir_t), torch.from_numpy(sh),
                    torch.tensor(duration, dtype=torch.float32)).numpy()
        # the same products summed in the same order; cos may differ by an ulp
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("time", TIMES)
@pytest.mark.parametrize("aabb", [False, True], ids=["obb", "aabb"])
def test_4d_projection_matches_jax(aabb, time):
    js_, ts_ = _settings(time, aabb=aabb)
    jc, tc = cameras(64, 64)
    a = _arrays()
    j = jproject(jax_cloud(a), jc, js_, time=jnp.float32(time))
    t = tproject(torch_cloud(a), tc, ts_)  # at settings.time
    m = np.asarray(j["mask"])
    np.testing.assert_array_equal(t["mask"].numpy(), m)
    assert 40 < m.sum() < 80
    key = jsort.radix_depth_key(jax_cloud(a).position, jnp.eye(4, dtype=jnp.float32),
                                jc.clip_from_view @ jc.view_from_world, jc.world_position, 32)
    np.testing.assert_array_equal(t["sort_key"].numpy(), np.asarray(key).astype(np.int64))
    names = ["center_ndc", "rgb", "alpha", "depth2", "cutoff"]
    names += ["conic", "radius_vp"] if aabb else ["obb_bounds", "obb_axis"]
    for k in names:
        ref = np.asarray(j[k])[m]
        got = t[k].numpy()[m]
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6 * np.abs(ref).max(), err_msg=k)


def _jax_tiled(arrays, jc, js_, bucket=None, differentiable=True):
    cloud = jax_cloud(arrays)
    if bucket is None:
        bucket = jrt.pairs_budget(len(cloud), int(jrt.pair_count(cloud, jc, js_)))
    return np.asarray(jrt.render_tiled(cloud, jc, js_, differentiable=differentiable, compositor="pallas",
                                       pairs_max=bucket))


@pytest.mark.parametrize("aabb", [False, True], ids=["obb", "aabb"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_4d_render_tiled_and_oracle_match_jax(case, aabb):
    n, seed, width, height = case
    a = _arrays(n, seed)
    js_, ts_ = _settings(0.5, aabb=aabb)
    jc, tc = cameras(width, height)
    ref = np.asarray(jrt.render_tiled(jax_cloud(a), jc, js_, compositor="pallas"))
    got = trt.render_tiled(torch_cloud(a), tc, ts_).detach().numpy()
    oracle_ref = np.asarray(j_oracle(jax_cloud(a), jc, js_))
    oracle = t_oracle(torch_cloud(a), tc, ts_).numpy()
    errs = float(np.abs(got - ref).max()), float(np.abs(oracle - oracle_ref).max())
    print(f"\n[{case}] render_tiled vs JAX pallas {errs[0]:.3e}, oracle vs JAX oracle {errs[1]:.3e}")
    assert got.shape == (height, width, 4) and max(errs) <= IMAGE_BAR
    assert (ref[..., 3] > 0.01).sum() > 0.04 * width * height


MODES = ["DEPTH", "NORMAL", "POSITION", "OPTICAL_FLOW", "CLASSIFICATION", "VELOCITY"]


def _mode_cameras(width, height):
    """Both packages' camera with a neighbouring eye's clip matrix as the
    previous one (the optical flow's camera part)."""
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera as TCamera

    prev = TCamera.create(eye=(1.5, -0.8, 58.0), width=width, height=height, device="cpu")
    prev_clip = (prev.clip_from_view @ prev.view_from_world).numpy()
    return (
        bgs.Camera.create(eye=(0.0, 0.0, 60.0), width=width, height=height, prev_clip_from_world=prev_clip),
        TCamera.create(eye=(0.0, 0.0, 60.0), width=width, height=height, prev_clip_from_world=prev_clip,
                       device="cpu"),
    )


@pytest.mark.parametrize("mode", MODES)
def test_4d_rasterize_modes_match_jax(mode):
    js_, ts_ = _settings(0.5, rasterize_mode=mode, num_classes=4)
    jc, tc = _mode_cameras(64, 64)
    a = _arrays()
    a["position_visibility"][:, 3] = np.random.default_rng(11).choice(
        np.array([0.0, 1.0, 2.0, 3.0, 4.0], np.float32), 80)
    bar = VELOCITY_BAR if mode == "VELOCITY" else IMAGE_BAR
    j = jproject(jax_cloud(a), jc, js_, time=jnp.float32(0.5))
    t = tproject(torch_cloud(a), tc, ts_)
    m = np.asarray(j["mask"])
    np.testing.assert_array_equal(t["mask"].numpy(), m)
    rgb_err = float(np.abs(t["rgb"].numpy()[m] - np.asarray(j["rgb"])[m]).max())
    np.testing.assert_array_equal(t["alpha"].numpy() == 0, np.asarray(j["alpha"]) == 0)
    ref = _jax_tiled(a, jc, js_, differentiable=False)
    api._BUDGET_STATE.clear()
    got = api.render(torch_cloud(a), tc, ts_, device="cpu").numpy()
    oracle_ref = np.asarray(j_oracle(jax_cloud(a), jc, js_))
    oracle = t_oracle(torch_cloud(a), tc, ts_).numpy()
    errs = float(np.abs(got - ref).max()), float(np.abs(oracle - oracle_ref).max())
    print(f"\n[{mode}] projection rgb {rgb_err:.3e}, render() vs JAX serving {errs[0]:.3e}, "
          f"oracle vs JAX oracle {errs[1]:.3e} (bar {bar})")
    assert rgb_err <= (VELOCITY_BAR if mode == "VELOCITY" else 1e-5)
    assert max(errs) <= bar
    if mode == "VELOCITY":
        # the JAX package's 4D covariance is M^T M with M = R diag(s), and R
        # (a product of two quaternion matrices) has orthogonal columns for
        # any quaternions: Sigma is diagonal, the mean shift is rounding
        # noise and every velocity is far below 1, so every opacity is 0
        assert not np.asarray(j["alpha"]).any() and not t["alpha"].any()
        assert not ref.any() and not got.any()
    else:
        assert (np.abs(ref[..., :3]).max(axis=-1) > 1.0 / 255.0).sum() > 100


def test_4d_mean_shift_is_rounding_noise():
    """The reason VELOCITY draws nothing: the conditional mean shift is
    zero but for rounding in both packages, also for quaternions that are
    not unit (training moves them off the unit sphere)."""
    a = _arrays(128, 5)
    a["isotropic_rotations"] *= np.random.default_rng(3).uniform(0.5, 2.0, (128, 8)).astype(np.float32)
    j4, t4 = jax_cloud(a), torch_cloud(a)
    ref = j_cond(j4.rotation, j4.rotation_r, j4.scale, j4.timescale, j4.timestamp, jnp.float32(0.9))
    got = t_cond(t4.rotation, t4.rotation_r, t4.scale, t4.timescale, t4.timestamp,
                 torch.tensor(0.9, dtype=torch.float32))
    np.testing.assert_array_equal(got["delta_mean"].numpy(), np.asarray(ref["delta_mean"]))
    assert np.abs(np.asarray(ref["delta_mean"])).max() < 1e-5
    cov = np.asarray(ref["cov3d"])
    assert np.abs(cov[:, [1, 2, 4]]).max() < 1e-6 * np.abs(cov).max()  # off-diagonal: noise


def test_4d_velocity_overlay_boxes_only_in_the_oracle():
    """VELOCITY zeroes every opacity here, so with the overlay the oracle
    boxes each gaussian in the mask and the tiled path none (the overlay's
    gating quirk, ROADMAP Queue 3): each port path held to its JAX
    counterpart."""
    js_, ts_ = _settings(0.5, rasterize_mode="VELOCITY", visualize_bounding_box=True)
    jc, tc = cameras(64, 64)
    a = _arrays()
    ref = _jax_tiled(a, jc, js_, differentiable=False)
    api._BUDGET_STATE.clear()
    got = api.render(torch_cloud(a), tc, ts_, device="cpu").numpy()
    oracle_ref = np.asarray(j_oracle(jax_cloud(a), jc, js_))
    oracle = t_oracle(torch_cloud(a), tc, ts_).numpy()
    assert float(np.abs(got - ref).max()) <= IMAGE_BAR and float(np.abs(oracle - oracle_ref).max()) <= IMAGE_BAR
    differ = int((np.abs(oracle - got).max(axis=-1) > 1e-3).sum())
    print(f"\n[velocity overlay] pixels where the oracle and the tiled path differ by > 1e-3: {differ} of 4096")
    assert not got.any() and differ > 100


@pytest.mark.parametrize("aabb", [False, True], ids=["obb", "aabb"])
def test_4d_overlay_matches_jax(aabb):
    js_, ts_ = _settings(0.5, aabb=aabb, visualize_bounding_box=True)
    jc, tc = cameras(64, 64)
    a = _arrays()
    ref = _jax_tiled(a, jc, js_, differentiable=False)
    api._BUDGET_STATE.clear()
    got = api.render(torch_cloud(a), tc, ts_, device="cpu").numpy()
    oracle_ref = np.asarray(j_oracle(jax_cloud(a), jc, js_))
    oracle = t_oracle(torch_cloud(a), tc, ts_).numpy()
    errs = float(np.abs(got - ref).max()), float(np.abs(oracle - oracle_ref).max())
    print(f"\n[overlay {'aabb' if aabb else 'obb'}] render() vs JAX serving {errs[0]:.3e}, oracle {errs[1]:.3e}")
    assert max(errs) <= IMAGE_BAR
    green = (np.abs(got[..., :3] - np.array([0.3, 1.0, 0.1], np.float32)).max(axis=-1) < 1e-6).sum()
    assert green > 50


PLAYBACK = [
    ("STILL", {}), ("ONCE", {}), ("ONCE", {"time": 1.0}), ("LOOP", {}), ("LOOP", {"time": 0.99}),
    ("SIN", {}), ("LOOP", {"time_scale": 0.0}), ("SIN", {"time_scale": 2.5, "time_start": 0.2, "time_stop": 0.8}),
]


@pytest.mark.parametrize("mode,kw", PLAYBACK, ids=[f"{m}-{'-'.join(k)}" if k else m for m, k in PLAYBACK])
def test_playback_update_matches_jax(mode, kw):
    base = {"time": 0.3, **kw}
    js_ = bgs.CloudSettings(playback_mode=bgs.PlaybackMode[mode], **base)
    ts_ = tsettings.CloudSettings(playback_mode=tsettings.PlaybackMode[mode], **base)
    for delta, elapsed in ((1.0 / 60.0, 0.37), (0.05, 2.2), (0.3, 5.0)):
        js_ = j_playback(js_, delta, elapsed)
        ts_ = tsettings.playback_update(ts_, delta, elapsed)
        assert ts_.time == js_.time
    if mode == "LOOP" and kw.get("time") == 0.99:
        assert ts_.time < 0.99  # wrapped to time_start
    if mode == "STILL" or kw.get("time_scale") == 0.0:
        assert ts_.time == base["time"]


def test_render_takes_settings_time_and_keys_budget_by_class():
    a = _arrays()
    _, tc = cameras(64, 64)
    cloud = torch_cloud(a)
    api._BUDGET_STATE.clear()
    images = {}
    for time in (0.25, 0.75):
        _, ts_ = _settings(time)
        images[time] = api.render(cloud, tc, ts_, device="cpu")
        np.testing.assert_array_equal(
            images[time].numpy(), trt.render_tiled(cloud, tc, ts_, differentiable=False, time=time,
                                                   pairs_max=api._BUDGET_STATE[api.budget_key(
                                                       "auto", ts_, 64, 64, cloud, "cpu")][0]).numpy())
    assert float((images[0.25] - images[0.75]).abs().max()) > 0.1  # time changes the image
    # a time tensor renders as the number does
    _, ts_ = _settings(0.25)
    np.testing.assert_array_equal(
        trt.render_tiled(cloud, tc, ts_, time=torch.tensor(0.25)).detach().numpy(),
        trt.render_tiled(cloud, tc, ts_).detach().numpy())
    # the cloud's class is in the key: a 3D cloud and its precomputed-
    # covariance twin of one size render with the same settings and never
    # share a bucket, nor does a 4D cloud
    three = tcloud.random_gaussians_3d_seeded(80, seed=2, device="cpu")
    api.render(three, tc, device="cpu")
    api.render(tcloud.precompute_covariance_3d(three), tc, device="cpu")
    assert sorted(k[5] for k in api._BUDGET_STATE) == ["Gaussian3dCloud", "Gaussian3dCovCloud", "Gaussian4dCloud"]
    assert len({k[1] for k in api._BUDGET_STATE}) == 2
