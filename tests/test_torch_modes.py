"""PyTorch port, the rasterize, draw and sort modes on the CPU against the JAX
package: RasterizeMode DEPTH, NORMAL, POSITION, OPTICAL_FLOW and
CLASSIFICATION, DrawMode SELECTED and HIGHLIGHT_SELECTED, SortMode STD and
RAYON (VELOCITY needs 4DGS, which the port does not have yet).

  - each ``ops/color.py`` function against the JAX package's, on inputs that
    include the hue sector boundaries (1e-6);
  - projection's colour, alpha and mask in each mode against
    ``project_gaussians``;
  - ``render()`` against ``render_tiled(compositor="pallas",
    differentiable=False)`` and the port's oracle against the JAX oracle in
    each mode (2e-5), and the STD and RAYON oracles;
  - ``back_sorted_entry_indices`` (the DEPTH ramp's min/max quirk)
    array-equal to the JAX package's, with tied keys and culled entries;
  - NORMAL-mode gradients of every cloud field against ``jax.grad`` of the
    Pallas training path (3e-3 of the field's largest magnitude): the mode
    adds a colour path through rotation and scale.

The cloud is test_pallas.py's 400 wide gaussians with visibilities spread
over [0, 5] (the draw modes select at 0.5, classes start at 2).  The
OPTICAL_FLOW camera carries the clip matrix of a neighbouring eye as its
previous one.  ``pytest -s`` prints the measured errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import color as jcolor
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops.project import project_gaussians as jproject
from bevy_gaussian_splatting_tpu.ops.rasterize_ref import render_oracle as j_oracle
from bevy_gaussian_splatting_tpu_torch.models import settings as tsettings
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera as TCamera
from bevy_gaussian_splatting_tpu_torch.ops import color as tcolor
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.ops import sort as tsort
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians as tproject
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_ref import render_oracle as t_oracle
from bevy_gaussian_splatting_tpu_torch.render import api
from bevy_gaussian_splatting_tpu_torch.train.losses import mse
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud
from torch_port_cases import EYE, cloud_arrays, jax_cloud, torch_cloud

IMAGE_BAR = 2e-5
GRAD_BAR = 3e-3
BG = np.array([0.2, 0.1, 0.4, 1.0], np.float32)
TAU = 6.283185307179586

# (name, settings keywords); the same keywords build both packages' settings
MODES = [
    ("depth", {"rasterize_mode": "DEPTH"}),
    ("normal", {"rasterize_mode": "NORMAL"}),
    ("position", {"rasterize_mode": "POSITION"}),
    ("optical_flow", {"rasterize_mode": "OPTICAL_FLOW"}),
    ("classification", {"rasterize_mode": "CLASSIFICATION", "num_classes": 4}),
    ("selected", {"draw_mode": "SELECTED"}),
    ("highlight_selected", {"draw_mode": "HIGHLIGHT_SELECTED"}),
]
MODE_IDS = [m for m, _ in MODES]


def _settings(kw: dict, **extra):
    def build(pkg):
        out = dict(extra)
        for k, v in kw.items():
            if k == "rasterize_mode":
                v = pkg.RasterizeMode[v]
            elif k == "draw_mode":
                v = pkg.DrawMode[v]
            elif k == "sort_mode":
                v = pkg.SortMode[v]
            out[k] = v
        return pkg.CloudSettings(**out)

    return build(bgs), build(tsettings)


@functools.lru_cache(maxsize=None)
def _arrays_cached() -> dict:
    a = cloud_arrays("wide", 400, 1)
    levels = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    a["position_visibility"][:, 3] = np.random.default_rng(11).choice(levels, 400)
    return a


def _arrays() -> dict:
    return {k: v.copy() for k, v in _arrays_cached().items()}


def _cameras(width: int, height: int):
    """Both packages' camera at EYE, whose previous clip matrix is the one
    seen from a neighbouring eye (the optical flow's source)."""
    prev = TCamera.create(eye=(1.5, -0.8, 58.0), width=width, height=height, device="cpu")
    prev_clip = (prev.clip_from_view @ prev.view_from_world).numpy()
    return (
        bgs.Camera.create(eye=EYE, target=(0.0, 0.0, 0.0), width=width, height=height,
                          prev_clip_from_world=prev_clip),
        TCamera.create(eye=EYE, target=(0.0, 0.0, 0.0), width=width, height=height,
                       prev_clip_from_world=prev_clip, device="cpu"),
    )


def _hsv_inputs() -> np.ndarray:
    rng = np.random.default_rng(0)
    sectors = np.arange(7) * (TAU / 6.0)  # every sector boundary, 2 pi included
    hue = np.concatenate([sectors, np.nextafter(sectors, -1.0), np.nextafter(sectors, 10.0),
                          rng.uniform(0.0, TAU, 200)]).astype(np.float32)
    s = rng.uniform(0.0, 1.0, hue.shape).astype(np.float32)
    v = rng.uniform(0.0, 1.0, hue.shape).astype(np.float32)
    return np.stack([np.abs(hue), s, v], axis=-1)


def _color_case(name: str):
    """(JAX result, port result) of one colour function on shared inputs."""
    rng = np.random.default_rng(1)
    if name == "hsv_to_rgb":
        x = _hsv_inputs()
        return jcolor.hsv_to_rgb(jnp.asarray(x)), tcolor.hsv_to_rgb(torch.from_numpy(x))
    if name == "smoothstep":
        x = rng.uniform(-0.5, 1.5, 300).astype(np.float32)
        return jcolor.smoothstep(0.2, 0.7, jnp.asarray(x)), tcolor.smoothstep(0.2, 0.7, torch.from_numpy(x))
    if name == "depth_to_rgb":
        d = rng.uniform(40.0, 80.0, 300).astype(np.float32)
        lo, hi = np.float32(50.0), np.float32(70.0)
        return (jcolor.depth_to_rgb(jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi)),
                tcolor.depth_to_rgb(torch.from_numpy(d), torch.tensor(lo), torch.tensor(hi)))
    if name == "class_to_rgb":
        vis = rng.choice(np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 8.0], np.float32), 300)
        sh = rng.uniform(0.0, 1.0, (300, 3)).astype(np.float32)
        return (jcolor.class_to_rgb(jnp.asarray(vis), jnp.asarray(sh), 6),
                tcolor.class_to_rgb(torch.from_numpy(vis), torch.from_numpy(sh), 6))
    jc, tc = _cameras(64, 64)
    p = rng.uniform(-20.0, 20.0, (300, 3)).astype(np.float32)
    q = p + rng.normal(0.0, 0.05, (300, 3)).astype(np.float32)
    j_mv = jcolor.calculate_motion_vector(jnp.asarray(p), jnp.asarray(q), jc.clip_from_view @ jc.view_from_world,
                                          jc.prev_clip_from_world)
    t_mv = tcolor.calculate_motion_vector(torch.from_numpy(p), torch.from_numpy(q), tc.clip_from_world,
                                          tc.prev_clip_from_world)
    if name == "calculate_motion_vector":
        return j_mv, t_mv
    mv = np.asarray(j_mv)  # the same motion vectors into both
    return (jcolor.optical_flow_to_rgb(jnp.asarray(mv), 1.0 / 60.0),
            tcolor.optical_flow_to_rgb(torch.from_numpy(mv.copy()), 1.0 / 60.0))


COLOR_FNS = ["hsv_to_rgb", "smoothstep", "depth_to_rgb", "class_to_rgb", "calculate_motion_vector",
             "optical_flow_to_rgb"]


@pytest.mark.parametrize("name", COLOR_FNS)
def test_color_functions_match_jax(name):
    ref, got = _color_case(name)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_hsv_sectors_at_their_boundaries():
    """floor(h) mod 6 with a floored modulo: h = 6 is sector 0 (pure red at
    full saturation), each boundary opens the next sector."""
    hue = np.arange(7, dtype=np.float32) * np.float32(TAU / 6.0)
    x = np.stack([hue, np.ones(7, np.float32), np.ones(7, np.float32)], axis=-1)
    got = tcolor.hsv_to_rgb(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcolor.hsv_to_rgb(jnp.asarray(x))))
    np.testing.assert_allclose(got[0], [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(got[6], got[0], atol=1e-5)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_projection_colour_matches_jax(mode):
    _, kw = mode
    js_, ts_ = _settings(kw)
    jc, tc = _cameras(64, 64)
    j = jproject(jax_cloud(_arrays()), jc, js_)
    t = tproject(torch_cloud(_arrays()), tc, ts_)
    m = np.asarray(j["mask"])
    np.testing.assert_array_equal(t["mask"].numpy(), m)
    assert m.sum() > 100 and (m.sum() < 390) == (kw.get("draw_mode") == "SELECTED")
    np.testing.assert_allclose(t["alpha"].numpy(), np.asarray(j["alpha"]), rtol=1e-6, atol=1e-7)
    rgb, ref = t["rgb"].numpy()[m], np.asarray(j["rgb"])[m]
    err = float(np.abs(rgb - ref).max())
    print(f"\n[{mode[0]}] projection rgb vs JAX {err:.3e}, spread {ref.min(axis=0)} .. {ref.max(axis=0)}")
    assert err <= 1e-5
    assert (ref.max(axis=0) - ref.min(axis=0)).max() > 0.1  # the mode colours something


def _jax_serving(js_, jc, arrays, width, height):
    cloud = jax_cloud(arrays)
    bucket = jrt.pairs_budget(len(cloud), int(jrt.pair_count(cloud, jc, js_)))
    return np.asarray(jrt.render_tiled(
        cloud, jc, js_, background=jnp.asarray(BG), differentiable=False, compositor="pallas", pairs_max=bucket,
    ))


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_render_and_oracle_match_jax(mode):
    _, kw = mode
    js_, ts_ = _settings(kw)
    width, height = 64, 64
    jc, tc = _cameras(width, height)
    bg = torch.from_numpy(BG)
    ref = _jax_serving(js_, jc, _arrays(), width, height)
    api._BUDGET_STATE.clear()
    got = api.render(torch_cloud(_arrays()), tc, ts_, background=bg, device="cpu").numpy()
    oracle_ref = np.asarray(j_oracle(jax_cloud(_arrays()), jc, js_, background=jnp.asarray(BG)))
    oracle = t_oracle(torch_cloud(_arrays()), tc, ts_, background=bg).numpy()
    errs = float(np.abs(got - ref).max()), float(np.abs(oracle - oracle_ref).max())
    print(f"\n[{mode[0]}] render() vs JAX serving {errs[0]:.3e}, oracle vs JAX oracle {errs[1]:.3e}")
    assert got.shape == (height, width, 4) and np.isfinite(got).all()
    assert max(errs) <= IMAGE_BAR
    assert (np.abs(ref[..., :3] - BG[:3]).max(axis=-1) > 1.0 / 255.0).sum() > 0.1 * width * height


@pytest.mark.parametrize("sort_mode", ["STD", "RAYON"])
def test_host_sort_oracle_matches_jax(sort_mode):
    """STD and RAYON sort on the host, back to front, cull nothing; the tiled
    path ignores the sort mode (as the JAX package's does)."""
    js_, ts_ = _settings({"sort_mode": sort_mode, "rasterize_mode": "DEPTH"})
    jc, tc = _cameras(64, 64)
    ref = np.asarray(j_oracle(jax_cloud(_arrays()), jc, js_, background=jnp.asarray(BG)))
    got = t_oracle(torch_cloud(_arrays()), tc, ts_, background=torch.from_numpy(BG)).numpy()
    err = float(np.abs(got - ref).max())
    print(f"\n[{sort_mode}] oracle vs JAX oracle {err:.3e}")
    assert err <= IMAGE_BAR
    a = _arrays()
    order = tsort.sort_gaussians_host(a["position_visibility"][:, :3], np.eye(4, dtype=np.float32),
                                      tc.world_position.numpy())
    from bevy_gaussian_splatting_tpu.ops.sort import sort_gaussians_host as j_host

    np.testing.assert_array_equal(order, j_host(a["position_visibility"][:, :3], np.eye(4, dtype=np.float32),
                                                np.asarray(jc.world_position)))


KEY_CASES = {
    # tied smallest and largest keys, culled entries (the sentinel) at the back
    "ties_and_culled": np.array([7, 3, 3, 0xFFFFFFFF, 9, 3, 0xFFFFFFFF, 12, 9], np.uint32),
    "distinct": np.random.default_rng(2).permutation(1000).astype(np.uint32) * np.uint32(4099),
    "all_culled": np.full(5, 0xFFFFFFFF, np.uint32),
    "one": np.array([42], np.uint32),
    "two_tied": np.array([5, 5], np.uint32),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_back_sorted_entry_indices_equal_jax(case):
    keys = KEY_CASES[case]
    ref = [int(v) for v in jrt.back_sorted_entry_indices(jnp.asarray(keys))]
    got = [int(v) for v in tsort.back_sorted_entry_indices(torch.from_numpy(keys.astype(np.int64)))]
    assert got == ref
    order = np.argsort(keys, kind="stable")  # the back order the oracle reads
    assert ref == [int(order[min(1, len(keys) - 1)]), int(order[-1])]


def test_velocity_needs_4dgs():
    with pytest.raises(ValueError, match="VELOCITY"):
        api.render(torch_cloud(_arrays()), _cameras(32, 32)[1],
                   tsettings.CloudSettings(rasterize_mode=tsettings.RasterizeMode.VELOCITY), device="cpu")


def test_normal_mode_gradients_match_jax_pallas_training_path():
    js_, ts_ = _settings({"rasterize_mode": "NORMAL"})
    width, height = 64, 64
    jc, tc = _cameras(width, height)
    arrays = _arrays()
    target = np.random.default_rng(3).uniform(0.0, 1.0, (height, width, 4)).astype(np.float32)

    def j_loss(cloud):
        img = jrt.render_tiled(cloud, jc, js_, differentiable=True, compositor="pallas")
        return jnp.mean((img - jnp.asarray(target)) ** 2)

    l_ref, g_ref = jax.value_and_grad(j_loss)(jax_cloud(arrays))
    model = TrainableCloud.from_numpy(arrays, "cpu")
    loss = mse(trt.render_tiled(model.cloud(), tc, ts_), torch.from_numpy(target))
    loss.backward()
    assert abs(float(loss.detach()) - float(l_ref)) <= 1e-5 * float(l_ref)
    # NORMAL reads no SH coefficient: their gradient is zero in JAX, and
    # autograd leaves it unset in the port
    assert getattr(model, "spherical_harmonic").grad is None
    assert not np.asarray(g_ref.spherical_harmonic).any()
    errors = {}
    for f in ("position_visibility", "rotation", "scale_opacity"):
        ref = np.asarray(getattr(g_ref, f))
        got = getattr(model, f).grad.numpy()
        assert np.isfinite(got).all(), f
        scale = np.abs(ref).max()
        assert scale > 0, f
        errors[f] = float(np.abs(got - ref).max() / scale)
    print("\n[normal] max |port - jax| / max |jax|: " + ", ".join(f"{f} {e:.2e}" for f, e in errors.items()))
    assert all(e <= GRAD_BAR for e in errors.values()), errors
