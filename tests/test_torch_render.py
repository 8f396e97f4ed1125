"""PyTorch port, the whole slice: ``render()`` on the CPU (the kernels' plain
versions) against the JAX package's serving path,
``render_tiled(..., compositor="pallas", differentiable=False)`` with the
same adaptive pair budget, and against the port's own oracle."""

import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu_torch.models import settings as tsettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.render import api
from torch_port_cases import CASE_IDS, CASES, cameras, cloud_arrays, jax_cloud, torch_cloud

BG = np.array([0.2, 0.1, 0.4, 1.0], np.float32)


def _jax_serving(arrays, jc, bg):
    cloud = jax_cloud(arrays)
    settings = bgs.CloudSettings()
    n = arrays["position_visibility"].shape[0]
    bucket = jrt.pairs_budget(n, int(jrt.pair_count(cloud, jc, settings)))
    img = jrt.render_tiled(
        cloud, jc, settings, background=np.asarray(bg), differentiable=False,
        compositor="pallas", pairs_max=bucket,
    )
    return np.asarray(img)


# every case without a background, and a solid one at both heights
BG_CASES = [(c, False) for c in CASES] + [(CASES[0], True), (CASES[3], True)]
BG_IDS = [f"{i}-nobg" for i in CASE_IDS] + [f"{CASE_IDS[0]}-bg", f"{CASE_IDS[3]}-bg"]


@pytest.mark.parametrize("case,with_bg", BG_CASES, ids=BG_IDS)
def test_render_matches_jax_serving_path(case, with_bg):
    kind, n, seed, w, h = case
    a = cloud_arrays(kind, n, seed)
    bg = BG if with_bg else np.zeros(4, np.float32)
    jc, tc = cameras(w, h)
    ref = _jax_serving(a, jc, bg)
    api._BUDGET_STATE.clear()
    got = api.render(torch_cloud(a), tc, background=torch.from_numpy(bg), device="cpu").numpy()
    assert got.shape == (h, w, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    assert (ref[..., 3] > 0.01).sum() > 500


@pytest.mark.parametrize("case", CASES[1:3], ids=CASE_IDS[1:3])
def test_render_matches_own_oracle(case):
    kind, n, seed, w, h = case
    a = cloud_arrays(kind, n, seed)
    _, tc = cameras(w, h)
    cloud = torch_cloud(a)
    tiled = api.render(cloud, tc, device="cpu")
    oracle = api.render(cloud, tc, impl="oracle", device="cpu")
    # test_pallas.py's bar for the kernel path against the painter
    np.testing.assert_allclose(tiled.numpy(), oracle.numpy(), atol=3e-5, rtol=0)


def test_render_cap_binding_truncates_like_jax():
    a = cloud_arrays("wide", 400, 1)
    jc, tc = cameras(128, 128)
    ref = np.asarray(jrt.render_tiled(
        jax_cloud(a), jc, bgs.CloudSettings(), differentiable=False, compositor="pallas", pairs_max=600,
    ))
    got = trt.render_tiled(torch_cloud(a), tc, tsettings.CloudSettings(), pairs_max=600).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_render_default_device_is_the_card():
    a = cloud_arrays("bench", 64, 0)
    _, tc = cameras(32, 32)
    if torch.cuda.is_available():
        assert api.render(torch_cloud(a), tc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            api.render(torch_cloud(a), tc)


def test_render_rejects_what_later_slices_bring():
    a = cloud_arrays("bench", 64, 0)
    cloud = torch_cloud(a)
    _, tc = cameras(32, 32)
    with pytest.raises(NotImplementedError, match="slice 3"):
        api.render(cloud, tc, tsettings.CloudSettings(aabb=True), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 3"):
        api.render(cloud, tc, background=torch.zeros(32, 32, 4), device="cpu")
    with pytest.raises(ValueError, match="impl"):
        api.render(cloud, tc, impl="tiled-pallas", device="cpu")
    _, odd = cameras(40, 32)
    with pytest.raises(ValueError, match="multiple of 16"):
        api.render(cloud, odd, device="cpu")


def test_adaptive_budget_bookkeeping():
    a = cloud_arrays("wide", 400, 1)
    cloud = torch_cloud(a)
    _, near = cameras(64, 64, (0.0, 0.0, 30.0))
    _, far = cameras(64, 64, (0.0, 0.0, 200.0))
    api._BUDGET_STATE.clear()
    key = ("auto", tsettings.CloudSettings().static_key(), 64, 64, 400, "cpu")
    settings = tsettings.CloudSettings()
    b0 = api._current_bucket(key, settings, cloud, near, None)
    assert b0 == trt.pairs_budget(400, int(trt.pair_count(cloud, near, settings)))
    # between recounts the bucket is reused, whatever the camera
    for frame in range(1, api._RECOUNT_PERIOD):
        assert api._current_bucket(key, settings, cloud, far, None) == b0
        assert api._BUDGET_STATE[key] == (b0, frame)
    # the recount frame measures again; a smaller need never shrinks it
    assert api._current_bucket(key, settings, cloud, far, None) == b0
    assert api._BUDGET_STATE[key] == (b0, api._RECOUNT_PERIOD)
