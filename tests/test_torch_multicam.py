"""PyTorch port, several cameras and full-image backgrounds on the CPU
against the JAX package:

  - ``render/multi_camera.py`` (``TestMultiCamera`` of
    tests/test_multicam_noise.py): a batch against each camera's own render,
    bit for bit, and against JAX's render of each camera, a stacked batch;
  - full-image [H, W, 4] backgrounds through ``render_tiled`` and
    ``render()`` at 64x64 and on the padded grid at 64x60: the image against
    JAX's ``render_tiled(..., compositor="pallas")`` (the Pallas kernels in
    interpret mode, 2e-5) and the port's oracle (3e-5); the gradients are
    in tests/test_torch_background.py;
  - ``make_tiled_pipeline``, ``supports``, ``render_tiled``'s ``width``,
    ``height`` and ``pairs_hint``, and ``orbit_camera_device`` against the
    JAX one (1e-6 of each matrix's largest magnitude).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.models.camera import orbit_camera_device as j_orbit_camera
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera as TCamera
from bevy_gaussian_splatting_tpu_torch.models.camera import orbit_camera_device as t_orbit_camera
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.render.api import render
from bevy_gaussian_splatting_tpu_torch.render.multi_camera import render_multi_camera, stack_cameras
from torch_port_cases import cameras, cloud_arrays, jax_cloud, torch_cloud

IMAGE_BAR = 2e-5
MULTI_EYES = ((0.0, 0.0, 60.0), (30.0, 10.0, 50.0), (-40.0, 0.0, 40.0))


def _cams(eyes, size=64, device="cpu"):
    return [TCamera.create(eye=e, target=(0, 0, 0), width=size, height=size, device=device) for e in eyes]


def _jcams(eyes, size=64):
    return [bgs.Camera.create(eye=e, target=(0, 0, 0), width=size, height=size) for e in eyes]


def _random_arrays(n, seed):
    return cloud_arrays("wide", n, seed)


class TestMultiCamera:
    def test_batch_matches_individual(self):
        a = _random_arrays(200, 1)
        batch = render_multi_camera(torch_cloud(a), _cams(MULTI_EYES), device="cpu").numpy()
        assert batch.shape == (3, 64, 64, 4)
        for i, (cam, jcam) in enumerate(zip(_cams(MULTI_EYES), _jcams(MULTI_EYES))):
            single = trt.render_tiled(torch_cloud(a), cam, TSettings(), differentiable=False).numpy()
            np.testing.assert_array_equal(batch[i], single, err_msg=f"cam {i}")
            want = jrt.render_tiled(jax_cloud(a), jcam, bgs.CloudSettings(), differentiable=False, compositor="pallas")
            np.testing.assert_allclose(batch[i], np.asarray(want), atol=IMAGE_BAR, rtol=0, err_msg=f"cam {i}")

    def test_views_differ(self):
        a = _random_arrays(100, 2)
        batch = render_multi_camera(torch_cloud(a), _cams(((0, 0, 60.0), (60, 0, 0.1))), device="cpu").numpy()
        assert not np.allclose(batch[0], batch[1])

    def test_prestacked(self):
        a = _random_arrays(50, 3)
        stacked = stack_cameras(_cams(((0, 0, 60.0),) * 2))
        assert stacked.view_from_world.shape == (2, 4, 4) and (stacked.width, stacked.height) == (64, 64)
        batch = render_multi_camera(torch_cloud(a), stacked, width=64, height=64, device="cpu").numpy()
        np.testing.assert_array_equal(batch[0], batch[1])
        with pytest.raises(ValueError, match="one image size"):
            stack_cameras(_cams(((0, 0, 60.0),)) + _cams(((0, 0, 60.0),), size=32))


BG_CASES = [(64, 64), (64, 60)]


def background(width, height, seed=4) -> np.ndarray:
    """A smooth full-image RGBA background (the epilogue blends whatever it
    is given, premultiplied or not)."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    base = rng.uniform(0.1, 0.9, (4, 4)).astype(np.float32)
    bg = base[0] * x[..., None] + base[1] * y[..., None] + base[2] * (x * y)[..., None] + base[3] * 0.25
    return np.clip(bg, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("width,height", BG_CASES, ids=[f"{w}x{h}" for w, h in BG_CASES])
def test_full_image_background_matches_jax(width, height):
    """The serving image over a full-image background against JAX's kernel
    path, also through ``render()``, and against the port's oracle."""
    a = cloud_arrays("wide", 100, 6)
    jc, tc = cameras(width, height)
    bg = background(width, height)
    want = np.asarray(jrt.render_tiled(
        jax_cloud(a), jc, bgs.CloudSettings(), background=jnp.asarray(bg), differentiable=False, compositor="pallas"
    ))
    cloud = torch_cloud(a)
    img = trt.render_tiled(cloud, tc, TSettings(), background=torch.from_numpy(bg), differentiable=False).numpy()
    assert img.shape == (height, width, 4)
    np.testing.assert_allclose(img, want, atol=IMAGE_BAR, rtol=0)
    np.testing.assert_array_equal(render(cloud, tc, background=torch.from_numpy(bg), device="cpu").numpy(), img)
    oracle = render(cloud, tc, background=torch.from_numpy(bg), impl="oracle", device="cpu").numpy()
    np.testing.assert_allclose(img, oracle, atol=3e-5, rtol=0)  # test_pallas.py's bar against the painter


def test_full_image_background_shape_is_checked():
    a = cloud_arrays("bench", 64, 0)
    _, tc = cameras(64, 64)
    with pytest.raises(ValueError, match="background"):
        trt.render_tiled(torch_cloud(a), tc, TSettings(), background=torch.zeros(32, 64, 4))


def test_make_tiled_pipeline_and_size_arguments():
    a = cloud_arrays("bench", 2000, 3)
    jc, tc = cameras(128, 120)
    n = 2000
    hint = int(trt.pair_count(torch_cloud(a), tc, TSettings()))
    assert trt.supports(TSettings()) and jrt.supports(bgs.CloudSettings())
    fn = trt.make_tiled_pipeline(TSettings(), 128, 120, pairs_hint=hint)
    got = fn(torch_cloud(a), tc, None, None, None).numpy()
    # JAX's pipeline is this call under jax.jit, whose fused multiply-adds
    # move splat edges; the port follows the eager trace, as every test here
    want = np.asarray(jrt.render_tiled(
        jax_cloud(a), jc, bgs.CloudSettings(), differentiable=False, compositor="pallas", pairs_hint=hint
    ))
    np.testing.assert_allclose(got, want, atol=IMAGE_BAR, rtol=0)
    # the hint goes through pairs_budget; width and height default to the camera's
    direct = trt.render_tiled(
        torch_cloud(a), tc, TSettings(), pairs_max=trt.pairs_budget(n, hint), differentiable=False
    ).numpy()
    np.testing.assert_array_equal(got, direct)
    sized = trt.render_tiled(torch_cloud(a), tc, TSettings(), differentiable=False, width=128, height=120,
                             pairs_hint=hint).numpy()
    np.testing.assert_array_equal(sized, direct)
    with pytest.raises(ValueError, match="multiple of 16"):
        trt.render_tiled(torch_cloud(a), tc, TSettings(), width=120)


@pytest.mark.parametrize("orbit", [(0.35, 0.2, 60.0, 0.0, 0.0, 0.0), (2.5, -0.7, 7.5, 0.3, -1.0, 2.0)])
def test_orbit_camera_device_matches_jax(orbit):
    want = j_orbit_camera(jnp.asarray(orbit, jnp.float32), 64, 48)
    got = t_orbit_camera(torch.tensor(orbit, dtype=torch.float32), 64, 48)
    assert (got.width, got.height, got.device.type) == (64, 48, "cpu")
    for name in ("view_from_world", "clip_from_view", "viewport", "prev_clip_from_world", "world_position"):
        ref = np.asarray(getattr(want, name))
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(getattr(got, name).numpy(), ref, atol=1e-6 * scale, rtol=0, err_msg=name)
