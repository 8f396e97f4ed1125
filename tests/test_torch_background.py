"""PyTorch port, gradients through a full-image [H, W, 4] background on the
CPU against the JAX package: ``render_tiled`` (the port's autograd Function
and the background's epilogue) against ``jax.grad`` of the same loss through
JAX's ``render_tiled(..., differentiable=True, compositor="pallas")`` (the
Pallas kernels in interpret mode), for the background and every cloud
field, at 64x64 and on the padded grid at 64x60 (1e-3 of each gradient's
largest magnitude); and the overlay's training route (``composite_tiles``,
JAX's XLA compositor) with the same background.  The serving images are in
tests/test_torch_multicam.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud
from test_torch_multicam import BG_CASES, IMAGE_BAR, background
from torch_port_cases import cameras, cloud_arrays, jax_cloud, overlay_settings, torch_cloud

GRAD_BAR = 1e-3  # of each gradient's largest |JAX| value
FIELDS = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")


def _target(width, height) -> np.ndarray:
    return np.ascontiguousarray(background(width, height, seed=9)[..., ::-1])


@functools.lru_cache(maxsize=None)
def _jax_case(width, height, bbox=False):
    """JAX's training image and gradients (cloud fields, background)."""
    a = cloud_arrays("wide", 100, 6)
    jc, _ = cameras(width, height)
    settings = overlay_settings("obb")[0] if bbox else bgs.CloudSettings()
    target = jnp.asarray(_target(width, height))

    def image(cloud, bg):
        return jrt.render_tiled(cloud, jc, settings, background=bg, differentiable=True, compositor="pallas")

    def loss(cloud, bg):
        return jnp.mean((image(cloud, bg) - target) ** 2)

    bg = jnp.asarray(background(width, height))
    gc, gb = jax.grad(loss, argnums=(0, 1))(jax_cloud(a), bg)
    grads = {name: np.asarray(getattr(gc, name)) for name in FIELDS}
    grads["background"] = np.asarray(gb)
    return np.asarray(image(jax_cloud(a), bg)), grads


def _port_case(width, height, bbox=False):
    _, tc = cameras(width, height)
    settings = overlay_settings("obb")[1] if bbox else TSettings()
    bg = torch.from_numpy(background(width, height)).requires_grad_(True)
    model = TrainableCloud(torch_cloud(cloud_arrays("wide", 100, 6)))
    img = trt.render_tiled(model.cloud(), tc, settings, background=bg)
    torch.mean((img - torch.from_numpy(_target(width, height))) ** 2).backward()
    grads = {name: getattr(model, name).grad.numpy() for name in FIELDS}
    grads["background"] = bg.grad.numpy()
    return img.detach().numpy(), grads


def _assert_grads(got: dict, want: dict, label: str):
    for name, ref in want.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(got[name] - ref).max())
        assert np.isfinite(got[name]).all(), f"{label} {name}"
        assert err <= GRAD_BAR * max(scale, 1e-12), f"{label} {name}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("width,height", BG_CASES, ids=[f"{w}x{h}" for w, h in BG_CASES])
def test_full_image_background_gradients_match_jax(width, height):
    want_img, want_grads = _jax_case(width, height)
    img, grads = _port_case(width, height)
    np.testing.assert_allclose(img, want_img, atol=IMAGE_BAR, rtol=0)
    _assert_grads(grads, want_grads, f"{width}x{height}")
    # a pixel no splat covers passes the loss's gradient to the background whole
    assert float(np.abs(grads["background"]).max()) > 0.0


def test_full_image_background_overlay_training_route():
    """The overlay trains through the plain ``composite_tiles``; the
    background is blended in the same epilogue."""
    want_img, want_grads = _jax_case(64, 60, bbox=True)
    img, grads = _port_case(64, 60, bbox=True)
    np.testing.assert_allclose(img, want_img, atol=IMAGE_BAR, rtol=0)
    _assert_grads(grads, want_grads, "bbox 64x60")
