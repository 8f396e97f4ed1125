"""PyTorch port, models/: settings, camera and cloud against the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.models import cloud as jcloud
from bevy_gaussian_splatting_tpu.models import settings as jsettings
from bevy_gaussian_splatting_tpu_torch.models import cloud as tcloud
from bevy_gaussian_splatting_tpu_torch.models import settings as tsettings
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera as TCamera
from torch_port_cases import cameras

ENUMS = [
    "DrawMode", "GaussianMode", "PlaybackMode", "RasterizeMode",
    "RadixSortDepthBits", "SortMode", "GaussianColorSpace",
]


@pytest.mark.parametrize("name", ENUMS)
def test_enums_equal(name):
    j, t = getattr(jsettings, name), getattr(tsettings, name)
    assert [(m.name, m.value) for m in j] == [(m.name, m.value) for m in t]


def test_radix_bits_properties():
    for j, t in zip(jsettings.RadixSortDepthBits, tsettings.RadixSortDepthBits):
        assert (j.bits, j.key_shift, j.digit_places) == (t.bits, t.key_shift, t.digit_places)


def _as_values(key):
    return tuple(v.value if hasattr(v, "value") else v for v in key)


def test_cloud_settings_defaults_and_static_key():
    j, t = jsettings.CloudSettings(), tsettings.CloudSettings()
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert jf.keys() == tf.keys()
    assert _as_values(jf.values()) == _as_values(tf.values())
    assert _as_values(j.static_key()) == _as_values(t.static_key())
    t2 = t.replace(aabb=True, time=0.5)
    j2 = j.replace(aabb=True, time=0.5)
    assert _as_values(j2.static_key()) == _as_values(t2.static_key())
    assert t2.static_key() != t.static_key()
    assert t.replace(time=0.7).static_key() == t.static_key()


@pytest.mark.parametrize("width,height,eye", [
    (128, 128, (0.0, 0.0, 60.0)),
    (128, 120, (3.0, -2.0, 40.0)),
    (1920, 1080, (10.0, 5.0, 30.0)),
])
def test_camera_matrices(width, height, eye):
    jc, tc = cameras(width, height, eye)
    for name in ("view_from_world", "clip_from_view", "viewport", "prev_clip_from_world"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), err_msg=name)
    np.testing.assert_allclose(
        tc.clip_from_world.numpy(), np.asarray(jc.clip_from_view @ jc.view_from_world),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        tc.world_position.numpy(), np.asarray(jc.world_position), rtol=1e-6, atol=1e-5
    )
    assert (tc.width, tc.height) == (width, height)


def test_camera_default_device_needs_card():
    if torch.cuda.is_available():
        assert TCamera.create().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TCamera.create()


@pytest.mark.parametrize("degree", range(5))
def test_sh_width_helpers(degree):
    assert tcloud.sh_coeff_width(degree) == jcloud.sh_coeff_width(degree)
    assert tcloud.num_sh_coefficients(degree) == jcloud.num_sh_coefficients(degree)
    w = jcloud.sh_coeff_width(degree)
    assert tcloud.sh_degree_from_width(w) == jcloud.sh_degree_from_width(w) == degree


def test_sh_width_rejects_unknown():
    with pytest.raises(ValueError):
        tcloud.sh_degree_from_width(47)
    with pytest.raises(ValueError):
        tcloud.sh_coeff_width(5)


@pytest.mark.parametrize("n,seed", [(500, 0), (37, 9)])
def test_seeded_generator_bit_identical(n, seed):
    j = bgs.random_gaussians_3d_seeded(n, seed=seed)
    t = tcloud.random_gaussians_3d_seeded(n, seed=seed, device="cpu")
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(t.opacity.numpy(), np.asarray(j.opacity))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert len(t) == len(j) == n


def test_cloud_from_numpy_carries_jax_fields():
    j = bgs.random_gaussians_3d_seeded(64, seed=5)
    arrays = {f.name: np.asarray(getattr(j, f.name)) for f in dataclasses.fields(j)}
    t = tcloud.cloud_from_numpy(arrays, device="cpu")
    for name, a in arrays.items():
        got = getattr(t, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), a)
    bad = dict(arrays, rotation=arrays["rotation"][:, :3])
    with pytest.raises(ValueError):
        tcloud.cloud_from_numpy(bad, device="cpu")
    with pytest.raises(KeyError):
        tcloud.cloud_from_numpy({"rotation": arrays["rotation"]}, device="cpu")
