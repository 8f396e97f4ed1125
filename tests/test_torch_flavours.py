"""PyTorch port, the other cloud flavours on the CPU against the JAX package:

  - the precomputed-covariance cloud (``precompute_covariance_3d``, with and
    without ``f16_quantize``): its storage against JAX's, its renders within
    1e-6 of the quaternion-and-scale renders (tests/test_cov3d.py's bar),
    ``render()`` and the oracle against JAX's within 2e-5, and the 2DGS and
    NORMAL raises;
  - float16 and bfloat16 storage: ``render()`` and the oracle against the
    JAX package's renders of the same storage (2e-5), and equal bit for bit
    to the float32 render of the rounded cloud (projection casts first, so
    nothing later sees another type);
  - ``models/f16.py``'s u32 packing bit-equal to the JAX package's;
  - the SH degree-4 basis, and the lookup's ``eval_degree`` at every storage
    degree;
  - ``set_sh_degree`` and ``pad_cloud`` array-equal to JAX's, and a padded
    cloud renders as the unpadded one (within 1e-6: CPU rounding of the
    vector tails, see the test).

The scene is tests/test_cov3d.py's ``_scene_cloud`` (96 small gaussians seen
from (0, 0, 6)) at 64x64; ``pytest -s`` prints the measured errors.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.models import f16 as jf16
from bevy_gaussian_splatting_tpu.models.cloud import pad_cloud as j_pad
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops import sh as jsh
from bevy_gaussian_splatting_tpu.ops.project import project_gaussians as jproject
from bevy_gaussian_splatting_tpu.ops.rasterize_ref import render_oracle as j_oracle
from bevy_gaussian_splatting_tpu_torch.models import cloud as tcloud
from bevy_gaussian_splatting_tpu_torch.models import f16 as tf16
from bevy_gaussian_splatting_tpu_torch.models import settings as tsettings
from bevy_gaussian_splatting_tpu_torch.ops import sh as tsh
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians as tproject
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_ref import render_oracle as t_oracle
from bevy_gaussian_splatting_tpu_torch.render import api
from torch_port_cases import cameras, jax_cloud, torch_cloud

IMAGE_BAR = 2e-5
COV_BAR = 1e-6  # tests/test_cov3d.py:85-98
EYE6 = (0.0, 0.0, 6.0)


@functools.lru_cache(maxsize=None)
def _scene_cached(n: int = 96, seed: int = 3, sh_degree: int = 3) -> dict:
    """tests/test_cov3d.py's _scene_cloud as numpy arrays."""
    a = tcloud.random_arrays_3d_seeded(n, seed, sh_degree)
    so = a["scale_opacity"]
    so[:, :3] = np.abs(so[:, :3]) * 0.05 + 0.02
    so[:, 3] = np.clip(np.abs(so[:, 3]), 0.2, 0.9)
    a["position_visibility"][:, :3] *= 0.05
    return a


def _scene(**kw) -> dict:
    return {k: v.copy() for k, v in _scene_cached(**kw).items()}


def _np(cloud) -> dict:
    return {f.name: np.asarray(getattr(cloud, f.name)) for f in dataclasses.fields(cloud)}


def _jax_render(cloud, jc, settings):
    """The JAX package's serving path and oracle -> numpy images."""
    bucket = jrt.pairs_budget(len(cloud), int(jrt.pair_count(cloud, jc, settings)))
    tiled = jrt.render_tiled(cloud, jc, settings, differentiable=False, compositor="pallas", pairs_max=bucket)
    return np.asarray(tiled), np.asarray(j_oracle(cloud, jc, settings))


def _port_render(cloud, tc, settings):
    api._BUDGET_STATE.clear()
    return api.render(cloud, tc, settings, device="cpu").numpy(), t_oracle(cloud, tc, settings).numpy()


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "f16-quantized"])
def test_precompute_covariance_matches_jax(quantize):
    a = _scene()
    ref = bgs.precompute_covariance_3d(jax_cloud(a), f16_quantize=quantize)
    got = tcloud.precompute_covariance_3d(torch_cloud(a), f16_quantize=quantize)
    assert isinstance(got, tcloud.Gaussian3dCovCloud)
    for name, value in _np(ref).items():
        np.testing.assert_allclose(getattr(got, name).numpy(), value, rtol=1e-6, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(got.opacity.numpy(), np.asarray(ref.opacity))
    # the storage round-trips through cloud_from_numpy as the same class
    again = tcloud.cloud_from_numpy(_np(ref), "cpu")
    assert type(again) is tcloud.Gaussian3dCovCloud and again.covariance_3d_opacity.shape == (96, 8)


@pytest.mark.parametrize("aabb", [False, True], ids=["obb", "aabb"])
def test_covariance_cloud_renders(aabb):
    a = _scene()
    jc, tc = cameras(64, 64, EYE6)
    js_, ts_ = bgs.CloudSettings(aabb=aabb), tsettings.CloudSettings(aabb=aabb)
    plain = torch_cloud(a)
    cov = tcloud.precompute_covariance_3d(plain)
    got = _port_render(cov, tc, ts_)
    quat = _port_render(plain, tc, ts_)
    ref = _jax_render(bgs.precompute_covariance_3d(jax_cloud(a)), jc, js_)
    e_quat = max(float(np.abs(g - q).max()) for g, q in zip(got, quat))
    e_jax = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
    print(f"\n[cov {'aabb' if aabb else 'obb'}] vs quat/scale render {e_quat:.3e} (bar {COV_BAR}), vs JAX {e_jax:.3e}")
    assert e_quat <= COV_BAR and e_jax <= IMAGE_BAR
    assert (got[0][..., 3] > 0.01).sum() > 300


def test_covariance_cloud_rejects_what_it_cannot_draw():
    a = _scene(n=16)
    jc, tc = cameras(32, 32, EYE6)
    jcov = bgs.precompute_covariance_3d(jax_cloud(a))
    tcov = tcloud.precompute_covariance_3d(torch_cloud(a))
    for kw in ({"gaussian_mode": "GAUSSIAN_2D"}, {"rasterize_mode": "NORMAL"}):
        def build(pkg):
            return pkg.CloudSettings(**{k: getattr(pkg, "GaussianMode" if k == "gaussian_mode" else "RasterizeMode")[v]
                                        for k, v in kw.items()})
        with pytest.raises(ValueError) as j_err:
            jproject(jcov, jc, build(bgs))
        with pytest.raises(ValueError) as t_err:
            tproject(tcov, tc, build(tsettings))
        assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_storage_renders_match_jax(dtype):
    a = _scene()
    jc, tc = cameras(64, 64, EYE6)
    settings = tsettings.CloudSettings()
    jhalf = jax_cloud(a).astype(getattr(jnp, dtype))
    thalf = torch_cloud(a).astype(getattr(torch, dtype))
    assert thalf.dtype == getattr(torch, dtype)
    got = _port_render(thalf, tc, settings)
    ref = _jax_render(jhalf, jc, bgs.CloudSettings())
    errs = [float(np.abs(g - r).max()) for g, r in zip(got, ref)]
    print(f"\n[{dtype}] render() vs JAX {errs[0]:.3e}, oracle vs JAX {errs[1]:.3e}")
    assert max(errs) <= IMAGE_BAR
    # the rounded values reach projection as float32: the same bits as the
    # float32 render of the rounded cloud
    rounded = thalf.astype(torch.float32)
    for g, r in zip(got, _port_render(rounded, tc, settings)):
        np.testing.assert_array_equal(g, r)
    # and the storage holds the JAX package's bits
    for name, value in _np(jhalf).items():
        np.testing.assert_array_equal(getattr(rounded, name).numpy(), value.astype(np.float32), err_msg=name)
    if dtype == "float16":
        np.testing.assert_array_equal(tf16.to_f32(tf16.to_f16_storage(torch_cloud(a))).scale_opacity.numpy(),
                                      np.asarray(jf16.to_f32(jf16.to_f16_storage(jax_cloud(a))).scale_opacity))


def test_f16_packing_bit_equal():
    rng = np.random.default_rng(0)
    cov = rng.normal(size=(64, 6)).astype(np.float32)
    rot = rng.normal(size=(64, 4)).astype(np.float32)
    scale = rng.uniform(0.0, 2.0, (64, 3)).astype(np.float32)
    op = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    specials = np.array([0.0, -0.0, 65504.0, 1e-8, 7e4, np.inf, -np.inf], np.float32)
    cov[: len(specials), 0] = specials
    pairs = [
        (tf16.pack_covariance_3d_opacity(cov, op), jf16.pack_covariance_3d_opacity(cov, op)),
        (tf16.pack_rotation_scale_opacity(rot, scale, op), jf16.pack_rotation_scale_opacity(rot, scale, op)),
        (tf16.pack_f32s_to_u32(cov[:, 0], cov[:, 1]), jf16.pack_f32s_to_u32(cov[:, 0], cov[:, 1])),
    ]
    for got, ref in pairs:
        assert got.dtype == ref.dtype == np.uint32
        np.testing.assert_array_equal(got, ref)
    packed = pairs[0][1]
    for got, ref in zip(tf16.unpack_covariance_3d_opacity(packed), jf16.unpack_covariance_3d_opacity(packed)):
        np.testing.assert_array_equal(got, ref)
    packed = pairs[1][1]
    for got, ref in zip(tf16.unpack_rotation_scale_opacity(packed), jf16.unpack_rotation_scale_opacity(packed)):
        np.testing.assert_array_equal(got, ref)


def test_sh_degree4_basis_matches_jax():
    rng = np.random.default_rng(2)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for degree in range(5):
        ref = np.asarray(jsh.sh_basis(jnp.asarray(d), degree))
        got = tsh.sh_basis(torch.from_numpy(d), degree).numpy()
        assert got.shape == ref.shape == (300, (degree + 1) ** 2)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tsh.SHC4, jsh.SHC4)


@pytest.mark.parametrize("degree", range(5))
def test_sh_lookup_eval_degree_matches_jax(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sh = rng.uniform(-1.0, 1.0, (200, tcloud.sh_coeff_width(degree))).astype(np.float32)
    assert tsh.sh_storage_degree(torch.from_numpy(sh)) == jsh.sh_storage_degree(jnp.asarray(sh)) == degree
    for eval_degree in (None, 0, 2, 4):
        ref = np.asarray(jsh.spherical_harmonics_lookup(jnp.asarray(d), jnp.asarray(sh), eval_degree=eval_degree))
        got = tsh.spherical_harmonics_lookup(torch.from_numpy(d), torch.from_numpy(sh), eval_degree=eval_degree)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6, err_msg=str(eval_degree))
    if degree == 4:  # the default evaluates through degree 3, as the reference shader
        full = tsh.spherical_harmonics_lookup(torch.from_numpy(d), torch.from_numpy(sh), eval_degree=4)
        default = tsh.spherical_harmonics_lookup(torch.from_numpy(d), torch.from_numpy(sh))
        assert float((full - default).abs().max()) > 0.1


@pytest.mark.parametrize("source", [3, 4, "cov"])
def test_set_sh_degree_array_equal(source):
    a = _scene(sh_degree=4 if source == 4 else 3)
    j, t = jax_cloud(a), torch_cloud(a)
    if source == "cov":
        j, t = bgs.precompute_covariance_3d(j), tcloud.precompute_covariance_3d(t)
    for degree in range(5):
        ref, got = bgs.set_sh_degree(j, degree), tcloud.set_sh_degree(t, degree)
        assert type(got) is type(t)
        for name, value in _np(ref).items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), value, err_msg=f"{degree} {name}")


def test_sh_degree4_renders_within_reach_of_degree3():
    """tests/test_sh_degree.py:270-294's bar: a degree-4 cloud renders as
    its degree-3 truncation (the shader evaluates through degree 3)."""
    a = _scene(n=64, seed=4, sh_degree=4)
    _, tc = cameras(64, 64, EYE6)
    cloud = torch_cloud(a)
    for d4, d3 in zip(_port_render(cloud, tc, tsettings.CloudSettings()),
                      _port_render(tcloud.set_sh_degree(cloud, 3), tc, tsettings.CloudSettings())):
        np.testing.assert_allclose(d4, d3, rtol=0, atol=2e-6)


@pytest.mark.parametrize("kind", ["3d", "4d", "cov"])
def test_pad_cloud_array_equal_and_renders_alike(kind):
    if kind == "4d":
        a = tcloud.random_arrays_4d_seeded(70, 2)
    else:
        a = _scene(n=70)
    j, t = jax_cloud(a), torch_cloud(a)
    if kind == "cov":
        j, t = bgs.precompute_covariance_3d(j), tcloud.precompute_covariance_3d(t)
    for multiple in (32, 256):
        ref, got = j_pad(j, multiple), t.pad(multiple)
        assert len(got) == len(ref) == -(-70 // multiple) * multiple
        for name, value in _np(ref).items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), value, err_msg=f"{multiple} {name}")
    assert tcloud.pad_cloud(t, 70) is t and tcloud.DEFAULT_PAD_MULTIPLE == 256
    settings = tsettings.CloudSettings(
        gaussian_mode=tsettings.GaussianMode.GAUSSIAN_4D if kind == "4d" else tsettings.GaussianMode.GAUSSIAN_3D,
        time=0.5,
    )
    _, tc = cameras(64, 64, (0.0, 0.0, 60.0) if kind == "4d" else EYE6)
    # the pad rows add alpha 0 everywhere; PyTorch's CPU kernels round the
    # last rows of a 70-row tensor in their scalar tail and of a 256-row one
    # in vector lanes (pow, exp), so the images agree to an ulp or two
    for padded, plain in zip(_port_render(t.pad(), tc, settings), _port_render(t, tc, settings)):
        np.testing.assert_allclose(padded, plain, rtol=0, atol=1e-6)
