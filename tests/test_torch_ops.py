"""PyTorch port, per-gaussian ops/: transforms, radix keys, covariance, SH,
projection and parameter packing against the JAX package on the same numpy
inputs.  Floats: allclose at 1e-5; radix keys: array-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import covariance as jcov
from bevy_gaussian_splatting_tpu.ops import sh as jsh
from bevy_gaussian_splatting_tpu.ops import sort as jsort
from bevy_gaussian_splatting_tpu.ops import transforms as jtr
from bevy_gaussian_splatting_tpu.ops.project import project_gaussians as jproject
from bevy_gaussian_splatting_tpu.ops.rasterize_tile import pack_raster_param_cols as jpack
from bevy_gaussian_splatting_tpu_torch.ops import covariance as tcov
from bevy_gaussian_splatting_tpu_torch.ops import sh as tsh
from bevy_gaussian_splatting_tpu_torch.ops import sort as tsort
from bevy_gaussian_splatting_tpu_torch.ops import transforms as ttr
from bevy_gaussian_splatting_tpu_torch.ops.cuda.project import pack_raster_param_cols as tpack
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians as tproject
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from torch_port_cases import CASE_IDS, CASES, cameras, cloud_arrays, jax_cloud, torch_cloud

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(kw or TOL))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    n = 300
    pos = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    quat = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    scale = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    sh = rng.uniform(-1, 1, (n, 48)).astype(np.float32)
    mt = np.eye(4, dtype=np.float32)
    mt[:3, :3] = np.array([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.5]], np.float32)
    mt[:3, 3] = [1.0, -2.0, 0.5]
    jc, _ = cameras(128, 120, (3.0, -2.0, 40.0))
    return dict(pos=pos, quat=quat, scale=scale, dirs=dirs, sh=sh, mt=mt, cam=jc)


def test_transforms(inputs):
    cam = inputs["cam"]
    cfw = np.asarray(cam.clip_from_view @ cam.view_from_world)
    for mt in (np.eye(4, dtype=np.float32), inputs["mt"]):
        w_j = jtr.apply_transform(jnp.asarray(mt), jnp.asarray(inputs["pos"]))
        w_t = ttr.apply_transform(_t(mt), _t(inputs["pos"]))
        _close(w_t, w_j)
        c_j = jtr.world_to_clip(w_j, jnp.asarray(cfw))
        c_t = ttr.world_to_clip(w_t, _t(cfw))
        _close(c_t, c_j)
        np.testing.assert_array_equal(
            ttr.in_frustum(c_t[..., :3]).numpy(), np.asarray(jtr.in_frustum(c_j[..., :3]))
        )


@pytest.mark.parametrize("bits", [32, 24, 16])
@pytest.mark.parametrize("case", CASES[::2], ids=CASE_IDS[::2])
def test_radix_depth_key_bit_exact(case, bits):
    kind, n, seed, w, h = case
    a = cloud_arrays(kind, n, seed)
    jc, tc = cameras(w, h)
    mt = np.eye(4, dtype=np.float32)
    cfw = np.asarray(jc.clip_from_view @ jc.view_from_world)
    kj = np.asarray(jsort.radix_depth_key(
        jnp.asarray(a["position_visibility"][:, :3]), jnp.asarray(mt), jnp.asarray(cfw),
        jc.world_position, bits,
    )).astype(np.int64)
    kt = tsort.radix_depth_key(
        _t(a["position_visibility"][:, :3]), _t(mt), tc.clip_from_world, tc.world_position, bits
    )
    assert kt.dtype == torch.int64
    mismatches = int((kt.numpy() != kj).sum())
    # a one-ulp difference in dist2 between XLA and torch would show here
    # as a count; none is found on the CPU
    assert mismatches == 0, f"{mismatches} of {n} keys differ"
    assert int(kt.max()) <= (1 << bits) - 1 and int(kt.min()) >= 0
    culled = kt.numpy() == (tsort.SENTINEL_KEY >> (32 - bits))
    assert culled.sum() == (kj == int(jsort.SENTINEL_KEY) >> (32 - bits)).sum()


def test_safe_sqrt_and_cutoff(inputs):
    x = np.linspace(-2, 5, 101).astype(np.float32)
    _close(tcov.safe_sqrt(_t(x)), jcov.safe_sqrt(jnp.asarray(x)))
    op = np.linspace(0, 1, 57).astype(np.float32)
    for adaptive in (True, False):
        _close(tcov.opacity_cutoff(_t(op), adaptive), jcov.opacity_cutoff(jnp.asarray(op), adaptive))


def test_rotation_and_cov3d(inputs):
    q = inputs["quat"]
    _close(tcov.quat_to_rotation_matrix(_t(q)), jcov.quat_to_rotation_matrix(jnp.asarray(q)))
    for gs, mt in ((1.0, None), (1.7, inputs["mt"])):
        j = jcov.compute_cov3d(jnp.asarray(q), jnp.asarray(inputs["scale"]), gs,
                               None if mt is None else jnp.asarray(mt))
        t = tcov.compute_cov3d(_t(q), _t(inputs["scale"]), gs, None if mt is None else _t(mt))
        _close(t, j)


def test_cov2d_eigen_obb(inputs):
    cam = inputs["cam"]
    q, s, pos = inputs["quat"], inputs["scale"], inputs["pos"]
    c3 = jcov.compute_cov3d(jnp.asarray(q), jnp.asarray(s))
    vp = jnp.asarray([128.0, 120.0])
    c2_j = jcov.cov2d(jnp.asarray(pos), c3, cam.view_from_world, cam.clip_from_view, vp)
    c2_t = tcov.cov2d(_t(pos), _t(c3), _t(cam.view_from_world), _t(cam.clip_from_view), _t(vp))
    _close(c2_t, c2_j)
    # eigen/OBB on the SAME covariances (removes the cov2d ulps)
    c2 = np.asarray(c2_j)
    for a, b in zip(tcov.cov2d_eigen(_t(c2)), jcov.cov2d_eigen(jnp.asarray(c2))):
        _close(a, b)
    cut = np.full(c2.shape[0], 3.0, np.float32)
    for a, b in zip(tcov.obb_axes(_t(c2), _t(cut)), jcov.obb_axes(jnp.asarray(c2), jnp.asarray(cut))):
        _close(a, b)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_basis_and_lookup(inputs, degree):
    d = inputs["dirs"]
    _close(tsh.sh_basis(_t(d), degree), jsh.sh_basis(jnp.asarray(d), degree))
    width = bgs.sh_coeff_width(degree)
    sh = inputs["sh"][:, :width]
    _close(tsh.spherical_harmonics_lookup(_t(d), _t(sh)),
           jsh.spherical_harmonics_lookup(jnp.asarray(d), jnp.asarray(sh)))


def test_srgb_and_local_direction(inputs):
    x = np.linspace(-0.5, 1.5, 203).astype(np.float32)
    _close(tsh.srgb_to_linear(_t(x)), jsh.srgb_to_linear(jnp.asarray(x)))
    d, mt = inputs["dirs"], inputs["mt"]
    _close(tsh.world_to_local_direction(_t(d), _t(mt)),
           jsh.world_to_local_direction(jnp.asarray(d), jnp.asarray(mt)))


PROJECT_KEYS = ["center_ndc", "depth2", "cutoff", "obb_bounds", "obb_axis", "rgb", "alpha"]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_project_and_pack(case):
    kind, n, seed, w, h = case
    a = cloud_arrays(kind, n, seed)
    jc, tc = cameras(w, h)
    js = jproject(jax_cloud(a), jc, bgs.CloudSettings())
    ts = tproject(torch_cloud(a), tc, TSettings())
    assert set(PROJECT_KEYS + ["mask"]) <= set(ts)
    np.testing.assert_array_equal(ts["mask"].numpy(), np.asarray(js["mask"]))
    kj = jsort.radix_depth_key(
        jax_cloud(a).position, jnp.eye(4, dtype=jnp.float32), jc.clip_from_view @ jc.view_from_world,
        jc.world_position, 32,
    )
    np.testing.assert_array_equal(ts["sort_key"].numpy(), np.asarray(kj).astype(np.int64))
    m = np.asarray(js["mask"])
    for k in PROJECT_KEYS:
        # depth2 is ~3600: relative 1e-5 is its ulp scale
        np.testing.assert_allclose(ts[k].numpy()[m], np.asarray(js[k])[m], err_msg=k, **TOL)
    jcols = jpack(js, bgs.CloudSettings(), w, h)
    tcols = tpack(ts, TSettings(), w, h)
    assert len(tcols) == len(jcols) == 10
    for i, (t, j) in enumerate(zip(tcols, jcols)):
        np.testing.assert_allclose(t.numpy()[m], np.asarray(j)[m], err_msg=f"col {i}", **TOL)


def test_project_rejects_other_modes():
    a = cloud_arrays("wide", 8, 0)
    _, tc = cameras(32, 32)
    from bevy_gaussian_splatting_tpu_torch.models import settings as ts

    # 4DGS renders a Gaussian4dCloud only (the JAX package fails on a 3D
    # cloud's missing right quaternion)
    for s in (ts.CloudSettings(gaussian_mode=ts.GaussianMode.GAUSSIAN_4D),
              ts.CloudSettings(gaussian_mode=ts.GaussianMode.GAUSSIAN_4D, rasterize_mode=ts.RasterizeMode.VELOCITY)):
        with pytest.raises(TypeError, match="Gaussian4dCloud"):
            tproject(torch_cloud(a), tc, s)


def test_project_rejects_velocity_without_4dgs():
    """As the JAX package's projection (ops/project.py:242-243)."""
    a = cloud_arrays("wide", 8, 0)
    _, tc = cameras(32, 32)
    from bevy_gaussian_splatting_tpu_torch.models import settings as ts

    with pytest.raises(ValueError, match="GAUSSIAN_4D"):
        tproject(torch_cloud(a), tc, ts.CloudSettings(rasterize_mode=ts.RasterizeMode.VELOCITY))
