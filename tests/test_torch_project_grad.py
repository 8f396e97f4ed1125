"""The 3DGS training projection's hand-derived backward (``ops/cuda/project.py``
``ProjectCore``), on the CPU, where it runs its plain versions: the forward
the eager chain (``project_splats_plain``), the backward the PyTorch twin of
the CUDA kernel (``project_backward_plain``).

  - the twin's leaf gradients (position_visibility, rotation, scale_opacity)
    against ``torch.autograd`` through ``project_splats_plain``, under a
    random cotangent of the packed rows, in float64 (``F64_BAR``) and float32
    (``F32_BAR``, norm of the difference over norm): OBB and AABB, the
    adaptive cutoff on and off, the identity and a model transform, culled
    and masked splats (behind the camera, off the frustum, SELECTED and
    HIGHLIGHT_SELECTED), near-isotropic 2D covariances, and quaternions far
    from unit length;
  - the same against ``jax.grad`` of the JAX package's projection and
    packing, per leaf within ``JAX_BAR`` of its largest |gradient|;
  - the dispatch rule ``trained_projection_applies`` (a trained 3D cloud in
    COLOR on the card; 4DGS, 2DGS, DEPTH and the other modes, the
    precomputed-covariance cloud, a model transform that requires grad, no
    grad and the CPU keep the eager chain), with the card faked as in
    tests/test_torch_project_fused.py; and a render through the function:
    one node of it in the graph, the eager chain's rows bit for bit.

The kernels (``csrc/project.cu`` project_train_kernel, project_bwd_kernel)
are held to the eager chain and to this twin on the card by
tests/test_torch_cuda.py."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    Gaussian3dCloud,
    Gaussian3dCovCloud,
    Gaussian4dCloud,
    cloud_from_numpy,
    precompute_covariance_3d,
    random_arrays_4d_seeded,
)
from bevy_gaussian_splatting_tpu_torch.models.settings import (
    CloudSettings,
    DrawMode,
    GaussianColorSpace,
    GaussianMode,
    RasterizeMode,
)
from bevy_gaussian_splatting_tpu_torch.ops import covariance as cov_ops
from bevy_gaussian_splatting_tpu_torch.ops import project as op
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.cuda import project as pj
from bevy_gaussian_splatting_tpu_torch.ops.transforms import apply_transform
from bevy_gaussian_splatting_tpu_torch.train.losses import mse
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud
from bevy_gaussian_splatting_tpu_torch.utils import trace
from torch_port_cases import cameras, cloud_arrays, jax_cloud, jax_splats, rel_gap

LEAVES = ("position_visibility", "rotation", "scale_opacity")
F64_BAR = 1e-8  # float64: the derivative is autograd's up to rounding
F32_BAR = 1e-3  # float32, well-conditioned rows (measured <= 1.7e-4)
JAX_BAR = 1e-3  # per leaf, of its largest |jax.grad|
N = 1000
_LINEAR = GaussianColorSpace.LIN_REC709_DISPLAY


def _model_transform(dtype=torch.float32):
    """A rotation about a tilted axis, an anisotropic scale and a shift."""
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]) @ np.array(
        [[1.0, 0.0, 0.0], [0.0, np.cos(0.3), -np.sin(0.3)], [0.0, np.sin(0.3), np.cos(0.3)]]
    )
    m = np.eye(4)
    m[:3, :3] = rot * np.array([1.3, 0.8, 1.1])
    m[:3, 3] = [1.5, -2.0, 0.5]
    return torch.tensor(m, dtype=dtype)


def _arrays(kind: str, n: int, seed: int) -> dict:
    """The bench cloud with quaternions scaled off unit length (x 0.3-3),
    a mix of visibilities, and per ``kind``: "culled" rows behind the
    camera, off the frustum and at its edges; "iso" equal scales near the
    optical axis (near-isotropic 2D covariances); "quat" quaternions scaled
    by 1e-2 to 1e2."""
    a = cloud_arrays("bench", n, seed)
    rng = np.random.default_rng(seed + 50)
    a["rotation"] = a["rotation"] * rng.uniform(0.3, 3.0, (n, 1)).astype(np.float32)
    a["position_visibility"][:, 3] = rng.choice(np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32), n)
    k = np.arange(n) % 8
    if kind == "culled":
        pv = a["position_visibility"]
        pv[k == 0, 2] = rng.uniform(62.0, 90.0, int((k == 0).sum()))  # behind the camera at z = 60
        pv[k == 1, :2] *= 40.0  # off the frustum
        pv[k == 2, 0] = rng.uniform(24.0, 26.0, int((k == 2).sum()))  # astride its edge
        a["scale_opacity"][k == 3, 3] = 0.0  # opacity 0: the cutoff's clamps
    elif kind == "iso":
        so = a["scale_opacity"]
        so[:, 1] = so[:, 0]
        so[:, 2] = so[:, 0]
        # unit quaternions: an isotropic Sigma, seen near the optical axis
        a["rotation"] = a["rotation"] / np.linalg.norm(a["rotation"], axis=1, keepdims=True)
        a["position_visibility"][:, :3] *= np.float32(0.02)
    elif kind == "quat":
        a["rotation"] = a["rotation"] * (10.0 ** rng.uniform(-2.0, 2.0, (n, 1))).astype(np.float32)
    return a


# (cloud kind, settings, model transform)
CASES = {
    "obb": ("bench", CloudSettings(), False),
    "aabb": ("bench", CloudSettings(aabb=True), False),
    "obb-fixed-cutoff": ("bench", CloudSettings(opacity_adaptive_radius=False), False),
    "aabb-fixed-cutoff-linear": (
        "bench", CloudSettings(aabb=True, opacity_adaptive_radius=False, color_space=_LINEAR), False),
    "obb-transform": ("bench", CloudSettings(), True),
    "aabb-transform": ("bench", CloudSettings(aabb=True), True),
    "obb-culled-selected": ("culled", CloudSettings(draw_mode=DrawMode.SELECTED), False),
    "aabb-culled-highlight-transform": (
        "culled", CloudSettings(aabb=True, draw_mode=DrawMode.HIGHLIGHT_SELECTED), True),
    "obb-near-isotropic": ("iso", CloudSettings(), False),
    "aabb-near-isotropic": ("iso", CloudSettings(aabb=True), False),
    "obb-unnormalised-quaternions": ("quat", CloudSettings(), True),
}


def _camera(dtype):
    cam = Camera.create(eye=(3.0, 4.0, 60.0), width=64, height=48, device="cpu")
    return dataclasses.replace(cam, **{f.name: getattr(cam, f.name).to(dtype) for f in dataclasses.fields(cam)
                                       if isinstance(getattr(cam, f.name), torch.Tensor)})


@contextlib.contextmanager
def _in(dtype, monkeypatch):
    """Both paths in ``dtype``: float64 needs the float32 cast of the cloud
    left out and the radix key taken from float32 distances (it reads their
    bits); neither enters a gradient."""
    if dtype == torch.float64:
        key = sort_ops.depth_key
        with monkeypatch.context() as m:
            m.setattr(op, "as_float32", lambda cloud: cloud)
            m.setattr(pj, "as_float32", lambda cloud: cloud)
            m.setattr(sort_ops, "depth_key", lambda dist2, visible, bits=32: key(dist2.float(), visible, bits))
            yield
    else:
        yield


def _grads(fn, case: str, dtype, monkeypatch, seed: int = 3) -> tuple:
    """(rows, leaf gradients) of ``fn`` (a projection) under a seeded
    cotangent of the packed rows."""
    kind, settings, transform = CASES[case]
    a = _arrays(kind, N, seed)
    leaves = {k: torch.tensor(v, dtype=dtype, requires_grad=True) for k, v in a.items()}
    model = _model_transform(dtype) if transform else None
    if model is None and dtype == torch.float64:
        model = torch.eye(4, dtype=dtype)  # the chain's default identity is float32
    with _in(dtype, monkeypatch):
        out = fn(Gaussian3dCloud(**leaves), _camera(dtype), settings, model)
    g = torch.tensor(np.random.default_rng(seed + 7).normal(size=(N, 10)), dtype=dtype)
    g[::5] = 0.0  # rows with no cotangent
    grads = torch.autograd.grad((out["params"] * g).sum(), [leaves[k] for k in LEAVES + ("spherical_harmonic",)])
    return out, dict(zip(LEAVES + ("spherical_harmonic",), grads))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_autograd_through_the_eager_chain(case, dtype, monkeypatch):
    """The trained path on the CPU (the eager chain forward, the twin
    backward) against autograd through ``project_splats_plain``: the same
    rows and binning fields bit for bit, the same ``d_sh`` bit for bit
    (the colour stage is shared), the three geometric leaves within the
    dtype's bar; the visibility channel's gradient is 0."""
    got, g_got = _grads(pj.project_splats_trained, case, dtype, monkeypatch)
    want, g_want = _grads(pj.project_splats_plain, case, dtype, monkeypatch)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name].detach(), want[name].detach()), name
    assert bool(want["mask"].any())
    if CASES[case][0] == "culled":
        assert not bool(want["mask"].all())
    assert torch.equal(g_got["spherical_harmonic"], g_want["spherical_harmonic"])
    assert not bool(g_got["position_visibility"][:, 3].any())
    # rows the forward itself overflows (a conic of a splat behind the
    # camera whose determinant rounds to 0) have no gradient to compare
    rows = torch.isfinite(want["params"].detach()).all(dim=1)
    assert int(rows.sum()) >= 0.99 * N
    if dtype == torch.float64:
        gaps = {k: rel_gap(g_got[k][rows], g_want[k][rows]) for k in LEAVES}
        print(f"{case} float64: {gaps}")
        assert all(v <= F64_BAR for v in gaps.values()), gaps
        return
    # float32: on the rows whose OBB axis is well-conditioned, within
    # F32_BAR of autograd; on every row, no farther from float64 autograd
    # than float32 autograd is (the error of both is the forward's rounding,
    # which an ill-conditioned axis amplifies)
    _, exact = _grads(pj.project_splats_plain, case, torch.float64, monkeypatch)
    well = rows & _well_conditioned(case)
    gaps = {k: rel_gap(g_got[k][well], g_want[k][well]) for k in LEAVES} if bool(well.any()) else {}
    far = {k: (rel_gap(g_got[k][rows], exact[k][rows]), rel_gap(g_want[k][rows], exact[k][rows])) for k in LEAVES}
    print(f"{case} float32: well-conditioned {int(well.sum())} {gaps}, against float64 (twin, autograd) {far}")
    assert all(v <= F32_BAR for v in gaps.values()), gaps
    assert all(twin <= 1.25 * eager + 1e-6 for twin, eager in far.values()), far


def _well_conditioned(case: str) -> torch.Tensor:
    """Rows whose 2D covariance is not diagonal to rounding, |sxy| >= 1e-3
    (sxx + syy) (benchmark/reference/splat.py well_conditioned): elsewhere
    the OBB axis's, and a circular covariance's radius's, float32 gradient
    is rounding noise in any evaluation."""
    kind, settings, transform = CASES[case]
    a = _arrays(kind, N, 3)
    model = _model_transform() if transform else torch.eye(4)
    cam = _camera(torch.float32)
    world = apply_transform(model, torch.from_numpy(a["position_visibility"][:, :3]))
    cov3 = cov_ops.compute_cov3d(torch.from_numpy(a["rotation"]), torch.from_numpy(a["scale_opacity"][:, :3]),
                                 settings.global_scale, model)
    sxx, sxy, syy = cov_ops.cov2d(world, cov3, cam.view_from_world, cam.clip_from_view, cam.viewport[2:]).unbind(-1)
    return sxy.abs() >= 1e-3 * (sxx + syy)


def test_twin_reads_zero_cotangents_as_none():
    """A None cotangent (an output autograd left out) is zeros."""
    a = _arrays("bench", 64, 1)
    leaves = [torch.tensor(a[k]) for k in LEAVES]
    cam = _camera(torch.float32)
    mask = torch.ones(64, dtype=torch.bool)
    none = pj.project_backward_plain(*leaves, mask, None, None, None, cam, CloudSettings(), None, 64, 48)
    zeros = pj.project_backward_plain(*leaves, mask, torch.zeros(64, 6), torch.zeros(64, 1), torch.zeros(64, 3),
                                      cam, CloudSettings(), None, 64, 48)
    for x, y in zip(none, zeros):
        assert torch.equal(x, y) and not bool(x.any())


def _jax_grads(arrays: dict, settings_kw: dict, g: np.ndarray, width: int, height: int):
    import jax
    import jax.numpy as jnp

    import bevy_gaussian_splatting_tpu as bgs
    from bevy_gaussian_splatting_tpu.ops.rasterize_tile import pack_raster_params

    jc, _ = cameras(width, height, eye=(3.0, 4.0, 60.0))
    settings = bgs.CloudSettings(**settings_kw)

    def loss(cloud):
        rows = pack_raster_params(jax_splats(cloud, jc, settings), settings, width, height)
        return jnp.sum(rows * jnp.asarray(g))

    grads = jax.grad(loss)(jax_cloud(arrays))
    return {k: np.asarray(getattr(grads, k)) for k in LEAVES}


@pytest.mark.parametrize("aabb", [False, True], ids=["obb", "aabb"])
def test_twin_matches_jax_grad(aabb):
    """The trained path's leaf gradients against ``jax.grad`` of the JAX
    package's projection and packing (``pack_raster_params``), per leaf
    within JAX_BAR of its largest |gradient|."""
    a = _arrays("bench", 500, 11)
    g = np.random.default_rng(12).normal(size=(500, 10)).astype(np.float32)
    want = _jax_grads(a, {"aabb": aabb}, g, 64, 48)
    model = TrainableCloud(cloud_from_numpy(a, "cpu"))
    _, cam = cameras(64, 48, eye=(3.0, 4.0, 60.0))
    out = pj.project_splats_trained(model.cloud(), cam, CloudSettings(aabb=aabb))
    (out["params"] * torch.from_numpy(g)).sum().backward()
    for k in LEAVES:
        got = getattr(model, k).grad.numpy()
        top = float(np.abs(want[k]).max())
        gap = float(np.abs(got - want[k]).max())
        print(f"{k}: {gap:.3e} of {top:.3e}")
        assert gap <= JAX_BAR * top, (k, gap, top)


# --- the dispatch rule -------------------------------------------------------

S3 = CloudSettings()


@pytest.fixture
def on_card(monkeypatch):
    """The cloud classes report a CUDA device; their tensors stay here."""
    for cls in (Gaussian3dCloud, Gaussian4dCloud, Gaussian3dCovCloud):
        monkeypatch.setattr(cls, "device", property(lambda self: torch.device("cuda", 0)))


def _trained(kind: str = "3d"):
    if kind == "4d":
        return TrainableCloud(cloud_from_numpy(random_arrays_4d_seeded(64, seed=1), "cpu")).cloud()
    cloud = cloud_from_numpy(cloud_arrays("bench", 64, 1), "cpu")
    if kind == "cov":
        return TrainableCloud(precompute_covariance_3d(cloud)).cloud()
    return TrainableCloud(cloud).cloud()


@pytest.mark.parametrize("settings", [
    S3, CloudSettings(aabb=True), CloudSettings(opacity_adaptive_radius=False, color_space=_LINEAR),
    CloudSettings(draw_mode=DrawMode.HIGHLIGHT_SELECTED), CloudSettings(visualize_bounding_box=True),
], ids=["obb", "aabb", "fixed-cutoff-linear", "highlight", "bbox"])
def test_rule_takes_a_trained_3d_cloud_on_the_card(on_card, settings):
    cloud = _trained()
    assert not pj.fused_projection_applies(cloud, settings)
    assert pj.trained_projection_applies(cloud, settings)
    assert pj.trained_projection_applies(cloud, settings, _model_transform())


@pytest.mark.parametrize("kind,settings", [
    ("4d", CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D)),
    ("3d", CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)),
    ("cov", S3),
    *[("3d", S3.replace(rasterize_mode=m)) for m in RasterizeMode if m != RasterizeMode.COLOR],
], ids=["4d", "2dgs", "cov", *[m.name for m in RasterizeMode if m != RasterizeMode.COLOR]])
def test_rule_leaves_the_rest_to_the_eager_chain(on_card, kind, settings):
    assert not pj.trained_projection_applies(_trained(kind), settings)


def test_rule_leaves_a_transform_with_grad_no_grad_and_the_cpu_to_the_eager_chain(on_card, monkeypatch):
    cloud = _trained()
    assert not pj.trained_projection_applies(cloud, S3, _model_transform().requires_grad_())
    with torch.no_grad():
        assert not pj.trained_projection_applies(cloud, S3)
        assert pj.fused_projection_applies(cloud, S3)  # the serving kernel's
    # grad enabled, but no field requires it: nothing to carry back
    assert not pj.trained_projection_applies(cloud_from_numpy(cloud_arrays("bench", 64, 1), "cpu"), S3)
    monkeypatch.undo()
    assert not pj.trained_projection_applies(_trained(), S3)


def _graph_nodes(root):
    seen, stack, nodes = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        nodes.append(node)
        stack.extend(fn for fn, _ in node.next_functions)
    return nodes


@pytest.mark.parametrize("aabb", [False, True], ids=["obb", "aabb"])
def test_a_trained_render_takes_the_function(on_card, aabb):
    """On the (faked) card a training render's projection is one
    ``ProjectCore`` node: its rows are the eager chain's bits, it counts
    ``project.calls`` and ``sh.calls`` (no kernel ran here, so not
    ``project.fused``), no slice of a geometric leaf is in the graph, and
    the leaves' gradients are the eager render's within F32_BAR."""
    settings = CloudSettings(aabb=aabb)
    a = cloud_arrays("bench", 400, 2)
    cam = Camera.create(eye=(2.0, 1.0, 60.0), width=48, height=48, device="cpu")
    target = torch.zeros((48, 48, 4))

    def render(take):
        model = TrainableCloud(cloud_from_numpy(a, "cpu"))
        with pytest.MonkeyPatch.context() as m:
            if not take:
                m.setattr(pj, "trained_projection_applies", lambda *args: False)
            before = trace.counters()
            # an explicit transform: the default one is made on the (faked) card
            image = rt.render_tiled(model.cloud(), cam, settings, torch.eye(4))
            after = trace.counters()
        counts = {k: after.get(k, 0) - before.get(k, 0) for k in ("project.calls", "project.fused", "sh.calls")}
        loss = mse(image, target)
        names = [type(n).__name__ for n in _graph_nodes(loss.grad_fn)]
        loss.backward()
        return image.detach(), {k: getattr(model, k).grad for k in LEAVES}, counts, names

    img, grads, counts, names = render(True)
    img_eager, grads_eager, counts_eager, names_eager = render(False)
    assert torch.equal(img, img_eager)
    assert counts == {"project.calls": 1, "project.fused": 0, "sh.calls": 1} == counts_eager
    assert names.count("ProjectCoreBackward") == 1 and "ProjectCoreBackward" not in names_eager
    assert names.count("SliceBackward0") < names_eager.count("SliceBackward0")
    for k in LEAVES:
        assert rel_gap(grads[k], grads_eager[k]) <= F32_BAR, k
        assert float(grads[k].abs().max()) > 0, k
