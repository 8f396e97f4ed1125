"""The fused serving projection's dispatch rule and its plain version, on the
CPU (``ops/cuda/project.py``; the 3D and 4D kernels are held to the eager
chain on the card by tests/test_torch_cuda.py, the 2DGS surfel kernel by
the card cases at the end of this file, which skip without a card).

``fused_projection_applies`` must take the kernel only for a cloud on the
card that carries no grad, in COLOR, of the class its gaussian mode
renders; "on the card" is faked here by giving the cloud classes a CUDA
``device`` (the rule reads nothing else of the device).  Every
``project_for_binning`` call counts ``project.calls``, the eager path's too.
No JAX."""

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
    random_arrays_3d_seeded,
    random_arrays_4d_seeded,
    surfel_grid_arrays,
)
from bevy_gaussian_splatting_tpu_torch.models.settings import (
    CloudSettings,
    DrawMode,
    GaussianColorSpace,
    GaussianMode,
    RadixSortDepthBits,
    RasterizeMode,
)
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import project as pj
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians
from bevy_gaussian_splatting_tpu_torch.ops.sort import SENTINEL_KEY
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud
from bevy_gaussian_splatting_tpu_torch.utils import trace

S3 = CloudSettings()  # the gs3d-1m configuration's settings (benchmark/traffic/serve.py)
S4 = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D)  # gs4d-1m's
S2 = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)  # gs2d-1m's (benchmark/traffic/serve_2d.py)
SETTINGS = {"3d": S3, "4d": S4, "2d": S2}


def _cloud(kind: str, n: int = 64):
    if kind in ("3d", "2d"):  # a surfel cloud is a Gaussian3dCloud
        return cloud_from_numpy(random_arrays_3d_seeded(n, seed=1), "cpu")
    if kind == "4d":
        return cloud_from_numpy(random_arrays_4d_seeded(n, seed=1), "cpu")
    return precompute_covariance_3d(_cloud("3d", n))


@pytest.fixture
def on_card(monkeypatch):
    """The cloud classes report a CUDA device; their tensors stay here."""
    for cls in (Gaussian3dCloud, Gaussian4dCloud, Gaussian3dCovCloud):
        monkeypatch.setattr(cls, "device", property(lambda self: torch.device("cuda", 0)))


@pytest.mark.parametrize("kind,settings", [("3d", S3), ("4d", S4), ("3d", CloudSettings(aabb=True)), ("2d", S2)])
def test_rule_is_off_on_the_cpu(kind, settings):
    assert not pj.fused_projection_applies(_cloud(kind), settings)


@pytest.mark.parametrize("name,settings", [
    ("3d", S3), ("4d", S4),
    ("3d-aabb", CloudSettings(aabb=True)),
    ("3d-fixed-cutoff-linear", CloudSettings(opacity_adaptive_radius=False,
                                             color_space=GaussianColorSpace.LIN_REC709_DISPLAY)),
    ("3d-selected", CloudSettings(draw_mode=DrawMode.SELECTED)),
    ("3d-highlight-bbox", CloudSettings(draw_mode=DrawMode.HIGHLIGHT_SELECTED, visualize_bounding_box=True)),
    ("4d-aabb-highlight", CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D, aabb=True,
                                        draw_mode=DrawMode.HIGHLIGHT_SELECTED)),
    ("2d", S2),  # 2DGS surfels
])
def test_rule_takes_the_configurations_on_the_card(on_card, name, settings):
    cloud = _cloud(name[:2])
    assert pj.fused_projection_applies(cloud, settings)
    # a transform and a time that carry no grad change nothing
    assert pj.fused_projection_applies(cloud, settings, torch.eye(4), torch.tensor(0.5))
    with torch.no_grad():
        assert pj.fused_projection_applies(cloud, settings, None, None)


@pytest.mark.parametrize("what", ["field", "transform", "time"])
@pytest.mark.parametrize("kind", ["3d", "4d", "2d"])
def test_rule_leaves_grad_to_the_eager_chain(on_card, kind, what):
    cloud = _cloud(kind)
    settings = SETTINGS[kind]
    model, time = None, None
    if what == "field":
        cloud = dataclasses.replace(cloud, scale_opacity=cloud.scale_opacity.clone().requires_grad_())
    elif what == "transform":
        model = torch.eye(4, requires_grad=True)
    else:
        time = torch.tensor(0.25, requires_grad=True)
    assert not pj.fused_projection_applies(cloud, settings, model, time)
    # with grad off nothing is carried back: the kernel applies
    with torch.no_grad():
        assert pj.fused_projection_applies(cloud, settings, model, time)


def test_rule_leaves_a_trained_cloud_to_the_eager_chain(on_card):
    model = TrainableCloud(_cloud("3d"))
    assert not pj.fused_projection_applies(model.cloud(), S3)


@pytest.mark.parametrize("mode", [m for m in RasterizeMode if m != RasterizeMode.COLOR], ids=lambda m: m.name)
@pytest.mark.parametrize("kind", ["3d", "4d", "2d"])
def test_rule_leaves_the_other_rasterize_modes_to_the_eager_chain(on_card, kind, mode):
    base = SETTINGS[kind]
    assert not pj.fused_projection_applies(_cloud(kind), base.replace(rasterize_mode=mode))


@pytest.mark.parametrize("kind,settings", [
    ("cov", S3),  # the precomputed-covariance cloud
    ("4d", S3),  # a class the mode does not render
    ("3d", S4),
])
def test_rule_leaves_other_modes_and_cloud_classes_to_the_eager_chain(on_card, kind, settings):
    assert not pj.fused_projection_applies(_cloud(kind), settings)


def _extents(settings) -> set:
    if settings.gaussian_mode == GaussianMode.GAUSSIAN_2D:
        return {"surfel_radius"}
    return {"radius_vp"} if settings.aabb else {"obb_axis", "obb_bounds"}


def _eager_rows(cloud, cam, settings, size, **kw):
    """The eager chain (``project_gaussians``) with the radix key's sentinel
    cull folded into its mask, and its rows packed for ``size``: what every
    path's dict is held to."""
    splats = project_gaussians(cloud, cam, settings, **kw)
    splats["mask"] = splats["mask"] & (splats["sort_key"] != SENTINEL_KEY)
    return splats, torch.stack(pj.pack_raster_param_cols(splats, settings, *size), dim=-1)


def _assert_is_the_eager_chain(got, cloud, cam, settings, size, **kw):
    """``got`` has the one key set, the eager chain's binning fields and its
    rows packed for ``size``, bit for bit."""
    ref, rows = _eager_rows(cloud, cam, settings, size, **kw)
    assert set(got) == {"mask", "center_ndc", "sort_key", "params"} | _extents(settings)
    for name in set(got) - {"params"}:
        assert torch.equal(got[name], ref[name]), name
    assert got["params"].shape == rows.shape
    assert torch.equal(got["params"].view(torch.int32), rows.view(torch.int32))
    assert bool(ref["mask"].any())


@pytest.mark.parametrize("kind,settings", [("3d", S3), ("3d", CloudSettings(aabb=True)), ("4d", S4), ("2d", S2)])
def test_project_calls_counts_the_eager_path(kind, settings):
    """On the CPU every call runs the eager chain: ``project.calls`` counts
    it, ``project.fused`` does not move, and a frame of ``render_tiled``
    projects once.  The eager path gives the one key set, its rows packed
    for the camera's size."""
    cloud = _cloud(kind, 256)
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=64, height=48, device="cpu")
    before = trace.counters()
    splats = rt.project_for_binning(cloud, cam, settings)
    _assert_is_the_eager_chain(splats, cloud, cam, settings, (64, 48))
    rt.render_tiled(cloud, cam, settings, differentiable=False)
    after = trace.counters()
    assert after["project.calls"] - before.get("project.calls", 0) == 2
    assert after.get("project.fused", 0) == before.get("project.fused", 0)


@pytest.mark.parametrize("kind,settings", [
    ("3d", S3), ("3d", CloudSettings(aabb=True, draw_mode=DrawMode.HIGHLIGHT_SELECTED)), ("4d", S4),
])
def test_plain_version_is_the_serving_eager_path(kind, settings):
    """``project_splats`` on the CPU (the plain version) and
    ``project_for_binning`` give the eager chain's binning fields and its
    rows, packed for the camera's size by default and for ``size`` where
    asked, bit for bit."""
    cloud = _cloud(kind, 256)
    cam = Camera.create(eye=(2.0, 1.0, 60.0), width=64, height=48, device="cpu")
    _assert_is_the_eager_chain(pj.project_splats(cloud, cam, settings, time=0.3), cloud, cam, settings, (64, 48),
                               time=0.3)
    other = rt.project_for_binning(cloud, cam, settings, time=0.3, size=(96, 80))
    _assert_is_the_eager_chain(other, cloud, cam, settings, (96, 80), time=0.3)


def test_plain_version_is_the_serving_eager_path_for_surfels():
    """Under 2DGS the plain version gives the eager chain's binning fields
    (``surfel_radius`` the extent) and its 16-column surfel rows bit for
    bit.  A surfel row holds the width in A and B: rows for another size,
    taller or wider, are packed for it."""
    cloud = _cloud("2d", 256)
    cam = Camera.create(eye=(2.0, 1.0, 60.0), width=64, height=48, device="cpu")
    got = pj.project_splats(cloud, cam, S2)
    assert got["params"].shape == (256, 16)
    _assert_is_the_eager_chain(got, cloud, cam, S2, (64, 48))
    for size in ((64, 80), (96, 48)):
        _assert_is_the_eager_chain(pj.project_splats(cloud, cam, S2, size=size), cloud, cam, S2, size)


def test_plain_version_takes_what_the_kernel_does_not(monkeypatch):
    """What the rule leaves out (another rasterize mode, the precomputed-
    covariance cloud) takes the plain version: ``project_splats`` asks the
    rule and gives the eager chain's dict, the DEPTH ramp's range passed
    through, with no kernel launch."""
    asked = []

    def rule(cloud, settings, *tensors):
        asked.append(settings.rasterize_mode)
        return False

    monkeypatch.setattr(pj, "fused_projection_applies", rule)
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=64, height=48, device="cpu")
    depth = S3.replace(rasterize_mode=RasterizeMode.DEPTH)
    before = trace.counters().get("project.fused", 0)
    cases = [(_cloud("cov"), S3, None), (_cloud("3d"), depth, None),
             (_cloud("3d"), depth, (torch.tensor(55.0), torch.tensor(65.0)))]
    rows = []
    for cloud, settings, dm in cases:
        got = pj.project_splats(cloud, cam, settings, depth_minmax=dm)
        _assert_is_the_eager_chain(got, cloud, cam, settings, (64, 48), depth_minmax=dm)
        rows.append(got["params"])
    assert asked == [RasterizeMode.COLOR, RasterizeMode.DEPTH, RasterizeMode.DEPTH]
    assert trace.counters().get("project.fused", 0) == before
    # the ramp's range reaches the colour columns
    assert not torch.equal(rows[1][:, 6:9], rows[2][:, 6:9])
    assert np.isfinite(rows[0].numpy()).any()


# The 2DGS surfel kernel (csrc/project.cu project_kernel_2d) against the eager
# chain on the card, bit for bit: the chain's own arithmetic, its float64
# multiply-add emulation (gaussian_2d.py _fma) taken as one fmaf.  The two
# round apart only where the float64 sum lands on a float32 tie, which no
# case here reaches; a difference would show as a row of A, B or C one ulp
# off and fail the test.  One exception, bounded below: a cloud of a few
# rows (the 16-surfel grid) takes another cuBLAS kernel for the chain's
# clip product ([N, 3] @ [3, 3]), which sums in another order than the one
# the kernel copies, so the NDC centre (and the rows' copy of it) may lie
# a few ulps apart; the same rows repeated to 4096 take the large-N
# kernel and are bitwise.
SMALL_CLOUD = 64  # rows below which the clip product's order is cuBLAS's choice
SMALL_CENTRE_ULPS = 4
_LINEAR = GaussianColorSpace.LIN_REC709_DISPLAY
SURFEL_EYE = (2.5, 2.0, 6.0)  # tools/surfel_plane.py's camera


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _model_transform(device):
    """A rotation about a tilted axis, an anisotropic scale and a shift."""
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]) @ np.array(
        [[1.0, 0.0, 0.0], [0.0, np.cos(0.3), -np.sin(0.3)], [0.0, np.sin(0.3), np.cos(0.3)]]
    )
    m = np.eye(4)
    m[:3, :3] = rot * np.array([1.3, 0.8, 1.1])
    m[:3, 3] = [1.5, -2.0, 0.5]
    return torch.tensor(m, dtype=torch.float32, device=device)


def _edge_on_arrays(n: int, seed: int) -> dict:
    """Surfels seen edge-on from (0, 0, 60): each disk's normal turned into
    the image plane (a quarter turn about y, then a turn about the view
    axis), off by 0, 1e-6, 1e-4 or 1e-2 rad, about the view axis, so that
    the validity test and the extents are cancellations."""
    a = random_arrays_3d_seeded(n, seed=seed)
    rng = np.random.default_rng(seed)
    tilt = np.pi / 2 + rng.choice(np.array([0.0, 1e-6, -1e-6, 1e-4, -1e-4, 1e-2]), n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    qy = np.stack([np.cos(tilt / 2), np.zeros(n), np.sin(tilt / 2), np.zeros(n)], axis=1)
    qz = np.stack([np.cos(phi / 2), np.zeros(n), np.zeros(n), np.sin(phi / 2)], axis=1)
    w1, x1, y1, z1 = qz.T
    w2, x2, y2, z2 = qy.T
    q = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                  w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], axis=1)
    a["rotation"] = q.astype(np.float32)
    a["position_visibility"][:, :3] = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    a["scale_opacity"][:, :2] = rng.uniform(0.05, 1.0, (n, 2)).astype(np.float32)
    return a


def _surfel_arrays(kind: str, n: int, seed: int) -> dict:
    if kind == "grid":
        return surfel_grid_arrays()
    if kind == "edge-on":
        return _edge_on_arrays(n, seed)
    if kind.startswith("sh"):  # a storage degree other than 3
        return random_arrays_3d_seeded(n, seed=seed, sh_degree=int(kind[2:]))
    # the gs2d-1m recipe (benchmark/configs/gs2d-1m.json): positions x (1, 1,
    # 0.25), scales x 0.05
    a = random_arrays_3d_seeded(n, seed=seed)
    a["position_visibility"] *= np.array([1, 1, 0.25, 1], np.float32)
    a["scale_opacity"] *= np.array([0.05, 0.05, 0.05, 1], np.float32)
    return a


# (kind, n, width, height, settings, model transform, eye)
SURFEL_CASES = {
    "bench-720p": ("bench", 20000, 1280, 720, S2, False, (3.0, 4.0, 60.0)),
    "bench-512-transform": ("bench", 20000, 512, 512, S2, True, (3.0, 4.0, 60.0)),
    "bench-1080p-linear-selected": (
        "bench", 20000, 1920, 1080, S2.replace(color_space=_LINEAR, draw_mode=DrawMode.SELECTED), False,
        (3.0, 4.0, 60.0)),
    "bench-512-highlight-fixed-cutoff": (
        "bench", 20000, 512, 512, S2.replace(draw_mode=DrawMode.HIGHLIGHT_SELECTED, opacity_adaptive_radius=False),
        True, (3.0, 4.0, 60.0)),
    "bench-512-16bit-keys": (
        "bench", 20000, 512, 512, S2.replace(radix_sort_depth_bits=RadixSortDepthBits.BITS_16), False,
        (3.0, 4.0, 60.0)),
    "grid-256": ("grid", 16, 256, 256, S2, False, SURFEL_EYE),
    "grid-512-transform": ("grid", 16, 512, 512, S2, True, SURFEL_EYE),
    "edge-on-512": ("edge-on", 4096, 512, 512, S2, False, (0.0, 0.0, 60.0)),
    "edge-on-1080p-transform": ("edge-on", 4096, 1920, 1080, S2, True, (0.0, 0.0, 60.0)),
    "sh0-512": ("sh0", 4000, 512, 512, S2, False, (3.0, 4.0, 60.0)),
    "sh1-512": ("sh1", 4000, 512, 512, S2, False, (3.0, 4.0, 60.0)),
    "sh2-512-linear": ("sh2", 4000, 512, 512, S2.replace(color_space=_LINEAR), False, (3.0, 4.0, 60.0)),
    "sh4-512-transform": ("sh4", 4000, 512, 512, S2, True, (3.0, 4.0, 60.0)),
}


def _surfel_inputs(card, case):
    kind, n, width, height, settings, transform, eye = SURFEL_CASES[case]
    a = _surfel_arrays(kind, n, 21)
    n = a["position_visibility"].shape[0]
    a["position_visibility"][:, 3] = np.random.default_rng(12).choice(np.array([0.0, 0.5, 0.75, 1.0], np.float32), n)
    cloud = cloud_from_numpy(a, card)
    cam = Camera.create(eye=eye, width=width, height=height, device=card)
    return cloud, cam, settings, (_model_transform(card) if transform else None)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _differ(got: dict, ref: dict) -> dict:
    """By field where the two differ: (rows, columns, most ulps)."""
    assert set(got) == set(ref) and "surfel_radius" in got
    differ = {}
    for name in sorted(ref):
        a, b = _bits(got[name]), _bits(ref[name])
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if not torch.equal(a, b):
            cols = (a != b).reshape(a.shape[0], -1)
            differ[name] = (int(cols.any(dim=1).sum()), cols.any(dim=0).nonzero().flatten().tolist(),
                            int((a.long() - b.long()).abs().max()))
    return differ


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SURFEL_CASES))
def test_fused_surfel_projection_equals_the_eager_chain(card, case):
    cloud, cam, settings, model = _surfel_inputs(card, case)
    assert pj.fused_projection_applies(cloud, settings, model)
    before = trace.counters().get("project.fused", 0)
    got = pj.project_splats(cloud, cam, settings, model)
    assert trace.counters().get("project.fused", 0) == before + 1
    # the kernel packs for the camera's size by default
    ref = pj.project_splats_plain(cloud, cam, settings, model, size=(cam.width, cam.height))
    torch.cuda.synchronize()
    differ = _differ(got, ref)
    if len(cloud) < SMALL_CLOUD:
        # the centre alone, within a few ulps (see above) ...
        for name in ("center_ndc", "params"):
            if name in differ:
                _, cols, ulps = differ.pop(name)
                assert set(cols) <= {0, 1} and ulps <= SMALL_CENTRE_ULPS, (name, cols, ulps)
        # ... and bitwise once the rows are many
        big = dataclasses.replace(cloud, **{f.name: getattr(cloud, f.name).repeat(4096 // len(cloud), 1)
                                            for f in dataclasses.fields(cloud)})
        assert not _differ(pj.project_splats(big, cam, settings, model),
                           pj.project_splats_plain(big, cam, settings, model))
    assert not differ, f"rows that differ, their columns and the most ulps by field: {differ}"
    assert int(ref["mask"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bench-720p", "edge-on-512", "grid-512-transform"])
def test_fused_surfel_render_matches_the_eager_chain(card, case, monkeypatch):
    """``render_tiled`` through the kernel against the same call with the
    eager chain (the dispatch rule forced off): the same image, and the
    kernel took every projection of the frame."""
    cloud, cam, settings, model = _surfel_inputs(card, case)
    before = trace.counters().get("project.fused", 0)
    got = rt.render_tiled(cloud, cam, settings, model, differentiable=False)
    assert trace.counters().get("project.fused", 0) == before + 1
    monkeypatch.setattr(pj, "fused_projection_applies", lambda *args: False)
    ref = rt.render_tiled(cloud, cam, settings, model, differentiable=False)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 2e-5
    assert float(ref[..., 3].max()) > 0.5
