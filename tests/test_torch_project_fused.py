"""The fused serving projection's dispatch rule and its plain version, on the
CPU (``ops/cuda/project.py``; the kernel itself is held to the eager chain
on the card by tests/test_torch_cuda.py).

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
)
from bevy_gaussian_splatting_tpu_torch.models.settings import (
    CloudSettings,
    DrawMode,
    GaussianColorSpace,
    GaussianMode,
    RasterizeMode,
)
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import project as pj
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud
from bevy_gaussian_splatting_tpu_torch.utils import trace

S3 = CloudSettings()  # the gs3d-1m configuration's settings (benchmark/traffic/serve.py)
S4 = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D)  # gs4d-1m's


def _cloud(kind: str, n: int = 64):
    if kind == "3d":
        return cloud_from_numpy(random_arrays_3d_seeded(n, seed=1), "cpu")
    if kind == "4d":
        return cloud_from_numpy(random_arrays_4d_seeded(n, seed=1), "cpu")
    return precompute_covariance_3d(_cloud("3d", n))


@pytest.fixture
def on_card(monkeypatch):
    """The cloud classes report a CUDA device; their tensors stay here."""
    for cls in (Gaussian3dCloud, Gaussian4dCloud, Gaussian3dCovCloud):
        monkeypatch.setattr(cls, "device", property(lambda self: torch.device("cuda", 0)))


@pytest.mark.parametrize("kind,settings", [("3d", S3), ("4d", S4), ("3d", CloudSettings(aabb=True))])
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
])
def test_rule_takes_the_configurations_on_the_card(on_card, name, settings):
    cloud = _cloud(name[:2])
    assert pj.fused_projection_applies(cloud, settings)
    # a transform and a time that carry no grad change nothing
    assert pj.fused_projection_applies(cloud, settings, torch.eye(4), torch.tensor(0.5))
    with torch.no_grad():
        assert pj.fused_projection_applies(cloud, settings, None, None)


@pytest.mark.parametrize("what", ["field", "transform", "time"])
@pytest.mark.parametrize("kind", ["3d", "4d"])
def test_rule_leaves_grad_to_the_eager_chain(on_card, kind, what):
    cloud = _cloud(kind)
    settings = S3 if kind == "3d" else S4
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
@pytest.mark.parametrize("kind", ["3d", "4d"])
def test_rule_leaves_the_other_rasterize_modes_to_the_eager_chain(on_card, kind, mode):
    base = S3 if kind == "3d" else S4
    assert not pj.fused_projection_applies(_cloud(kind), base.replace(rasterize_mode=mode))


@pytest.mark.parametrize("kind,settings", [
    ("3d", CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)),  # 2DGS surfels
    ("cov", S3),  # the precomputed-covariance cloud
    ("4d", S3),  # a class the mode does not render
    ("3d", S4),
])
def test_rule_leaves_other_modes_and_cloud_classes_to_the_eager_chain(on_card, kind, settings):
    assert not pj.fused_projection_applies(_cloud(kind), settings)


@pytest.mark.parametrize("kind,settings", [("3d", S3), ("3d", CloudSettings(aabb=True)), ("4d", S4)])
def test_project_calls_counts_the_eager_path(kind, settings):
    """On the CPU every call runs the eager chain: ``project.calls`` counts
    it, ``project.fused`` does not move, and a frame of ``render_tiled``
    projects once."""
    cloud = _cloud(kind, 256)
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=64, height=48, device="cpu")
    before = trace.counters()
    splats = rt.project_for_binning(cloud, cam, settings)
    assert "params" not in splats
    rt.render_tiled(cloud, cam, settings, differentiable=False)
    after = trace.counters()
    assert after["project.calls"] - before.get("project.calls", 0) == 2
    assert after.get("project.fused", 0) == before.get("project.fused", 0)


@pytest.mark.parametrize("kind,settings", [
    ("3d", S3), ("3d", CloudSettings(aabb=True, draw_mode=DrawMode.HIGHLIGHT_SELECTED)), ("4d", S4),
])
def test_plain_version_is_the_serving_eager_path(kind, settings):
    """``project_splats`` on the CPU (the plain version) gives the binning's
    fields of ``project_for_binning`` and the rows of ``pack_raster_params``
    bit for bit, and ``pack_raster_params`` hands its rows back at the
    camera's size and rescales only the centre at another."""
    cloud = _cloud(kind, 256)
    cam = Camera.create(eye=(2.0, 1.0, 60.0), width=64, height=48, device="cpu")
    got = pj.project_splats(cloud, cam, settings, time=0.3)
    ref = rt.project_for_binning(cloud, cam, settings, time=0.3)
    rows = rt.pack_raster_params(ref, settings, 64, 48)
    for name in ("mask", "center_ndc", "sort_key", "radius_vp" if settings.aabb else "obb_axis"):
        assert torch.equal(got[name], ref[name]), name
    assert torch.equal(got["params"].view(torch.int32), rows.view(torch.int32))
    assert got["params_size"] == (64, 48)
    assert rt.pack_raster_params(got, settings, 64, 48) is got["params"]
    other = rt.pack_raster_params(got, settings, 96, 80)
    assert torch.equal(other.view(torch.int32), rt.pack_raster_params(ref, settings, 96, 80).view(torch.int32))
    assert bool(ref["mask"].any())


def test_plain_version_refuses_what_the_kernel_does_not_take():
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=64, height=48, device="cpu")
    with pytest.raises(ValueError, match="COLOR"):
        pj.project_splats(_cloud("3d"), cam, S3.replace(rasterize_mode=RasterizeMode.DEPTH))
    with pytest.raises(ValueError, match="Gaussian3dCovCloud"):
        pj.project_splats(_cloud("cov"), cam, S3)
    assert np.isfinite(pj.project_splats(_cloud("3d"), cam, S3)["params"].numpy()).any()
