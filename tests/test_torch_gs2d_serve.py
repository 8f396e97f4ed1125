"""PyTorch port, 2DGS surfels served through ``InteractiveRenderer`` on the
CPU, held to the benchmark's plain surfel reference
(``benchmark/reference/splat_2d.py``) within the ``gs2d-1m.orbit-720p``
cell's limits: a bin frame, a replay of the stale bins after a move the
throttle lets pass (against the reference composited over the binning of
the bin pose), a one-pass frame at a height off the tile grid, and the
surfel grid of ``tools/surfel_plane.py``.  ``project_splats_plain`` under
2DGS is the eager chain's dict.  The reference imports neither JAX nor the
port.  No JAX."""

import ast
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import scenes  # noqa: E402
from benchmark.reference import splat, splat_2d  # noqa: E402
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera  # noqa: E402
from bevy_gaussian_splatting_tpu_torch.models.cloud import (  # noqa: E402
    Gaussian3dCloud,
    cloud_from_numpy,
    surfel_grid_arrays,
)
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode  # noqa: E402
from bevy_gaussian_splatting_tpu_torch.ops.cuda import project as pj  # noqa: E402
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians  # noqa: E402
from bevy_gaussian_splatting_tpu_torch.ops.sort import SENTINEL_KEY  # noqa: E402
from bevy_gaussian_splatting_tpu_torch.render import api  # noqa: E402
from torch_port_cases import EYE  # noqa: E402  (also keeps one PyTorch thread per worker)

CELL = json.loads((ROOT / "benchmark" / "workloads" / "gs2d-1m.orbit-720p.json").read_text())
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "gs2d-1m.json").read_text())
LIMITS = CELL["limits"]
S2 = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)
N = 3000
W, H = 64, 48
EL, RADIUS = float(CELL["elevation"]), 40.0
CPU = torch.device("cpu")
FORBIDDEN = ("jax", "jaxlib", "bevy_gaussian_splatting_tpu", "bevy_gaussian_splatting_tpu_torch")


@pytest.fixture(autouse=True)
def fresh_budgets(monkeypatch):
    monkeypatch.setattr(api, "_BUDGET_STATE", {})


@pytest.fixture(scope="module")
def scene():
    return scenes.make_scene(CONFIG, 2**31 + 7, CPU, N)


def _within_limits(got, ref):
    gap = (got.float() - ref.float()).abs()
    max_abs, rmse = float(gap.max()), float(torch.sqrt(torch.mean(gap * gap)))
    assert max_abs <= LIMITS["max_abs"] and rmse <= LIMITS["rmse"], (max_abs, rmse)


def _lit(img) -> float:
    return float((img[..., 3] > 0.01).float().mean())


def test_bin_and_replay_frames_match_the_reference(scene):
    cloud = Gaussian3dCloud(**scene)
    r = api.InteractiveRenderer(S2, period_floor_ms=1e9, device=CPU)
    binned = r.render_orbit(cloud, 0.3, EL, RADIUS, width=W, height=H)
    assert r.stats == {"bins": 1, "replays": 0, "oneshots": 0}
    cam = splat.orbit_camera(0.3, EL, RADIUS, W, H, CPU)
    _within_limits(binned, splat_2d.render_frame(scene, cam)[0])
    assert _lit(binned) > 0.3

    # a move the throttle lets pass: the stale bins of the bin pose replayed
    # with the splats of the new pose
    replayed = r.render_orbit(cloud, 0.32, EL, RADIUS, width=W, height=H)
    assert r.stats == {"bins": 1, "replays": 1, "oneshots": 0}
    moved = splat.orbit_camera(0.32, EL, RADIUS, W, H, CPU)
    _within_limits(replayed, splat_2d.render_frame(scene, moved, bin_cam=cam)[0])
    assert not torch.equal(replayed, binned)


def test_one_pass_frame_off_the_tile_grid_matches_the_reference(scene):
    cloud = Gaussian3dCloud(**scene)
    r = api.InteractiveRenderer(S2, device=CPU)
    img = r.render_orbit(cloud, 1.1, EL, RADIUS, width=W, height=H - 8)
    assert r.stats == {"bins": 0, "replays": 0, "oneshots": 1}
    assert img.shape == (H - 8, W, 4)
    cam = splat.orbit_camera(1.1, EL, RADIUS, W, H - 8, CPU)
    _within_limits(img, splat_2d.render_frame(scene, cam)[0])
    assert _lit(img) > 0.3


def test_surfel_grid_matches_the_reference():
    """``tools/surfel_plane.py``'s scene and camera, as ``render()`` serves it."""
    arrays = surfel_grid_arrays()
    cam = Camera.create(eye=(2.5, 2.0, 6.0), target=(0, 0, 0), width=W, height=W, device=CPU)
    img = api.render(cloud_from_numpy(arrays, CPU), cam, S2, device=CPU)
    fields = {k: torch.from_numpy(v) for k, v in arrays.items()}
    ref_cam = {"view": cam.view_from_world, "proj": cam.clip_from_view, "eye": cam.world_position,
               "width": W, "height": W}
    _within_limits(img, splat_2d.render_frame(fields, ref_cam)[0])
    assert _lit(img) > 0.2


def test_surfel_and_obb_frames_differ_beyond_the_limits(scene):
    """The limits tell the surfel falloff from the OBB falloff of the same
    scene: the 3DGS reference put in the surfel frame's place fails them."""
    cam = splat.orbit_camera(0.3, EL, RADIUS, W, H, CPU)
    surfels = splat_2d.render_frame(scene, cam)[0]
    obb = splat.render_frame(scene, cam)[0]
    gap = (surfels - obb).abs()
    assert float(gap.max()) > LIMITS["max_abs"] or float(torch.sqrt(torch.mean(gap * gap))) > LIMITS["rmse"]


def test_plain_projection_is_the_eager_chain(scene):
    cloud = Gaussian3dCloud(**scene)
    cam = Camera.create(eye=EYE, width=W, height=H, device=CPU)
    got = pj.project_splats_plain(cloud, cam, S2)
    ref = project_gaussians(cloud, cam, S2)
    ref["mask"] = ref["mask"] & (ref["sort_key"] != SENTINEL_KEY)
    for name in ("mask", "center_ndc", "sort_key", "surfel_radius"):
        assert torch.equal(got[name], ref[name]), name
    rows = torch.stack(pj.pack_raster_param_cols(ref, S2, W, H), dim=-1)
    assert torch.equal(got["params"].view(torch.int32), rows.view(torch.int32))
    assert set(got) == {"mask", "center_ndc", "sort_key", "surfel_radius", "params"}


@pytest.mark.parametrize("module", ["splat_2d", "splat"])
def test_reference_imports_neither_jax_nor_the_port(module):
    """Its imports, and those of the benchmark modules it imports, by ``ast``
    (this environment's interpreter imports JAX at start, so
    ``sys.modules`` cannot tell)."""
    src = ROOT / "benchmark" / "reference" / f"{module}.py"
    names = []
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names and not [n for n in names if n.split(".")[0] in FORBIDDEN], names
    assert {n.split(".")[0] for n in names} <= {"__future__", "math", "numpy", "torch", "benchmark"}
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
