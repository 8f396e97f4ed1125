"""The plain reference against the program's plain (CPU) path at a tiny
size: a 3D frame, a frame replayed from a stale binning, 4D frames, a
training step's loss and per-splat gradients, and Adam."""

import math

import numpy as np
import pytest
import torch

from benchmark import run, scenes
from benchmark.reference import splat
from benchmark.reference import train as ref_train

W, H = 64, 48
N = 3000


def scene(name: str, seed: int = 7):
    _, _, config = run.cell_files(name)
    return config, scenes.make_scene(config, seed, torch.device("cpu"), N)


def program_cloud(config, fields):
    from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud, Gaussian4dCloud

    return (Gaussian4dCloud if config["kind"] == "4d" else Gaussian3dCloud)(**fields)


def settings_of(config):
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode

    return CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D) if config["kind"] == "4d" else CloudSettings()


@pytest.mark.parametrize("az", [0.0, 0.7])
def test_orbit_frame_equals_program(az):
    from bevy_gaussian_splatting_tpu_torch.render.api import InteractiveRenderer

    config, fields = scene("gs3d-1m.orbit-720p")
    r = InteractiveRenderer(settings_of(config), device="cpu")
    img = r.render_orbit(program_cloud(config, fields), az, 0.2, 40.0, width=W, height=H)
    ref, bins = splat.render_frame(fields, splat.orbit_camera(az, 0.2, 40.0, W, H, torch.device("cpu")))
    assert float(img[..., 3].mean()) > 0.05  # the frame shows the scene
    assert bins["pairs"] > 0
    assert torch.equal(img, ref)


def test_replay_from_a_stale_binning_equals_program():
    from bevy_gaussian_splatting_tpu_torch.render.api import InteractiveRenderer

    config, fields = scene("gs3d-1m.orbit-720p")
    cloud = program_cloud(config, fields)
    r = InteractiveRenderer(settings_of(config), period_floor_ms=1e9, device="cpu")
    r.render_orbit(cloud, 0.1, 0.2, 40.0, width=W, height=H)
    img = r.render_orbit(cloud, 0.25, 0.2, 40.0, width=W, height=H)
    assert r.stats == {"bins": 1, "replays": 1, "oneshots": 0}
    dev = torch.device("cpu")
    ref, _ = splat.render_frame(fields, splat.orbit_camera(0.25, 0.2, 40.0, W, H, dev), None,
                                splat.orbit_camera(0.1, 0.2, 40.0, W, H, dev))
    fresh, _ = splat.render_frame(fields, splat.orbit_camera(0.25, 0.2, 40.0, W, H, dev))
    assert torch.equal(img, ref)
    assert not torch.equal(ref, fresh)  # the stale order shows


@pytest.mark.parametrize("t", [0.25, 0.61])
def test_4d_frame_equals_program(t):
    from bevy_gaussian_splatting_tpu_torch.render.api import InteractiveRenderer

    config, fields = scene("gs4d-1m.playback-512")
    r = InteractiveRenderer(settings_of(config), device="cpu")
    img = r.render_orbit(program_cloud(config, fields), 0.0, 0.0, 40.0, width=W, height=H, time=t)
    ref, _ = splat.render_frame(fields, splat.orbit_camera(0.0, 0.0, 40.0, W, H, torch.device("cpu")), t)
    assert float(img[..., 3].mean()) > 0.05
    assert torch.equal(img, ref)


def test_pair_cap_drops_the_farthest_pairs():
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled

    config, fields = scene("gs3d-1m.train-512")
    view, proj = splat.look_at_np((0.0, 0.0, 40.0)), splat.perspective_np(W, H)
    dev = torch.device("cpu")
    full, bins = splat.render_frame(fields, splat.host_camera(view, proj, W, H, dev), chunk=512)
    cap = bins["pairs"] // 2
    chunk = splat.chunk_for(cap, bins["tx_count"] * bins["ty_count"])
    ref, capped = splat.render_frame(fields, splat.host_camera(view, proj, W, H, dev), p_max=cap, chunk=chunk)
    img = render_tiled(program_cloud(config, fields), Camera.from_matrices(view, proj, W, H, device="cpu"),
                       settings_of(config), pairs_max=cap, differentiable=False)
    assert capped["kept"] == cap and not torch.equal(ref, full)
    assert torch.equal(img, ref)


@pytest.mark.parametrize("name", ["gs3d-1m.train-512", "gs4d-1m.train-512"])
def test_training_step_gradients_match_program(name):
    """The loss bitwise; on the splats whose OBB axis is well-conditioned
    (``splat.well_conditioned``) the gradient of every field within 1e-4 of
    its largest value and its difference's norm within 1e-4 of its norm
    (read at most 1.8e-5 and 7.8e-6 over six seeds).  On the others the axis's gradient is
    rounding noise over |sxy| in either implementation, and the two sum
    autograd's terms in another order."""
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
    from bevy_gaussian_splatting_tpu_torch.train.losses import gaussian_splatting_loss
    from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud

    config, fields = scene(name)
    t = 0.3 if config["kind"] == "4d" else None
    dev = torch.device("cpu")
    view, proj = splat.look_at_np((10.0, 5.0, 40.0)), splat.perspective_np(W, H)
    cam = splat.host_camera(view, proj, W, H, dev)
    target, _ = splat.render_frame(scenes.moved(fields, (0.25, -0.15, 0.1)), cam, t, chunk=512)
    model = TrainableCloud(program_cloud(config, fields))
    img = render_tiled(model.cloud(), Camera.from_matrices(view, proj, W, H, device="cpu"), settings_of(config),
                       time=t)
    loss = gaussian_splatting_loss(img, target)
    loss.backward()
    ref_loss, grads, well = ref_train.loss_and_grads(fields, cam, target, t, 512)
    assert float(loss.detach()) == ref_loss
    assert float(well.float().mean()) > 0.5
    for k, g in grads.items():
        got = getattr(model, k).grad[well]
        scale = float(g[well].abs().max())
        assert scale > 0.0, k
        assert float((got - g[well]).abs().max()) <= 1e-4 * scale, k
        assert float(torch.linalg.vector_norm(got - g[well])) <= 1e-4 * float(torch.linalg.vector_norm(g[well])), k


def test_adam_matches_torch():
    torch.manual_seed(0)
    p = {"a": torch.randn(50), "b": torch.randn(7, 3)}
    params = [torch.nn.Parameter(v.clone()) for v in p.values()]
    opt = torch.optim.Adam(params, lr=0.02, betas=(0.9, 0.999), eps=1e-8)
    mine = ref_train.Adam(p, 0.02)
    cur = dict(p)
    for _ in range(3):
        g = {k: torch.randn_like(v) for k, v in p.items()}
        for prm, gv in zip(params, g.values()):
            prm.grad = gv.clone()
        opt.step()
        cur = mine.step(cur, g)
    for prm, v in zip(params, cur.values()):
        assert torch.allclose(prm.detach(), v, rtol=1e-6, atol=1e-7)


def test_loss_matches_program():
    from bevy_gaussian_splatting_tpu_torch.train.losses import gaussian_splatting_loss

    g = torch.Generator().manual_seed(3)
    a, b = torch.rand(40, 56, 4, generator=g), torch.rand(40, 56, 4, generator=g)
    assert math.isclose(float(gaussian_splatting_loss(a, b)), float(ref_train.splatting_loss(a, b)), rel_tol=1e-6)


def test_bfloat16_reference_runs_and_differs():
    config, fields = scene("gs3d-1m.orbit-720p")
    cam = splat.orbit_camera(0.3, 0.2, 40.0, W, H, torch.device("cpu"))
    lo, _ = splat.render_frame(fields, cam, dtype=torch.bfloat16)
    hi, _ = splat.render_frame(fields, cam)
    gap = float((lo.float() - hi).abs().max())
    assert np.isfinite(gap) and gap > 1e-2
