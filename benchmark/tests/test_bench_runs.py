"""Whole runs of each cell on the CPU at a test size (the harness's look for
a card skipped): sound runs come out correct, runs with the timed path
broken underneath come out not correct, and the control (the reference in
bfloat16 in the program's place) fails the cell's limits."""

import pytest
import torch

from benchmark import control, run

SERVE = ("gs3d-1m.orbit-720p", "gs4d-1m.playback-512")
TRAIN = ("gs3d-1m.train-512", "gs4d-1m.train-512")
SMALL = {"width": 64, "height": 48, "radius": 40.0, "warmup_frames": 3, "warmup_steps": 1, "trace_seconds": 0.3,
         "period_floor_ms": 100.0}
N = 2500
SEED = 2**31 + 11


def small_run(name, hook=None, trace=False):
    return run.run_cell(name, SEED, 0.6, trace, device="cpu", n=N, overrides=SMALL, require_card=False, hook=hook)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_sound_run_is_correct(name):
    res = small_run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_is_not_correct(name):
    """A frame altered where it is produced: one tile's colours shifted by 0.5."""

    def hook(traffic):
        serve = traffic.renderer.render_orbit

        def altered(*a, **k):
            img = serve(*a, **k).clone()
            img[:16, :16, :3] += 0.5
            return img

        traffic.renderer.render_orbit = altered

    assert not small_run(name, hook)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_stale_answer_is_not_correct(name):
    """A frame that returns the renderer's state unchanged: the first
    window frame's image served again for every later frame."""

    def hook(traffic):
        serve = traffic.renderer.render_orbit
        first = []

        def stale(*a, **k):
            img = serve(*a, **k)
            if not first:
                first.append(img.clone())
            return first[0]

        traffic.renderer.render_orbit = stale

    assert not small_run(name, hook)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_the_state_unchanged_is_not_correct(name):
    from bevy_gaussian_splatting_tpu_torch.train import step as program_step

    real = program_step.train_step

    def frozen(model, optimizer, *a, **k):
        before = [p.detach().clone() for p in model.parameters()]
        loss = real(model, optimizer, *a, **k)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return loss

    orig = program_step.train_step
    program_step.train_step = frozen
    try:
        res = small_run(name)
    finally:
        program_step.train_step = orig
    assert not res["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_is_not_correct(name):
    """The loss's mean taken over the top half of the image's rows only."""
    from bevy_gaussian_splatting_tpu_torch.train import losses

    real = losses.gaussian_splatting_loss

    def half(img, target, *a, **k):
        h = img.shape[0] // 2
        return real(img[:h], target[:h], *a, **k)

    losses.gaussian_splatting_loss = half
    try:
        res = small_run(name)
    finally:
        losses.gaussian_splatting_loss = real
    assert not res["correct"]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_control_fails_the_limits(name):
    """The reference in bfloat16, put in the program's place, reads above
    at least one of the cell's limits."""
    _, workload, _ = run.cell_files(name)
    r = control.readings(name, SEED, 0.6, device="cpu", n=N, overrides=SMALL)
    assert all(r["program"][k] <= v for k, v in workload["limits"].items()), r
    assert any(r["control"][k] > v for k, v in workload["limits"].items()), r


def test_traced_run_reports_per_layer_metrics_only():
    res = small_run("gs3d-1m.orbit-720p", trace=True)
    assert res["correct"]
    assert "setup_s" not in res["metrics"] and "frame_ms" not in res["metrics"]
    # the CPU trace has no device time: the readers that need it find nothing
    assert set(res["metrics"]) == {"replay_share.serve"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_control_fails_at_the_cells_own_size(name):
    """On the card, at the cell's own size, on three seeds: the program
    within every limit, the control above at least one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _, workload, _ = run.cell_files(name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = control.readings(name, seed, 3.0)
        assert all(r["program"][k] <= v for k, v in workload["limits"].items()), r
        assert any(r["control"][k] > v for k, v in workload["limits"].items()), r
