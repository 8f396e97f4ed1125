"""Whole runs of the 2DGS surfel cell ``gs2d-1m.orbit-720p`` on the CPU at
a test size (the harness's look for a card skipped): a sound run comes out
correct, an altered and a stale answer do not, and each control (the
reference in bfloat16, the reference of half the surfels, the 3DGS OBB
reference of the same scene) fails the cell's limits.  A traced run's
per-layer metrics, and the projection roofline's reader on a reading with
the kernel in it.  The card's versions of the last two skip without one."""

import pytest
import torch

from benchmark import control, control_2d, counts_2d, run
from benchmark.traffic import serve_2d

NAME = "gs2d-1m.orbit-720p"
SMALL = {"width": 64, "height": 48, "radius": 40.0, "warmup_frames": 3, "trace_seconds": 0.3,
         "period_floor_ms": 100.0}
N = 2500
SEED = 2**31 + 11
LAYER = ("replay_share.serve", "launches.serve", "roofline.fwd.serve", "device_ms.serve", "idle_share.serve",
         "mfu.serve", "pair_fill.serve", "project_fused.serve", "roofline.project.serve")


def small_run(hook=None, trace=False, seconds=0.6):
    return run.run_cell(NAME, SEED, seconds, trace, device="cpu", n=N, overrides=SMALL, require_card=False, hook=hook)


def test_the_cell_reports_the_listed_metrics():
    e2e, layer = run.metrics_of(NAME, run.manifest())
    assert {m["name"] for m in e2e} == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert {m["name"] for m in layer} == set(LAYER)


def test_sound_run_is_correct():
    res = small_run()
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}


def test_altered_answer_is_not_correct():
    """A frame altered where it is produced: one tile's colours shifted by 0.5."""

    def hook(traffic):
        serve = traffic.renderer.render_orbit

        def altered(*a, **k):
            img = serve(*a, **k).clone()
            img[:16, :16, :3] += 0.5
            return img

        traffic.renderer.render_orbit = altered

    assert not small_run(hook)["correct"]


def test_stale_answer_is_not_correct():
    """The first window frame's image served again for every later frame."""

    def hook(traffic):
        serve = traffic.renderer.render_orbit
        first = []

        def stale(*a, **k):
            img = serve(*a, **k)
            if not first:
                first.append(img.clone())
            return first[0]

        traffic.renderer.render_orbit = stale

    # a window long enough for frames after the first on a loaded host
    res = small_run(hook, seconds=3.0)
    assert res["attempted"] > 1 and not res["correct"]


@pytest.mark.parametrize("name", serve_2d.CONTROLS)
def test_control_fails_the_limits(name):
    """``benchmark.control``'s bfloat16 reading and ``benchmark.control_2d``'s
    three: the program within every limit, each control above at least one."""
    _, workload, _ = run.cell_files(NAME)
    limits = workload["limits"]
    if name == "bf16":
        r = control.readings(NAME, SEED, 0.6, device="cpu", n=N, overrides=SMALL)
        r["bf16"] = r["control"]
    else:
        r = control_2d.readings(NAME, SEED, 0.6, device="cpu", n=N, overrides=SMALL)
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r[name][k] > v for k, v in limits.items()), r


def test_traced_run_reports_per_layer_metrics_only():
    res = small_run(trace=True)
    assert res["correct"]
    assert "setup_s" not in res["metrics"] and "frame_ms" not in res["metrics"]
    # the CPU trace has no device time: the readers that need it find nothing
    assert set(res["metrics"]) == {"replay_share.serve"}
    assert res["device"]["window_s"] > 0


def test_projection_roofline_reads_the_kernels_time():
    """The reader: least bytes' time a frame times the frames over the
    traced time of every ``project_kernel`` launch; nothing without one."""
    read = run.reader("roofline.project.serve")
    least = counts_2d.project_least_s(1_000_000)
    assert least == pytest.approx(325e6 / 3.35e12)
    trace = {"kernel_s": {"void (anonymous namespace)::project_kernel_2d<3>(float4 const*)": 0.004,
                          "composite_fwd_kernel": 0.5}, "launches": 10, "busy_s": 1.0}
    r = run.Reading("serve", 20, 0.002, {}, trace, {"project_least_s": least})
    assert read(r) == pytest.approx(100.0 * 20 * least / 0.004)
    r.trace = {**trace, "kernel_s": {"composite_fwd_kernel": 0.5}}
    assert read(r) is None
    assert read(run.Reading("serve", 20, 0.002, {}, trace, {})) is None


def test_work_counts_every_projection_of_the_window():
    _, workload, config = run.cell_files(NAME)
    traffic = serve_2d.Traffic(run.Cell(NAME, {**workload, **SMALL}, config, SEED, torch.device("cpu"), N))
    res = traffic.run(frames=20, sample=False)
    assert res["recounts"] >= 1 and res["units"] == 20
    w = traffic.work(res)
    projections = 20 + res["stats"]["bins"] + res["recounts"]
    assert w["project_least_s"] == pytest.approx(counts_2d.project_least_s(N) * projections / 20)
    assert w["ops"] > 0 and w["fwd_least_s"] > 0


@pytest.mark.cuda
def test_traced_run_on_the_card_reports_every_listed_metric():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = run.run_cell(NAME, SEED, 3.0, True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(LAYER)
    assert res["metrics"]["project_fused.serve"]["value"] == 100.0
    assert 0.0 < res["metrics"]["roofline.project.serve"]["value"] <= 100.0
