"""Whole runs of the 2DGS training cell ``gs2d-1m.train-512`` (2DGS with its
geometric terms) on the CPU at a test size (the harness's look for a card
skipped).  A sound run comes out correct; each control (the reference in
bfloat16, of half the surfels, with the distortion left out, with the
expected depth in place of the median) fails the cell's limits.  A traced
run's per-layer metrics, the forward roofline's reader, the cell's counted
work.  The card's version skips without one."""

import pytest
import torch

from benchmark import control_train_2d, counts_2d_train, run
from benchmark.traffic import train_2d

G2 = "gs2d-1m.train-512"
SMALL = {"width": 64, "height": 48, "radius": 40.0, "warmup_steps": 1, "trace_seconds": 0.3}
N = 2500  # the counted-work test's surfels
N_2D = 10000  # the surfel cell at this size: one surfel weighs less in a 3-step Adam trajectory
SEED = 2**31 + 11
LAYER = ("launches.train", "device_ms.train", "idle_share.train", "mfu.train", "pair_fill.train",
         "project_fused.train", "roofline.bwd.train")


def small_run(trace=False, seconds=0.6):
    return run.run_cell(G2, SEED, seconds, trace, device="cpu", n=N_2D, overrides=SMALL, require_card=False)


def test_the_cell_reports_the_listed_metrics():
    e2e, layer = run.metrics_of(G2, run.manifest())
    assert {m["name"] for m in e2e} == {"step_ms", "setup_s"}
    assert {m["name"] for m in layer} == set(LAYER) | {"roofline.fwd.train"}


def test_sound_run_is_correct():
    res = small_run()
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"step_ms", "setup_s"}


@pytest.mark.parametrize("name", train_2d.CONTROLS)
def test_surfel_control_fails_the_limits(name):
    """``benchmark.control_train_2d``'s readings: the program within every
    limit, each control above at least one."""
    limits = run.cell_files(G2)[1]["limits"]
    r = control_train_2d.readings(G2, SEED, 0.6, device="cpu", n=N_2D, overrides=SMALL)
    assert all(r["program"][k] <= v for k, v in limits.items()), r["program"]
    assert any(r[name][k] > v for k, v in limits.items()), r[name]


def test_traced_run_reports_per_layer_metrics_only():
    res = small_run(trace=True)
    assert res["correct"]
    assert "setup_s" not in res["metrics"] and "step_ms" not in res["metrics"]
    # the CPU trace has no device time: the readers that need it find nothing
    assert res["metrics"] == {}
    assert res["device"]["window_s"] > 0


def test_forward_roofline_reads_the_kernels_time():
    read = run.reader("roofline.fwd.train")
    trace = {"kernel_s": {"void (anonymous namespace)::composite_fwd_kernel<2, false, true>(float const*)": 0.01,
                          "composite_bwd_kernel": 0.5}, "launches": 10, "busy_s": 1.0}
    r = run.Reading("train", 20, 0.05, {}, trace, {"fwd_least_s": 1e-5})
    assert read(r) == pytest.approx(100.0 * 20 * 1e-5 / 0.01)
    r.trace = {**trace, "kernel_s": {"composite_bwd_kernel": 0.5}}
    assert read(r) is None
    assert read(run.Reading("train", 20, 0.05, {}, trace, {})) is None
    assert read(run.Reading("serve", 20, 0.05, {}, trace, {"fwd_least_s": 1e-5})) is None


def test_surfel_work_counts_the_maps():
    _, workload, config = run.cell_files(G2)
    traffic = train_2d.Traffic(run.Cell(G2, {**workload, **SMALL}, config, SEED, torch.device("cpu"), N))
    res = traffic.run(steps=3, sample=False)
    w = traffic.work(res)
    assert w["ops"] > 0 and w["fwd_least_s"] > 0 and w["bwd_least_s"] > w["fwd_least_s"]
    ops, nbytes = counts_2d_train.compositor_work(100, 50, 20, 4)
    assert ops == 100 * 2 + 50 * 46 + 20 * 32
    assert nbytes == 100 * 92 + 4 * 8 + 4 * 256 * 56


@pytest.mark.cuda
def test_traced_run_on_the_card_reports_every_listed_metric(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from bevy_gaussian_splatting_tpu_torch.utils import trace

    # the program's counters are the process's: count this run's alone, as
    # `python3 -m benchmark.run`, one run a process, does
    monkeypatch.setattr(trace, "_COUNTS", {})
    monkeypatch.setattr(trace, "_LATER", {})
    res = run.run_cell(G2, SEED, 3.0, True)
    assert res["correct"], res["checks"]
    _, layer = run.metrics_of(G2, run.manifest())
    assert set(res["metrics"]) == {m["name"] for m in layer}
    assert res["metrics"]["project_fused.train"]["value"] == 0.0
