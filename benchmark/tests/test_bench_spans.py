"""``benchmark/spans.py`` on synthetic Chrome-trace events, and on a CPU
trace of the program: kernels charged to the span of their launch, the
backward's kernels on autograd's thread to the main thread's
``gs.backward``, self and inclusive time, idle gaps by span; the existing
summary unchanged by the spans; every new reader None where the program
has no spans or counters."""

import pytest
import torch

from benchmark import run, spans, trace

MAIN, AUTOGRAD = 11, 22


def span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def launch(corr, ts, tid=MAIN, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid, "pid": 1,
            "args": {"correlation": corr}}


def kernel(corr, ts, dur, name="k", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7, "pid": 0,
            "args": {"correlation": corr}}


def step_events():
    """One training step: a projection kernel, a backward on autograd's
    thread (a chain kernel outside any span there, a reduce inside
    ``gs.reduce``), an Adam kernel, and a copy whose launch the trace lacks."""
    return [
        span("gs.step", 0, 100),
        span("gs.project", 2, 20),
        span("gs.project.cov", 5, 10),
        launch(1, 3), kernel(1, 10, 5),
        launch(2, 6), kernel(2, 16, 4),
        span("gs.backward", 30, 50),
        launch(3, 32, tid=AUTOGRAD), kernel(3, 34, 6),
        span("gs.reduce", 45, 10, tid=AUTOGRAD),
        launch(4, 46, tid=AUTOGRAD), kernel(4, 48, 3),
        span("gs.adam", 85, 10),
        launch(5, 86), kernel(5, 88, 2),
        launch(6, 97), kernel(6, 98, 1, name="Memcpy DtoD", cat="gpu_memcpy"),
        kernel(99, 120, 4),
    ]


def test_a_kernel_goes_to_the_innermost_span_of_its_launching_thread():
    s = spans.summarize(step_events())["spans"]
    assert s["gs.project"]["self_ms"] == pytest.approx(5e-3)  # launched at 3, before gs.project.cov opens
    assert s["gs.project.cov"]["self_ms"] == pytest.approx(4e-3)
    assert s["gs.project"]["incl_ms"] == pytest.approx(9e-3)
    assert s["gs.project"]["self_launches"] == s["gs.project.cov"]["self_launches"] == 1
    assert s["gs.adam"]["incl_ms"] == pytest.approx(2e-3)
    assert s["gs.step"]["self_ms"] == pytest.approx(1e-3)  # the copy, launched in the root alone
    assert s["gs.step"]["self_launches"] == 0


def test_an_autograd_thread_launch_goes_to_the_main_threads_backward():
    s = spans.summarize(step_events())["spans"]
    assert s["gs.backward"]["self_ms"] == pytest.approx(6e-3)
    assert s["gs.reduce"]["self_ms"] == pytest.approx(3e-3)
    assert s["gs.backward"]["incl_ms"] == pytest.approx(9e-3)  # gs.reduce is its child
    assert s["gs.step"]["incl_ms"] == pytest.approx(21e-3)


def test_self_time_is_inclusive_less_the_children():
    s = spans.summarize(step_events())["spans"]
    children = {"gs.step": ("gs.project", "gs.backward", "gs.adam"), "gs.project": ("gs.project.cov",),
                "gs.backward": ("gs.reduce",)}
    for parent, kids in children.items():
        assert s[parent]["self_ms"] == pytest.approx(s[parent]["incl_ms"] - sum(s[k]["incl_ms"] for k in kids))
        assert s[parent]["self_launches"] == s[parent]["incl_launches"] - sum(s[k]["incl_launches"] for k in kids)


def test_unmatched_kernels_coverage_and_wall():
    out = spans.summarize(step_events())
    assert out["unattributed_ms"] == pytest.approx(4e-3)  # correlation 99 has no launch
    assert out["root_self_ms"] == pytest.approx(1e-3)
    assert out["device_ms"] == pytest.approx(25e-3)
    assert out["coverage"] == pytest.approx(20 / 25)
    assert out["launches"] == 6
    assert out["spans"]["gs.backward"]["wall_ms"] == pytest.approx(50e-3)
    assert out["spans"]["gs.step"]["count"] == 1


def test_gaps_go_to_the_innermost_span_or_outside_the_program():
    events = [
        span("gs.frame", 0, 100),
        span("gs.project", 10, 40),
        launch(1, 1), kernel(1, 2, 3),  # busy 2-5
        launch(2, 11), kernel(2, 30, 5),  # gap 5-30, middle 17.5 in gs.project
        launch(3, 60), kernel(3, 70, 5),  # gap 35-70, middle 52.5 in gs.frame alone
        launch(4, 101), kernel(4, 200, 5),  # gap 75-200, middle 137.5 outside
    ]
    out = spans.summarize(events)
    assert out["spans"]["gs.project"]["idle_ms"] == pytest.approx(25e-3)
    assert out["spans"]["gs.frame"]["idle_ms"] == pytest.approx(35e-3)
    assert out["spans"]["gs.frame"]["idle_incl_ms"] == pytest.approx(60e-3)
    assert out["idle_outside_ms"] == pytest.approx(125e-3)
    assert out["idle_ms"] == pytest.approx(185e-3)
    assert out["outside_ms"] == pytest.approx(5e-3)  # launched at 101, after the frame
    metrics = spans.layer_metrics("serve", 1, out)
    assert metrics["project_idle_ms.serve"] == pytest.approx(25e-3)
    assert metrics["project_ms.serve"] == pytest.approx(5e-3)
    assert metrics["bin_ms.serve"] is None and metrics["recount_ms.serve"] is None


def test_the_existing_summary_is_the_same_with_the_spans():
    events = step_events() + [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 60, "dur": 5, "tid": MAIN, "pid": 1},
    ]
    plain = [e for e in events if not e["name"].startswith("gs.")]
    a, b = trace.summarize(plain), trace.summarize(events)
    for key in ("busy_s", "launches", "kernel_s", "device_ops"):
        assert a[key] == b[key], key
    assert sum(v for _, v in a["idle_gaps"]) == pytest.approx(sum(v for _, v in b["idle_gaps"]))
    # the gaps that no host op covered now carry a span's name
    assert "(no host op)" in dict(a["idle_gaps"]) and "gs.backward" in dict(b["idle_gaps"])


class _Reading:
    def __init__(self, kind, launches=10):
        self.kind, self.units, self.wall_per_unit_s, self.stats, self.work = kind, 4, 0.01, {}, {}
        self.trace = {"launches": launches, "busy_s": 0.01, "kernel_s": {}}


def test_every_new_reader_is_none_without_spans_or_counters(monkeypatch):
    plain = [e for e in step_events() if not e["name"].startswith("gs.")]
    out = spans.summarize(plain)
    assert out["spans"] == {} and out["coverage"] is None
    for kind in ("serve", "train"):
        assert set(spans.layer_metrics(kind, 4, out).values()) == {None}
    from bevy_gaussian_splatting_tpu_torch.utils import trace as program_trace

    monkeypatch.setattr(program_trace, "counters", lambda: {})
    for name, kind in (("pair_fill.serve", "serve"), ("pair_fill.train", "train")):
        assert run.reader(name)(_Reading(kind)) is None
    # a program without the counters at all (the parent commit)
    monkeypatch.delattr(program_trace, "counters")
    for name, kind in (("pair_fill.serve", "serve"), ("pair_fill.train", "train")):
        assert run.reader(name)(_Reading(kind)) is None


def test_pair_fill_readers_read_the_counters(monkeypatch):
    from bevy_gaussian_splatting_tpu_torch.utils import trace as program_trace

    monkeypatch.setattr(program_trace, "counters", lambda: {
        "budget.pairs_counted": 300, "budget.sized": 1200, "train.pairs": 50, "train.budget": 200})
    assert run.reader("pair_fill.serve")(_Reading("serve")) == pytest.approx(25.0)
    assert run.reader("pair_fill.train")(_Reading("train")) == pytest.approx(25.0)
    assert run.reader("pair_fill.train")(_Reading("serve")) is None
    assert run.reader("pair_fill.serve")(_Reading("serve", launches=0)) is None  # no card


def test_a_cpu_trace_of_the_program_has_its_spans(tmp_path):
    from bevy_gaussian_splatting_tpu_torch.models.cloud import random_gaussians_3d_seeded
    from bevy_gaussian_splatting_tpu_torch.render.api import InteractiveRenderer
    from bevy_gaussian_splatting_tpu_torch.utils.trace import trace as program_trace

    cloud = random_gaussians_3d_seeded(800, seed=1, device="cpu")
    r = InteractiveRenderer(device="cpu")
    with program_trace(str(tmp_path), device="cpu") as prof:
        for _ in range(2):
            r.render_orbit(cloud, 0.1, 0.2, 40.0, width=32, height=32)
    import json

    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = spans.summarize(events)
    assert out["spans"]["gs.frame"]["count"] == 2 and out["spans"]["gs.recount"]["count"] == 1
    assert out["spans"]["gs.bin"]["count"] == 1 and out["spans"]["gs.composite"]["count"] >= 2
    assert out["device_ms"] == 0.0 and out["coverage"] is None
    assert torch.isfinite(torch.tensor(out["spans"]["gs.frame"]["wall_ms"]))
