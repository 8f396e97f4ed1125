"""The program's spans in the traced window: device time, launches and idle
gaps by ``gs.*`` span, from the same Chrome trace as ``benchmark/trace.py``.

The port opens a ``torch.profiler.record_function`` range named ``gs.<layer>``
at each layer boundary (``bevy_gaussian_splatting_tpu_torch/utils/trace.py``
``span``); the trace holds them as ``user_annotation`` events on the host
thread that opened them.  A device operation (a kernel, copy or fill) is
charged to a span through its host launch, the ``cuda_runtime`` or
``cuda_driver`` event with the same ``correlation``:

  - to the innermost ``gs.*`` span open on the launching thread at the
    launch;
  - where that thread has none open (autograd's device thread, which runs a
    backward for the main thread while the main thread waits inside
    ``gs.backward``), to the innermost one open on any thread;
  - to ``(outside the program)`` where no span is open at all, and to
    ``(unattributed)`` where the trace has no launch with its correlation.

A span's parent is the innermost span that contains it on its own thread,
else on any thread: so the backward's own spans on autograd's thread sit
under the main thread's ``gs.backward``.  Self time is what is charged to a
span; inclusive time adds its descendants', each operation counted once
under a name.  An idle gap (between busy intervals, as ``trace.py`` finds
them) goes to the innermost span open on any thread at its middle, or to
``(outside the program)``.  Coverage is the share of the window's device
time charged to a span below a root (a root is a span with no parent:
``gs.frame``, ``gs.step``).

``python3 -m benchmark.spans --workload <name> --seed <n>`` sets a cell up
as ``benchmark/run.py`` does, runs its loop for ``--seconds``, profiles a
further ``trace_seconds`` and prints the span table on stderr and one JSON
object on stdout: the span summary, the per-layer metrics that
:func:`layer_metrics` reads from it, and the cell's per-layer metrics of
``BENCHMARK.json``.  It checks nothing against the reference.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time

from benchmark import trace as tr

PREFIX = "gs."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(outside the program)"
UNATTRIBUTED = "(unattributed)"


class _Span:
    __slots__ = ("name", "tid", "s", "e", "tparent", "parent", "self_us", "self_launches")

    def __init__(self, name, tid, s, e):
        self.name, self.tid, self.s, self.e = name, tid, s, e
        self.tparent = self.parent = None
        self.self_us = 0.0
        self.self_launches = 0


class _Threads:
    """The spans of each thread, sorted by start, with their same-thread
    parents: the innermost open span at a time is a bisect and a walk up."""

    def __init__(self, spans):
        self.by_tid: dict = {}
        for sp in sorted(spans, key=lambda x: (x.s, -x.e)):
            self.by_tid.setdefault(sp.tid, []).append(sp)
        self.starts = {}
        for tid, lst in self.by_tid.items():
            stack: list = []
            for sp in lst:
                while stack and stack[-1].e < sp.e:
                    stack.pop()
                sp.tparent = stack[-1] if stack else None
                stack.append(sp)
            self.starts[tid] = [sp.s for sp in lst]

    def open_at(self, tid, t):
        """The innermost span open on thread ``tid`` at time ``t``, or None."""
        lst = self.by_tid.get(tid)
        if not lst:
            return None
        i = bisect.bisect_right(self.starts[tid], t) - 1
        sp = lst[i] if i >= 0 else None
        while sp is not None and sp.e < t:
            sp = sp.tparent
        return sp

    def open_anywhere(self, t, inside=None):
        """The innermost span open at ``t`` on any thread (the one that
        started last); with ``inside``, only spans that contain it."""
        best = None
        for tid in self.by_tid:
            sp = self.open_at(tid, t)
            while sp is not None and inside is not None and (sp is inside or sp.e < inside.e):
                sp = sp.tparent
            if sp is not None and (best is None or sp.s > best.s):
                best = sp
        return best


def summarize(events: list) -> dict:
    """Chrome trace events -> the span summary: ``spans`` {name: {count,
    wall_ms, self_ms, incl_ms, self_launches, incl_launches, idle_ms,
    idle_incl_ms}} (device and idle ms summed over the window),
    ``device_ms``, ``launches``, ``outside_ms``, ``unattributed_ms``,
    ``root_self_ms``, ``coverage`` (share of device time charged below a
    root), ``idle_ms`` and ``idle_outside_ms``.  Empty ``spans`` where the
    trace has no ``gs.*`` span."""
    spans, launches, dev = [], {}, []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.append(_Span(name, ev.get("tid"), ts, ts + dur))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (ev.get("tid"), ts)
        elif cat in tr.DEVICE_CATS:
            dev.append((ts, ts + dur, cat, corr))
    threads = _Threads(spans)
    for sp in spans:
        sp.parent = sp.tparent if sp.tparent is not None else threads.open_anywhere(sp.s, inside=sp)
    outside = unattributed = 0.0
    for s, e, cat, corr in dev:
        launch = launches.get(corr) if corr is not None else None
        if launch is None:
            unattributed += e - s
            continue
        tid, t = launch
        sp = threads.open_at(tid, t) or threads.open_anywhere(t)
        if sp is None:
            outside += e - s
            continue
        sp.self_us += e - s
        sp.self_launches += cat == "kernel"

    table: dict = {}

    def row(name):
        return table.setdefault(name, {"count": 0, "wall_ms": 0.0, "self_ms": 0.0, "incl_ms": 0.0,
                                       "self_launches": 0, "incl_launches": 0, "idle_ms": 0.0,
                                       "idle_incl_ms": 0.0})

    root_self = 0.0
    for sp in spans:
        r = row(sp.name)
        r["count"] += 1
        r["wall_ms"] += (sp.e - sp.s) * 1e-3
        r["self_ms"] += sp.self_us * 1e-3
        r["self_launches"] += sp.self_launches
        if sp.parent is None:
            root_self += sp.self_us
        for name in _chain_names(sp):
            row(name)["incl_ms"] += sp.self_us * 1e-3
            row(name)["incl_launches"] += sp.self_launches

    merged = tr._union([(s, e) for s, e, _, _ in dev])
    idle = idle_outside = 0.0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        if b <= a:
            continue
        idle += b - a
        sp = threads.open_anywhere((a + b) / 2)
        if sp is None:
            idle_outside += b - a
            continue
        row(sp.name)["idle_ms"] += (b - a) * 1e-3
        for name in _chain_names(sp):
            row(name)["idle_incl_ms"] += (b - a) * 1e-3

    total = sum(e - s for s, e, _, _ in dev)
    below = total - root_self - outside - unattributed
    return {
        "spans": table,
        "device_ms": total * 1e-3,
        "launches": sum(1 for d in dev if d[2] == "kernel"),
        "outside_ms": outside * 1e-3,
        "unattributed_ms": unattributed * 1e-3,
        "root_self_ms": root_self * 1e-3,
        "coverage": below / total if total > 0 and spans else None,
        "idle_ms": idle * 1e-3,
        "idle_outside_ms": idle_outside * 1e-3,
    }


def _chain_names(sp) -> set:
    """The names of a span and its ancestors, each once."""
    names = set()
    while sp is not None:
        names.add(sp.name)
        sp = sp.parent
    return names


def _per_unit(summary, name, key, units):
    r = (summary.get("spans") or {}).get(name)
    if r is None or not units:
        return None
    return r[key] / units


def layer_metrics(kind: str, units: int, summary: dict) -> dict:
    """The per-layer metrics of the program's spans, each None where its
    span is absent: ``project_ms`` and ``bin_ms`` (device ms a unit under
    ``gs.project`` / ``gs.bin``, children included); serve: ``project_idle_ms``
    (device-idle ms a frame whose gap's innermost span is ``gs.project`` or
    below it) and ``recount_ms`` (host wall ms of a ``gs.recount``, over the
    frames that had one); train: ``chain_bwd_ms`` (``gs.backward``'s self
    device ms a step: autograd of the projection chain, the epilogue and the
    loss), ``loss_host_ms`` (host wall ms of ``gs.loss`` a step) and
    ``adam_ms`` (device ms a step under ``gs.adam``)."""
    if kind == "serve":
        rc = (summary.get("spans") or {}).get("gs.recount")
        out = {
            "project_ms.serve": _per_unit(summary, "gs.project", "incl_ms", units),
            "project_idle_ms.serve": _per_unit(summary, "gs.project", "idle_incl_ms", units),
            "bin_ms.serve": _per_unit(summary, "gs.bin", "incl_ms", units),
            "recount_ms.serve": rc["wall_ms"] / rc["count"] if rc and rc["count"] else None,
        }
    else:
        out = {
            "project_ms.train": _per_unit(summary, "gs.project", "incl_ms", units),
            "chain_bwd_ms.train": _per_unit(summary, "gs.backward", "self_ms", units),
            "bin_ms.train": _per_unit(summary, "gs.bin", "incl_ms", units),
            "loss_host_ms.train": _per_unit(summary, "gs.loss", "wall_ms", units),
            "adam_ms.train": _per_unit(summary, "gs.adam", "incl_ms", units),
        }
    return out


def table_text(summary: dict, units: int) -> str:
    """The span table, one line a span, ms and launches a unit."""
    u = max(units, 1)
    lines = [f"{'span':<22} {'count':>6} {'wall':>9} {'self dev':>9} {'incl dev':>9} {'self ln':>8} "
             f"{'incl ln':>8} {'idle':>8} {'idle incl':>9}   (ms or launches a unit over {units} units)"]
    for name, r in sorted(summary["spans"].items(), key=lambda kv: -kv[1]["incl_ms"]):
        lines.append(f"{name:<22} {r['count'] / u:>6.2f} {r['wall_ms'] / u:>9.3f} {r['self_ms'] / u:>9.3f} "
                     f"{r['incl_ms'] / u:>9.3f} {r['self_launches'] / u:>8.1f} {r['incl_launches'] / u:>8.1f} "
                     f"{r['idle_ms'] / u:>8.3f} {r['idle_incl_ms'] / u:>9.3f}")
    cov = summary["coverage"]
    lines.append(
        f"device {summary['device_ms'] / u:.3f} ms, {summary['launches'] / u:.1f} launches a unit; roots' self "
        f"{summary['root_self_ms'] / u:.3f}, {OUTSIDE} {summary['outside_ms'] / u:.3f}, {UNATTRIBUTED} "
        f"{summary['unattributed_ms'] / u:.3f}; coverage {'-' if cov is None else f'{100 * cov:.2f}%'}; idle "
        f"{summary['idle_ms'] / u:.3f} ms a unit, {OUTSIDE} {summary['idle_outside_ms'] / u:.3f}")
    return "\n".join(lines)


class SpanWindow(tr.Window):
    """``trace.Window`` whose summary also holds the span summary, under
    ``spans``.  A copy of ``trace.Window.summary``'s export, kept only while
    that summary lacks ``spans``: once ``benchmark/trace.py`` adds them and
    ``benchmark/run.py`` prints :func:`table_text`, this class and
    :func:`main` go, and ``summarize``, ``layer_metrics`` and ``table_text``
    stay."""

    def summary(self) -> dict:
        import os
        import tempfile

        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        out = tr.summarize(events)
        out["window_s"] = self.window_s
        out["spans"] = summarize(events)
        return out


def main(argv=None) -> int:
    from benchmark import run

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=5.0, help="the untraced loop before the traced window")
    args = parser.parse_args(argv)
    run.pin_caches()
    import importlib

    import torch

    man = run.manifest()
    entry, workload, config = run.cell_files(args.workload, man)
    if not torch.cuda.is_available():
        raise SystemExit("benchmark.spans needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    traffic = importlib.import_module(f"benchmark.traffic.{workload['entry']}").Traffic(
        run.Cell(args.workload, workload, config, args.seed, dev))
    res = traffic.run(seconds=args.seconds, sample=False)
    with SpanWindow(dev) as win:
        tres = traffic.run(seconds=float(workload["trace_seconds"]), sample=False)
    t0 = time.perf_counter()
    summary = win.summary()
    read_s = time.perf_counter() - t0
    reading = run.Reading(traffic.kind, tres["units"], res["wall_s"] / max(res["units"], 1), res.get("stats", {}),
                          summary, traffic.work(tres))
    _, layer = run.metrics_of(args.workload, man)
    spans = summary.pop("spans")
    print(f"[spans] {args.workload} seed {args.seed}: {tres['units']} traced units in {win.window_s:.3f} s "
          f"({1e3 * win.window_s / max(tres['units'], 1):.3f} ms a unit), trace read in {read_s:.1f} s",
          file=sys.stderr)
    print(table_text(spans, tres["units"]), file=sys.stderr)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "units": tres["units"], "window_s": win.window_s,
        "untraced_ms_a_unit": 1e3 * res["wall_s"] / max(res["units"], 1),
        "span_metrics": layer_metrics(traffic.kind, tres["units"], spans),
        "metrics": {m["name"]: run.reader(m["name"])(reading) for m in layer},
        "idle_gaps": summary["idle_gaps"], "spans": spans, "card": run.card(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
