"""The traced window: ``torch.profiler`` over CPU and CUDA activity, read
from its Chrome trace.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events (``gpu_user_annotation`` rows are spans, not work).
Busy time is the union of their intervals, so overlapping operations count
once.  An idle gap is a stretch between two busy intervals; it is named by
the host operation running at its middle, the innermost one (the host event
that started last among those still running).
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


class Window:
    """``with Window(device) as w:`` profiles its body (CPU activity, and
    CUDA activity on a card); afterwards ``w.summary()`` reads the trace."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def _sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
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
        out = summarize(events)
        out["window_s"] = self.window_s
        return out


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(events: list) -> dict:
    """Chrome trace events -> dict with ``busy_s`` (union of device
    operations), ``launches`` (kernels), ``device_ops`` [[name, s]] (the
    kernels and copies that took most time, summed by name), ``kernel_s``
    {name: s} for every kernel, and ``idle_gaps`` [[host op, s]] (gaps
    between busy intervals summed by the host operation at their middle)."""
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, ev.get("name", "?"), cat))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, ev.get("name", "?")))
    by_name = defaultdict(float)
    kernels = defaultdict(float)
    for s, e, name, cat in dev:
        by_name[name] += (e - s) * 1e-6
        if cat == "kernel":
            kernels[name] += (e - s) * 1e-6
    merged = _union([(s, e) for s, e, _, _ in dev])
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1) if merged[i + 1][0] > merged[i][1]]
    named = defaultdict(float)
    host.sort()
    heap: list = []
    j = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + e) / 2
        while j < len(host) and host[j][0] <= mid:
            hs, he, hn = host[j]
            heapq.heappush(heap, (-hs, he, hn))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host op)"
        named[name] += (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy,
        "launches": sum(1 for *_, cat in dev if cat == "kernel"),
        "kernel_s": dict(kernels),
        "device_ops": [[n, v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in sorted(named.items(), key=lambda kv: -kv[1])[:TOP]],
    }
