"""Tracing and frame diagnostics (``utils/trace.py`` of the JAX package).

The reference's observability layer is bevy's FrameTimeDiagnosticsPlugin
(FPS with EMA smoothing, viewer/viewer.rs:763-794) plus debug spans:

  - :class:`FrameDiagnostics`: EMA-smoothed frame time and FPS for the
    serving loops (headless ``--benchmark``, the viewer's ``/info``);
  - :func:`trace`: ``torch.profiler`` around a block, with the card's
    kernels when the device is the card, written as a Chrome trace
    (chrome://tracing, Perfetto, TensorBoard) into ``log_dir``;
  - :func:`span` (and the decorator :func:`spanned`): a named range of
    the program (``gs.<layer>``) on the profiler's clock, recorded only
    while a ``torch.profiler`` records, so it lands in the same Chrome
    trace as the card's kernels;
  - :func:`count`, :func:`count_later` and :func:`counters`: the program's
    counters, for code that has no object of its own to keep them on (among
    them ``geometry.steps``, the training steps whose loss took the 2DGS
    surface maps, and ``densify.added`` / ``densify.pruned``, the gaussians
    each densification added and pruned);
  - :class:`StageTimer`: host-side spans with names (the wall time of
    whatever the caller puts inside; synchronise inside the span to time
    the card's work), each also a :func:`span` of the same name.
"""

from __future__ import annotations

import contextlib
import functools
import os
import socket
import threading
import time
from typing import Optional

import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device


class FrameDiagnostics:
    """Exponential-moving-average frame clock (reference default smoothing
    factor ~2/(N+1) with N=20 history)."""

    def __init__(self, smoothing: int = 20):
        self.alpha = 2.0 / (smoothing + 1)
        self.ema_ms: Optional[float] = None
        self.last: Optional[float] = None
        self.frames = 0

    def tick(self) -> Optional[float]:
        """Mark a frame boundary; returns smoothed ms/frame (None on first)."""
        now = time.perf_counter()
        if self.last is not None:
            dt_ms = (now - self.last) * 1e3
            self.ema_ms = dt_ms if self.ema_ms is None else self.ema_ms + self.alpha * (dt_ms - self.ema_ms)
        self.last = now
        self.frames += 1
        return self.ema_ms

    @property
    def fps(self) -> Optional[float]:
        return None if not self.ema_ms else 1e3 / self.ema_ms


@contextlib.contextmanager
def trace(log_dir: str, device: DeviceLike = None):
    """Profile the block and write a Chrome trace into ``log_dir``; yields
    the ``torch.profiler.profile`` (``key_averages()`` and the like).

    ``device`` defaults to the card (and raises without one): there the
    trace records the CUDA activity beside the host's, after a synchronise
    that lets the block's kernels finish inside it.  Only ``device="cpu"``
    records a host-only trace.  The file is
    ``<host>.<pid>.<ns>.pt.trace.json``; its path is the profiler's
    ``trace_path`` attribute after the block."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("gs.bin"): ...``: a ``torch.profiler.record_function``
    range while a profiler records, and nothing otherwise (one flag check).
    It launches nothing and waits for nothing either way.  The program's
    spans are named ``gs.<layer>``, apart from torch's own annotations."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function is a :func:`span` ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


_COUNTS: dict = {}
_LATER: dict = {}  # (name, device) -> the device scalars kept there
_LOCK = threading.Lock()  # request threads of the viewer count too
RING = 4096  # device scalars a counter keeps on a device before it folds them into one


def count(name: str, value=1) -> None:
    """Add ``value``, a host number, to the counter ``name``."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + value


def count_later(name: str, value: torch.Tensor) -> None:
    """Add ``value``, a scalar tensor on any device, to the counter ``name``
    without reading it: a copy of it is kept by reference (a copy of a few
    bytes, so that the tensor it may view is freed) and read by
    :func:`counters`.  Every ``RING`` values of one device fold into one,
    on that device."""
    kept = value.detach().clone()
    key = (name, kept.device)
    with _LOCK:
        ring = _LATER.setdefault(key, [])
        ring.append(kept)
        if len(ring) >= RING:
            _LATER[key] = [torch.stack(ring).sum()]


def counters() -> dict:
    """Every counter by name -> a plain dict of host numbers (a counter kept
    by :func:`count_later` on several devices sums their totals).  Reading
    a counter kept by :func:`count_later` waits for its devices."""
    with _LOCK:
        out = dict(_COUNTS)
        rings = {key: list(ring) for key, ring in _LATER.items()}
    for (name, _), ring in rings.items():
        out[name] = out.get(name, 0) + int(torch.stack(ring).sum())
    return out


class StageTimer:
    """Named host-side spans: ``with timer.span('binning'): ...``; totals in
    ``timer.totals_ms``.  Each section is also a :func:`span` of its name,
    so it sits on a profiler's trace beside the card's work."""

    def __init__(self):
        self.totals_ms: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            self.totals_ms[name] = self.totals_ms.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "  ".join(f"{k}={v / max(self.counts[k], 1):.2f}ms" for k, v in self.totals_ms.items())
