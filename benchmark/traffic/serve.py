"""Serving traffic: a viewer in a closed loop, one frame in flight, through
``InteractiveRenderer.render_orbit``.

Frame i (counted from the first warm-up frame) is at azimuth ``azimuth0 +
azimuth_step * i``, elevation ``elevation``, radius ``radius`` about the
origin, and, for a 4DGS scene, at time ``(time0 + time_step * i) mod 1``.
Each frame ends when its image is complete on the card (a synchronise), as
the browser viewer's ``/frame`` request waits for its read-back.  The
renderer bins again when the camera moved and its throttle period passed
(``period_floor_ms``), replays the stale binning otherwise, and renders a
frame whose time changed in one pass.

``correct``: a sample of the window's frames of each kind (bin, replay,
one-pass), drawn from the seed, is rendered again by the reference
(``benchmark/reference/splat.py``); a replay from the binning at the pose
and time of the last bin frame before it, which the renderer's ``stats``
mark.  Compared: the widest gap of any pixel value (``max_abs``) and the
root mean square of the gaps (``rmse``), each the worst frame's.
"""

from __future__ import annotations

import math
import random
import time

import torch

from benchmark import counts, scenes
from benchmark.reference import splat

KINDS = ("bins", "replays", "oneshots")


class Traffic:
    kind = "serve"

    def __init__(self, cell):
        from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud, Gaussian4dCloud
        from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
        from bevy_gaussian_splatting_tpu_torch.render.api import InteractiveRenderer

        self.cell = cell
        w = cell.workload
        self.device = cell.device
        self.width, self.height = int(w["width"]), int(w["height"])
        self.scene = scenes.make_scene(cell.config, cell.seed, self.device, cell.n)
        four_d = cell.config["kind"] == "4d"
        self.cloud = (Gaussian4dCloud if four_d else Gaussian3dCloud)(**self.scene)
        settings = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D) if four_d else CloudSettings()
        self.renderer = InteractiveRenderer(settings, period_floor_ms=float(w["period_floor_ms"]), device=self.device)
        self.rng = random.Random(cell.seed)
        self.frame = 0
        self.bin_pose = None
        self.samples = {k: [] for k in KINDS}
        self.seen = {k: 0 for k in KINDS}
        self.run(frames=int(w["warmup_frames"]), sample=False)

    def pose(self, i: int) -> tuple:
        w = self.cell.workload
        az = float(w["azimuth0"]) + float(w["azimuth_step"]) * i
        t = (float(w["time0"]) + float(w["time_step"]) * i) % 1.0
        return az, t

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _keep(self, kind: str, record: tuple, img) -> None:
        """Reservoir sampling of each kind's frames, drawn from the seed."""
        k = int(self.cell.workload["sample"].get(kind, 0))
        self.seen[kind] += 1
        if not k:
            return
        slot = len(self.samples[kind]) if len(self.samples[kind]) < k else self.rng.randrange(self.seen[kind])
        if slot < k:
            item = (*record, img.clone())
            if slot < len(self.samples[kind]):
                self.samples[kind][slot] = item
            else:
                self.samples[kind].append(item)

    def run(self, seconds: float | None = None, frames: int | None = None, sample: bool = True) -> dict:
        """The closed loop for ``seconds`` (or ``frames`` frames) -> dict
        with ``units``, ``wall_s``, ``latencies_s``, the renderer's
        ``stats`` over the loop and each frame's pose record."""
        w = self.cell.workload
        el, radius = float(w["elevation"]), float(w["radius"])
        r = self.renderer
        start_stats = dict(r.stats)
        lat, records = [], []
        self._sync()
        t_start = time.perf_counter()
        while True:
            if frames is not None and len(lat) >= frames:
                break
            if seconds is not None and time.perf_counter() - t_start >= seconds:
                break
            az, t = self.pose(self.frame)
            before = dict(r.stats)
            t0 = time.perf_counter()
            img = r.render_orbit(self.cloud, az, el, radius, width=self.width, height=self.height, time=t)
            self._sync()
            lat.append(time.perf_counter() - t0)
            kind = next(k for k in KINDS if r.stats[k] > before[k])
            if kind == "bins":
                self.bin_pose = (az, t)
            record = (kind, self.frame, az, t, self.bin_pose)
            records.append(record)
            if sample:
                self._keep(kind, record, img)
            self.frame += 1
        wall = time.perf_counter() - t_start
        stats = {k: r.stats[k] - start_stats[k] for k in KINDS}
        return {"units": len(lat), "wall_s": wall, "latencies_s": lat, "stats": stats, "records": records}

    @staticmethod
    def end_to_end(res: dict) -> dict:
        lat = sorted(res["latencies_s"])
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]  # nearest rank
        return {"frame_ms": 1e3 * res["wall_s"] / res["units"], "frame_p95_ms": 1e3 * p95}

    def release(self) -> None:
        """Drop the program's state: what the check needs is the benchmark's."""
        self.renderer = None
        self.cloud = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _cams(self, record):
        kind, _, az, t, bin_pose = record
        w = self.cell.workload
        el, radius = float(w["elevation"]), float(w["radius"])
        cam = splat.orbit_camera(az, el, radius, self.width, self.height, self.device)
        if kind != "replays":
            return cam, t, None, None
        return cam, t, splat.orbit_camera(bin_pose[0], el, radius, self.width, self.height, self.device), bin_pose[1]

    def reference(self, record, dtype=torch.float32, counts_out=None):
        cam, t, bin_cam, bin_t = self._cams(record)
        img, _ = splat.render_frame(self.scene, cam, t, bin_cam, bin_t, dtype=dtype, counts=counts_out)
        return img.float()

    def check(self, candidate=None) -> dict:
        """Worst ``max_abs`` and ``rmse`` over the sampled frames.
        ``candidate(record)`` replaces the program's image (the control)."""
        worst = {"max_abs": 0.0, "rmse": 0.0}
        for kind in KINDS:
            for *record, img in self.samples[kind]:
                ref = self.reference(tuple(record))
                got = img if candidate is None else candidate(tuple(record))
                gap = (got.float() - ref).abs()
                worst["max_abs"] = max(worst["max_abs"], float(gap.max()))
                worst["rmse"] = max(worst["rmse"], float(torch.sqrt(torch.mean(gap * gap))))
        return worst

    def sampled(self) -> int:
        return sum(len(v) for v in self.samples.values())

    def work(self, res: dict, samples: int = 4) -> dict:
        """Counted work a frame of the traced loop ``res``: the mean over
        ``samples`` of its frames, evenly spaced."""
        recs = res["records"]
        if not recs:
            return {}
        m = min(samples, len(recs))
        picks = [recs[(2 * j + 1) * len(recs) // (2 * m)] for j in range(m)]
        n = self.scene["position_visibility"].shape[0]
        kind = self.cell.config["kind"]
        ops = fwd = 0.0
        for rec in picks:
            c = {"walked": 0, "inside": 0}
            self.reference(rec, counts_out=c)
            pixels = c["tiles"] * splat.PIX
            ops += counts.frame_ops(kind, n, c["visible"], c["walked"], c["inside"], pixels)
            fwd += counts.least_time_s(*counts.compositor_work(c["walked"], c["inside"], c["tiles"]))
        return {"ops": ops / len(picks), "fwd_least_s": fwd / len(picks)}
