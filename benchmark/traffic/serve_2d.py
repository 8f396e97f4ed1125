"""Serving traffic of a 2DGS surfel scene: ``traffic/serve.py``'s viewer
loop (closed, one frame in flight, ``InteractiveRenderer.render_orbit``,
re-bins by the throttle, replays between), with the renderer set to
``GaussianMode.GAUSSIAN_2D`` and a configuration whose ``kind`` is ``3d``
(a surfel cloud is a ``Gaussian3dCloud``, drawn by ``scenes.make_scene``).

``correct`` holds the sampled frames to the surfel reference
(``benchmark/reference/splat_2d.py``) as ``serve.py`` holds them to its
own.  ``work()`` counts a frame's operations by ``benchmark/counts_2d.py``
and the projection kernel's least time, ``project_least_s``, for every
projection of a frame: the frame's own, a bin frame's second (it bins, then
replays) and the pair-budget recounts, which the program's counter
``budget.recounts`` gives over the traced loop.

:meth:`Traffic.control_image` renders the controls that the limits were
set against: the reference in bfloat16 (``benchmark.control``), the
reference of half the surfels, and the 3DGS reference (the OBB falloff in
place of the surfel's) of the same scene.
"""

from __future__ import annotations

import random

import torch

from benchmark import counts, counts_2d, scenes
from benchmark.reference import splat, splat_2d
from benchmark.traffic import serve

KINDS = serve.KINDS
CONTROLS = ("bf16", "half", "obb")


def _recounts() -> int:
    """The program's count of pair-budget recounts, or 0 where it keeps none."""
    try:
        from bevy_gaussian_splatting_tpu_torch.utils.trace import counters
    except ImportError:
        return 0
    return int(counters().get("budget.recounts", 0))


class Traffic(serve.Traffic):
    kind = "serve"

    def __init__(self, cell):
        from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud
        from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
        from bevy_gaussian_splatting_tpu_torch.render.api import InteractiveRenderer

        if cell.config["kind"] != "3d" or cell.config["gaussian_mode"] != "gaussian_2d":
            raise ValueError(f"{cell.name}: serve_2d takes a 3d scene in gaussian_2d mode")
        self.cell = cell
        w = cell.workload
        self.device = cell.device
        self.width, self.height = int(w["width"]), int(w["height"])
        self.scene = scenes.make_scene(cell.config, cell.seed, self.device, cell.n)
        self.cloud = Gaussian3dCloud(**self.scene)
        settings = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)
        self.renderer = InteractiveRenderer(settings, period_floor_ms=float(w["period_floor_ms"]), device=self.device)
        self.rng = random.Random(cell.seed)
        self.frame = 0
        self.bin_pose = None
        self.samples = {k: [] for k in KINDS}
        self.seen = {k: 0 for k in KINDS}
        self.run(frames=int(w["warmup_frames"]), sample=False)

    def run(self, seconds: float | None = None, frames: int | None = None, sample: bool = True) -> dict:
        before = _recounts()
        res = super().run(seconds=seconds, frames=frames, sample=sample)
        res["recounts"] = _recounts() - before
        return res

    def reference(self, record, dtype=torch.float32, counts_out=None):
        cam, t, bin_cam, bin_t = self._cams(record)
        img, _ = splat_2d.render_frame(self.scene, cam, t, bin_cam, bin_t, dtype=dtype, counts=counts_out)
        return img.float()

    def control_image(self, record, control: str):
        """The image of control ``control`` (one of ``CONTROLS``) for a
        sampled frame, put in the program's place."""
        if control == "bf16":
            return self.reference(record, dtype=torch.bfloat16)
        cam, t, bin_cam, bin_t = self._cams(record)
        if control == "half":
            half = {k: v[::2].contiguous() for k, v in self.scene.items()}
            return splat_2d.render_frame(half, cam, t, bin_cam, bin_t)[0].float()
        if control == "obb":
            return splat.render_frame(self.scene, cam, t, bin_cam, bin_t)[0].float()
        raise ValueError(f"unknown control {control!r}")

    def work(self, res: dict, samples: int = 4) -> dict:
        """Counted work a frame of the traced loop ``res``: the mean over
        ``samples`` of its frames, evenly spaced, and the projections'
        least time a frame."""
        recs = res["records"]
        if not recs:
            return {}
        m = min(samples, len(recs))
        picks = [recs[(2 * j + 1) * len(recs) // (2 * m)] for j in range(m)]
        n = self.scene["position_visibility"].shape[0]
        ops = fwd = 0.0
        for rec in picks:
            c = {"walked": 0, "inside": 0}
            self.reference(rec, counts_out=c)
            pixels = c["tiles"] * splat.PIX
            ops += counts_2d.frame_ops(n, c["visible"], c["walked"], c["inside"], pixels)
            fwd += counts.least_time_s(*counts_2d.compositor_work(c["walked"], c["inside"], c["tiles"]))
        projections = res["units"] + res["stats"]["bins"] + res.get("recounts", 0)
        return {
            "ops": ops / len(picks),
            "fwd_least_s": fwd / len(picks),
            "project_least_s": counts_2d.project_least_s(n) * projections / res["units"],
        }
