"""Training traffic: ``train_step`` in a closed loop, as
``examples/training.py`` calls it: ``gaussian_splatting_loss`` (0.8 L1 +
0.2 D-SSIM), ``train.step.adam`` at ``lr``, no ``pairs_max`` (the 6N
default), no densification.

Step i renders through camera i mod ``cameras`` (eye on the ring of
``radius`` at elevation ``elevation``, azimuth 2 pi k / ``cameras``, looking
at the origin) and, for a 4DGS scene, at time ``time0 + time_step * (i mod
cameras)``, against the target of that camera and time: the reference's
render (``benchmark/reference/splat.py``) of the scene moved by
``target_offset``, made at set-up.  Each step reads its loss to the host,
as 3DGS's training loop does every iteration.

``correct``: set-up drives the training object through its first three
steps (the window's own call), then warms up and hands the same object to
the window.  After the window the reference follows the three steps from
the same scene (its own projection, binning, compositing, loss, autograd
and Adam).  Compared: each step's loss (``loss_gap``, relative); each
leaf's first gradient as Adam got it, from its first moment after one step
(``grad_gap``); each leaf's change after the three steps (``change_gap``).
The gaps of norms are taken against the reference leaf's norm or the
median leaf's, whichever is larger, by the worst leaf; a leaf whose
reference gradient norm is under a thousandth of the median leaf's is left
out of the change.
"""

from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from benchmark import counts, scenes
from benchmark.reference import splat
from benchmark.reference import train as ref_train

FOLLOWED = 3  # steps the reference follows


class Traffic:
    kind = "train"

    def __init__(self, cell):
        from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
        from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud, Gaussian4dCloud
        from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
        from bevy_gaussian_splatting_tpu_torch.train.losses import gaussian_splatting_loss
        from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step

        self.cell = cell
        w = cell.workload
        dev = self.device = cell.device
        self._t = time.perf_counter()
        self.width, self.height = int(w["width"]), int(w["height"])
        self.four_d = cell.config["kind"] == "4d"
        self.scene = scenes.make_scene(cell.config, cell.seed, dev, cell.n)
        n = self.scene["position_visibility"].shape[0]
        # the training budget is the 6N cap, so its chunk grid is 512 pairs
        # unless the cap averages at most 320 pairs a tile
        tiles = (self.width // splat.TILE) * (-(-self.height // splat.TILE))
        self.chunk = splat.chunk_for(splat.pair_cap(n), tiles)
        k = int(w["cameras"])
        proj = splat.perspective_np(self.width, self.height)
        el, radius = float(w["elevation"]), float(w["radius"])
        self.ref_cams, self.cams, self.times = [], [], []
        for j in range(k):
            az = 2.0 * math.pi * j / k
            eye = (radius * math.cos(el) * math.sin(az), radius * math.sin(el), radius * math.cos(el) * math.cos(az))
            view = splat.look_at_np(eye)
            self.ref_cams.append(splat.host_camera(view, proj, self.width, self.height, dev))
            self.cams.append(Camera.from_matrices(view, proj, self.width, self.height, device=dev))
            self.times.append(float(w["time0"]) + float(w["time_step"]) * j if self.four_d else None)
        target_scene = scenes.moved(self.scene, w["target_offset"])
        self.targets = [
            splat.render_frame(target_scene, c, t, chunk=self.chunk)[0] for c, t in zip(self.ref_cams, self.times)
        ]
        del target_scene
        self._phase("scene, cameras and targets")
        self.settings = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D) if self.four_d else CloudSettings()
        cls = Gaussian4dCloud if self.four_d else Gaussian3dCloud
        self.model = TrainableCloud(cls(**self.scene))
        self.opt = adam(self.model, float(w["lr"]))
        self._phase("model and optimizer")
        self._train_step = train_step
        self._loss_fn = gaussian_splatting_loss
        self.step_index = 0
        self._ref = None
        # the first steps, through the window's own call: what the
        # reference follows, read before step FOLLOWED + 1 changes it
        self.losses = []
        for i in range(FOLLOWED):
            self.losses.append(self.step())
            if i == 0:
                # the first gradient as Adam got it: its first moment after
                # one step is (1 - beta1) g; kept on the host until the check
                self.grads = {
                    name: (self.opt.state[getattr(self.model, name)]["exp_avg"] / (1.0 - ref_train.BETA1)).cpu()
                    for name in self.model.fields
                }
        self.change_norms = {
            name: float(torch.linalg.vector_norm(getattr(self.model, name).detach() - self.scene[name]))
            for name in self.model.fields
        }
        self._phase(f"{FOLLOWED} steps the reference follows")
        self.run(steps=int(w["warmup_steps"]))
        self._phase(f"{w['warmup_steps']} warm-up steps")

    def _phase(self, label: str) -> None:
        """Seconds of a set-up phase on stderr."""
        self._sync()
        now = time.perf_counter()
        print(f"[train] {label}: {now - self._t:.3f} s", file=sys.stderr)
        self._t = now

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> float:
        j = self.step_index % len(self.cams)
        loss = self._train_step(
            self.model, self.opt, self.cams[j], self.targets[j], self.settings, self._loss_fn, time=self.times[j]
        )
        self.step_index += 1
        return float(loss)

    def run(self, seconds: float | None = None, steps: int | None = None, sample: bool = True) -> dict:
        """The closed loop for ``seconds`` (or ``steps`` steps) -> dict with
        ``units``, ``wall_s``, ``failed`` (non-finite losses) and the
        camera index of each step."""
        done, failed, cams, lat = 0, 0, [], []
        self._sync()
        t_start = time.perf_counter()
        while True:
            if steps is not None and done >= steps:
                break
            if seconds is not None and time.perf_counter() - t_start >= seconds:
                break
            cams.append(self.step_index % len(self.cams))
            t0 = time.perf_counter()
            failed += not math.isfinite(self.step())
            lat.append(time.perf_counter() - t0)
            done += 1
        wall = time.perf_counter() - t_start
        return {"units": done, "wall_s": wall, "failed": failed, "records": cams, "latencies_s": lat}

    @staticmethod
    def end_to_end(res: dict) -> dict:
        return {"step_ms": 1e3 * res["wall_s"] / res["units"]}

    def release(self) -> None:
        self.model = None
        self.opt = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, dtype=torch.float32, loss_fn=None) -> dict:
        """The reference's first steps from the scene -> losses, the first
        gradient's norms and the change's norms, by leaf.  ``dtype`` and
        ``loss_fn`` give the control and a planted fault."""
        fields = {k: v for k, v in self.scene.items()}
        adam = ref_train.Adam({k: v.to(dtype) for k, v in fields.items()}, float(self.cell.workload["lr"]))
        cur = {k: v.to(dtype) for k, v in fields.items()}
        losses, first, well = [], None, None
        for s in range(FOLLOWED):
            j = s % len(self.cams)
            loss, grads, conditioned = ref_train.loss_and_grads(
                cur, self.ref_cams[j], self.targets[j], self.times[j], self.chunk, dtype, loss_fn=loss_fn
            )
            losses.append(loss)
            if s == 0:
                first = {k: g.float().cpu() for k, g in grads.items()}
                well = conditioned.cpu()
            cur = adam.step(cur, grads)
        change = {k: float(torch.linalg.vector_norm(cur[k].float() - fields[k])) for k in fields}
        return {"losses": losses, "grads": first, "well": well, "change_norms": change}

    def check(self, candidate=None) -> dict:
        """The gaps between the program's first steps (or ``candidate``, a
        dict as :meth:`follow` gives, for the control) and the reference's."""
        if self._ref is None:
            self._ref = self.follow()
        ref = self._ref
        got = candidate if candidate is not None else {
            "losses": self.losses, "grads": self.grads, "change_norms": self.change_norms,
        }
        return gaps(got, ref)

    def sampled(self) -> int:
        return FOLLOWED

    def work(self, res: dict) -> dict:
        """Counted work a step of the traced loop ``res``, from the
        reference's binning of the scene through each step's camera."""
        cams = res["records"]
        if not cams:
            return {}
        n = self.scene["position_visibility"].shape[0]
        values = sum(v.numel() for v in self.scene.values())
        kind = self.cell.config["kind"]
        per_cam = {}
        for j in sorted(set(cams)):
            c = {"walked": 0, "inside": 0}
            splat.render_frame(self.scene, self.ref_cams[j], self.times[j], chunk=self.chunk, counts=c)
            pixels = c["tiles"] * splat.PIX
            ops = counts.step_ops(kind, n, c["visible"], c["walked"], c["inside"], pixels, values)
            bwd = counts.least_time_s(*counts.compositor_work(c["walked"], c["inside"], c["tiles"], backward=True))
            per_cam[j] = (ops, bwd)
        return {
            "ops": sum(per_cam[j][0] for j in cams) / len(cams),
            "bwd_least_s": sum(per_cam[j][1] for j in cams) / len(cams),
        }


def leaf_gaps(got: dict, ref: dict, keys=None) -> dict:
    """Each leaf's gap of norms over the reference leaf's norm or the median
    leaf's, whichever is larger."""
    keys = list(ref) if keys is None else keys
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def gaps(got: dict, ref: dict) -> dict:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap``: the worst leaf's gap of the first gradient's norms, over
    the splats whose OBB axis is well-conditioned in the reference
    (``splat.well_conditioned``; the others' gradient is rounding noise in
    any float32 evaluation, see ``PERF.md``); ``change_gap``: the worst
    leaf's gap of the change's norms after the steps, leaving out a leaf
    whose reference gradient is under a thousandth of the median leaf's.
    Not compared, for the record: ``grad_gap_all_rows``, the worst leaf's
    gap over every splat, and ``ill_conditioned``, the splats left out."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], ref["losses"]))
    well = ref["well"]

    def norms(grads, rows=None):
        return {k: float(torch.linalg.vector_norm(g if rows is None else g[rows])) for k, g in grads.items()}

    g_ref = norms(ref["grads"], well)
    grads = leaf_gaps(norms(got["grads"], well), g_ref)
    g_med = statistics.median(g_ref.values())
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    change = leaf_gaps(got["change_norms"], ref["change_norms"], moved)
    return {
        "loss_gap": loss_gap,
        "grad_gap": max(grads.values()),
        "change_gap": max(change.values()),
        "grad_gap_all_rows": max(leaf_gaps(norms(got["grads"]), norms(ref["grads"])).values()),
        "ill_conditioned": int((~well).sum()),
    }
