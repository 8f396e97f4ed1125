"""Training traffic of a 2DGS surfel scene with the published objective:
``traffic/train.py``'s closed loop of ``train_step`` (the ring of
``cameras``, the targets the reference renders of the scene moved by
``target_offset``, Adam at ``lr``, the 6N pair cap, no densification, each
step's loss read to the host), under ``GaussianMode.GAUSSIAN_2D`` and with
2DGS's geometric terms: ``train_step(..., surface_loss=SurfaceLoss(...))``
with the configuration's ``objective``: ``lambda_dist``, ``lambda_normal``,
``depth_ratio``, ``near`` and ``far`` (Huang et al., SIGGRAPH 2024, section 4.2; the
official trainer past iteration 7,000, where both terms are on).  The
targets are the surfel reference's renders (``reference/splat_2d.py``).

``correct``: the plain reference ``reference/train_2d.py`` follows the
program's first three steps, as in ``train.py`` (``loss_gap``,
``grad_gap``, ``change_gap``), and beside them ``dist_gap`` and
``normal_gap``, the relative gaps of L_d and of L_n at the first step,
where both start from the same cloud.  (At the later steps L_d is not
comparable: its gap sits in one to three pixels, each held by one
fragment just past the near plane, whose depth the two clouds' float32
differences of the first steps move by a third or across the plane; sound
runs read up to 1.8 there, and ``check`` reports that worst step beside
the compared one.  ``PERF.md`` sections 2 and 6.)
``grad_gap`` leaves out the surfels seen nearly edge-on
(``train_2d.well_conditioned``).

:meth:`Traffic.follow` with ``control`` gives the readings the limits were
set against (``benchmark/control_train_2d.py``): the reference in bfloat16,
of half the surfels, with the distortion left out of its maps and
objective, and with the expected depth in place of the median.

``work()`` counts a step's operations (``counts_2d_train.py``) and the
compositors' least times, forward (``fwd_least_s``) and backward
(``bwd_least_s``), from the reference's binning of each camera.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import counts, counts_2d_train, scenes
from benchmark.reference import splat, splat_2d, train_2d
from benchmark.reference import train as ref_train
from benchmark.traffic import train

FOLLOWED = train.FOLLOWED
CONTROLS = ("bf16", "half", "no_distortion", "expected_depth")


class Traffic(train.Traffic):
    kind = "train"

    def __init__(self, cell):
        from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
        from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud
        from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
        from bevy_gaussian_splatting_tpu_torch.train.losses import SurfaceLoss, gaussian_splatting_loss
        from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step

        if cell.config["kind"] != "3d" or cell.config["gaussian_mode"] != "gaussian_2d":
            raise ValueError(f"{cell.name}: train_2d takes a 3d scene in gaussian_2d mode")
        self.cell = cell
        w = cell.workload
        dev = self.device = cell.device
        self._t = time.perf_counter()
        self.width, self.height = int(w["width"]), int(w["height"])
        self.four_d = False
        self.scene = scenes.make_scene(cell.config, cell.seed, dev, cell.n)
        n = self.scene["position_visibility"].shape[0]
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
            self.times.append(None)
        target_scene = scenes.moved(self.scene, w["target_offset"])
        self.targets = [splat_2d.render_frame(target_scene, c, chunk=self.chunk)[0] for c in self.ref_cams]
        del target_scene
        self._phase("scene, cameras and targets")
        self.weights = {key: float(v) for key, v in cell.config["objective"].items()}
        self.surface = SurfaceLoss(**self.weights)
        self.settings = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)
        self.model = TrainableCloud(Gaussian3dCloud(**self.scene))
        self.opt = adam(self.model, float(w["lr"]))
        self._phase("model and optimizer")
        self._train_step = train_step
        self._loss_fn = gaussian_splatting_loss
        self.step_index = 0
        self._ref = None
        # the first steps, through the window's own call, each recording its
        # geometric terms
        self.losses, self.terms = [], []
        recorder = _Recorded(self.surface, self.terms)
        for i in range(FOLLOWED):
            self.losses.append(self.step(recorder))
            if i == 0:
                self.grads = {
                    name: (self.opt.state[getattr(self.model, name)]["exp_avg"] / (1.0 - ref_train.BETA1)).cpu()
                    for name in self.model.fields
                }
        self.terms = [(float(d), float(nl)) for d, nl in self.terms]
        self.change_norms = {
            name: float(torch.linalg.vector_norm(getattr(self.model, name).detach() - self.scene[name]))
            for name in self.model.fields
        }
        self._phase(f"{FOLLOWED} steps the reference follows")
        self.run(steps=int(w["warmup_steps"]))
        self._phase(f"{w['warmup_steps']} warm-up steps")

    def step(self, surface_loss=None) -> float:
        j = self.step_index % len(self.cams)
        loss = self._train_step(
            self.model, self.opt, self.cams[j], self.targets[j], self.settings, self._loss_fn,
            surface_loss=surface_loss or self.surface,
        )
        self.step_index += 1
        return float(loss)

    def follow(self, dtype=torch.float32, loss_fn=None, control: str | None = None) -> dict:
        """The reference's first steps from the scene -> losses, the first
        gradient's norms, the change's norms, the geometric terms and the
        well-conditioned surfels.  ``control`` (one of ``CONTROLS``) gives a
        control's reading."""
        if control == "bf16":
            dtype = torch.bfloat16
        fields = dict(self.scene)
        if control == "half":
            fields = {k: v[::2].contiguous() for k, v in fields.items()}
        opts = dict(self.weights)
        terms = None
        if control == "no_distortion":
            def terms(*args):
                l_d, l_n = train_2d.geometry_terms(*args)
                return l_d * 0.0, l_n
        if control == "expected_depth":
            opts["depth_ratio"] = 0.0
        adam = ref_train.Adam({k: v.to(dtype) for k, v in fields.items()}, float(self.cell.workload["lr"]))
        cur = {k: v.to(dtype) for k, v in fields.items()}
        losses, geo, first = [], [], None
        for s in range(FOLLOWED):
            j = s % len(self.cams)
            loss, grads, parts = train_2d.loss_and_grads(
                cur, self.ref_cams[j], self.targets[j], self.chunk, dtype, photometric=loss_fn, terms=terms, **opts
            )
            losses.append(loss)
            geo.append(parts)
            if s == 0:
                first = {k: g.float().cpu() for k, g in grads.items()}
            cur = adam.step(cur, grads)
        change = {k: float(torch.linalg.vector_norm(cur[k].float() - fields[k])) for k in fields}
        if control == "half":  # the controls' leaves, in the program's shapes
            first = {k: _spread(g, self.scene[k].shape[0]) for k, g in first.items()}
        well = train_2d.well_conditioned(self.scene, self.ref_cams[0]).cpu()
        return {"losses": losses, "grads": first, "well": well, "change_norms": change, "terms": geo}

    def check(self, candidate=None) -> dict:
        """The gaps between the program's first steps (or ``candidate``, as
        :meth:`follow` gives it) and the reference's: ``train.gaps``, and
        ``dist_gap`` and ``normal_gap``, the first step's relative gaps of
        L_d and L_n (and, not compared, the worst of the three steps)."""
        if self._ref is None:
            self._ref = self.follow()
        ref = self._ref
        got = candidate if candidate is not None else {
            "losses": self.losses, "grads": self.grads, "change_norms": self.change_norms, "terms": self.terms,
        }
        out = train.gaps(got, ref)
        for k, name in enumerate(("dist_gap", "normal_gap")):
            rel = [abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for a, b in zip(got["terms"], ref["terms"])]
            out[name] = rel[0]
            out[name + "_worst_step"] = max(rel)
        return out

    def work(self, res: dict) -> dict:
        """Counted work a step of the traced loop ``res``, from the
        reference's binning of the scene through each step's camera."""
        cams = res["records"]
        if not cams:
            return {}
        n = self.scene["position_visibility"].shape[0]
        values = sum(v.numel() for v in self.scene.values())
        per_cam = {}
        for j in sorted(set(cams)):
            c = {"walked": 0, "inside": 0, "frags": 0}
            train_2d.render_maps(self.scene, self.ref_cams[j], self.chunk, counts=c)
            pixels = c["tiles"] * splat.PIX
            ops = counts_2d_train.step_ops(n, c["visible"], c["walked"], c["inside"], c["frags"], pixels, values)
            work = (c["walked"], c["inside"], c["frags"], c["tiles"])
            fwd = counts.least_time_s(*counts_2d_train.compositor_work(*work))
            bwd = counts.least_time_s(*counts_2d_train.compositor_work(*work, backward=True))
            per_cam[j] = (ops, fwd, bwd)
        return {key: sum(per_cam[j][k] for j in cams) / len(cams)
                for k, key in enumerate(("ops", "fwd_least_s", "bwd_least_s"))}


class _Recorded:
    """The program's surface loss that also keeps each call's (L_d, L_n),
    detached: the same arithmetic as ``SurfaceLoss.__call__``."""

    def __init__(self, loss, out: list):
        self.loss = loss
        self.near = loss.near
        self.out = out

    def __call__(self, aux, camera):
        from bevy_gaussian_splatting_tpu_torch.train.losses import surfel_geometry_terms

        s = self.loss
        dist_loss, normal_loss = surfel_geometry_terms(aux, camera, s.depth_ratio, s.near, s.far)
        self.out.append((dist_loss.detach(), normal_loss.detach()))
        return s.lambda_dist * dist_loss + s.lambda_normal * normal_loss


def _spread(g: torch.Tensor, n: int) -> torch.Tensor:
    """A half cloud's rows at the even rows of an ``n``-row leaf, zeros at
    the odd ones."""
    out = g.new_zeros((n,) + tuple(g.shape[1:]))
    out[::2] = g
    return out
