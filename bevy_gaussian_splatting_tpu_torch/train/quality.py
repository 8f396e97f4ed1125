"""Training-quality (convergence) benchmark.

The counterpart of the JAX package's ``train/quality.py``: a fixed-seed
multiview fit (L1 + D-SSIM, Adam, one adaptive density-control interval)
whose final PSNR pins the training dynamics of the differentiable renderer.
A gradient term that is tiny at a test point but biased passes pointwise
gradient tests and moves this number.  Here the fit runs through the port's
hand-derived backward: the CUDA kernels on the card, their plain versions on
the CPU.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import test_model_3d
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
from bevy_gaussian_splatting_tpu_torch.train.densify import (
    accumulate_stats,
    densify_and_prune,
    init_densify_state,
)
from bevy_gaussian_splatting_tpu_torch.train.losses import gaussian_splatting_loss
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step


def psnr_db(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR in dB of two images in [0, 1], over all channels."""
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


def _init_arrays(target_cloud, n: int, seed: int) -> dict:
    """The protocol's starting cloud as numpy arrays: ``n // 2`` live
    gaussians uniform inside the target's AABB (scale 0.25, opacity 0.5,
    identity rotation, SH ~ N(0, 0.2)) and dead slots after them
    (quality.py:89-101 of the JAX package, the same numpy draws)."""
    rng = np.random.default_rng(seed)
    live = n // 2
    lo, hi = (t.cpu().numpy() for t in target_cloud.compute_aabb())
    pv = np.zeros((n, 4), np.float32)
    pv[:live, :3] = rng.uniform(lo, hi, (live, 3))
    pv[:live, 3] = 1.0
    so = np.zeros((n, 4), np.float32)
    so[:live, :3] = 0.25
    so[:live, 3] = 0.5
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    sh = np.zeros((n, target_cloud.spherical_harmonic.shape[1]), np.float32)
    sh[:live] = rng.normal(0.0, 0.2, (live, sh.shape[1])).astype(np.float32)
    return {"position_visibility": pv, "spherical_harmonic": sh, "rotation": rot, "scale_opacity": so}


def convergence_psnr(
    steps: int = 120,
    n_views: int = 4,
    n: int = 256,
    size: int = 64,
    densify_at: Optional[int] = None,
    settings: Optional[CloudSettings] = None,
    lr: float = 1e-2,
    seed: int = 0,
    device: DeviceLike = None,
) -> dict:
    """Fit a fixed-seed random cloud to orbit renders of the deterministic
    test model; return the final mean PSNR over all training views.

    The JAX package's protocol, frozen so the number compares across both
    packages: targets from ``test_model_3d(seed=11)`` at ``n_views`` orbit
    cameras, :func:`_init_arrays`, Adam(lr) on ``gaussian_splatting_loss``
    with ``accumulate_stats`` every step, one ``densify_and_prune(k_budget=n
    // 8)`` after step ``densify_at`` (default ``steps // 2``) followed by a
    fresh Adam (the moment reset), ``CloudSettings(aabb=True)`` and
    ``render_tiled``'s default pair budget.  Runs on the card unless
    ``device="cpu"``.  Also returns the loss of every step."""
    dev = resolve_device(device)
    if settings is None:
        settings = CloudSettings(aabb=True)
    if densify_at is None:
        densify_at = steps // 2
    t0 = time.perf_counter()

    target_cloud = test_model_3d(seed=11, device=dev)
    cams = []
    for i in range(n_views):
        a = 2.0 * np.pi * i / n_views
        eye = (5.0 * np.sin(a), 1.0, 5.0 * np.cos(a))
        cams.append(Camera.create(eye=eye, target=(0, 0, 0), width=size, height=size, device=dev))
    with torch.no_grad():
        targets = [render_tiled(target_cloud, c, settings) for c in cams]

    lo, hi = (t.cpu().numpy() for t in target_cloud.compute_aabb())
    model = TrainableCloud.from_numpy(_init_arrays(target_cloud, n, seed), dev)
    opt = adam(model, lr)
    dstate = init_densify_state(n, device=dev)

    losses = []
    stats = None
    for i in range(steps):
        v = i % n_views
        losses.append(train_step(model, opt, cams[v], targets[v], settings, gaussian_splatting_loss))
        dstate = accumulate_stats(dstate, model.grads())
        if i + 1 == densify_at:
            new_cloud, dstate, stats = densify_and_prune(
                model.cloud(), dstate, k_budget=n // 8, scene_extent=float(np.max(hi - lo))
            )
            with torch.no_grad():
                for name in model.fields:
                    getattr(model, name).copy_(getattr(new_cloud, name))
            opt = adam(model, lr)

    with torch.no_grad():
        finals = [render_tiled(model.cloud(), c, settings) for c in cams]
    per_view = [psnr_db(f, t) for f, t in zip(finals, targets)]
    losses = [float(v) for v in losses]
    return {
        "psnr_db": float(np.mean(per_view)),
        "psnr_per_view": per_view,
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "densify": None if stats is None else {k: int(v) for k, v in stats.items()},
        "steps": steps,
        "n": n,
        "size": size,
        "device": str(dev),
        "seconds": time.perf_counter() - t0,
    }
