"""Multi-view 3DGS training from scratch: a random cloud fitted to orbit
renders of the deterministic test model with the standard recipe (L1 +
D-SSIM, Adam, clone / split / prune every 100 steps).  Prints the PSNR
along the way and writes the target beside the result.

    python -m bevy_gaussian_splatting_tpu_torch.examples.train_multiview [--device cpu] [--out PATH]
        [--steps 300] [--views 6] [--n 256] [--size 64]

The JAX package's example reads these four settings from environment
variables; here they are flags.  Adam is ``torch.optim.Adam`` with optax's
defaults (``train.step.adam``), densification ``train.densify``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import resolve_device
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import test_model_3d
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
from bevy_gaussian_splatting_tpu_torch.train.densify import accumulate_stats, densify_and_prune, init_densify_state
from bevy_gaussian_splatting_tpu_torch.train.losses import gaussian_splatting_loss
from bevy_gaussian_splatting_tpu_torch.train.quality import _init_arrays, psnr_db
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step
from bevy_gaussian_splatting_tpu_torch.utils.image import save_png

LR = 1e-2
DENSIFY_EVERY = 100


def orbit_cameras(n_views: int, radius: float, width: int, height: int, device) -> list:
    cams = []
    for i in range(n_views):
        a = 2.0 * np.pi * i / n_views
        eye = (radius * np.sin(a), 1.0, radius * np.cos(a))
        cams.append(Camera.create(eye=eye, target=(0, 0, 0), width=width, height=height, device=device))
    return cams


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--out", default="train_multiview.png", help="PNG to write (target | trained)")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--views", type=int, default=6)
    parser.add_argument("--n", type=int, default=256, help="cloud capacity (half live at the start)")
    parser.add_argument("--size", type=int, default=64, help="image side in pixels")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    settings = CloudSettings(aabb=True)

    target_cloud = test_model_3d(seed=11, device=dev)
    cams = orbit_cameras(args.views, 5.0, args.size, args.size, dev)
    with torch.no_grad():
        targets = [render_tiled(target_cloud, c, settings) for c in cams]

    # random start inside the target's bounds, half the slots dead (room to
    # densify): the JAX example's draws (train/quality.py's protocol)
    lo, hi = (t.cpu().numpy() for t in target_cloud.compute_aabb())
    model = TrainableCloud.from_numpy(_init_arrays(target_cloud, args.n, 0), dev)
    opt = adam(model, LR)
    dstate = init_densify_state(args.n, device=dev)

    for i in range(args.steps):
        v = i % args.views
        value = train_step(model, opt, cams[v], targets[v], settings, gaussian_splatting_loss)
        dstate = accumulate_stats(dstate, model.grads())
        if (i + 1) % DENSIFY_EVERY == 0 and i + 1 < args.steps:
            cloud, dstate, _ = densify_and_prune(
                model.cloud(), dstate, k_budget=args.n // 8, scene_extent=float(np.max(hi - lo))
            )
            with torch.no_grad():
                for name in model.fields:
                    getattr(model, name).copy_(getattr(cloud, name))
            # densify rewrites slots, so their Adam moments describe other
            # gaussians: start Adam again
            opt = adam(model, LR)
        if i % 50 == 0 or i == args.steps - 1:
            with torch.no_grad():
                img0 = render_tiled(model.cloud(), cams[0], settings)
            print(f"step {i:4d}  loss {float(value):.4e}  view0 PSNR {psnr_db(img0, targets[0]):.2f} dB")

    with torch.no_grad():
        final = render_tiled(model.cloud(), cams[0], settings)
    save_png(torch.cat([targets[0], final], dim=1), args.out)
    print(f"wrote {args.out} (target | trained), final view0 PSNR {psnr_db(final, targets[0]):.2f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
