"""Differentiable-rendering example: recover moved gaussian positions by
gradient descent through the hand-derived backward kernels.  Writes the
optimised render beside its target.

    python -m bevy_gaussian_splatting_tpu_torch.examples.training [--device cpu] [--out training.png]

The JAX package's example uses optax's Adam; here ``torch.optim.Adam``
with optax's defaults (``train.step.adam``).
"""

from __future__ import annotations

import argparse
import sys

import torch

from bevy_gaussian_splatting_tpu_torch.device import resolve_device
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import test_model_3d
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
from bevy_gaussian_splatting_tpu_torch.train.losses import gaussian_splatting_loss
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step
from bevy_gaussian_splatting_tpu_torch.utils.image import save_png

STEPS = 60
SIZE = 64
LR = 2e-2
OFFSET = (0.25, -0.15, 0.1)  # the start cloud: the target's positions moved by this


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--out", default="training.png", help="PNG to write (optimised | target)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    settings = CloudSettings(aabb=True)
    target_cloud = test_model_3d(seed=11, device=dev)
    camera = Camera.create(eye=(0, 1.5, 5), width=SIZE, height=SIZE, device=dev)
    with torch.no_grad():
        target = render_tiled(target_cloud, camera, settings)

    model = TrainableCloud(target_cloud)
    with torch.no_grad():
        model.position_visibility += torch.tensor([*OFFSET, 0.0], device=dev)
    opt = adam(model, LR)
    losses = []
    for i in range(STEPS):
        # the standard 3DGS photometric objective: 0.8 L1 + 0.2 (1 - SSIM)
        losses.append(train_step(model, opt, camera, target, settings, gaussian_splatting_loss))
        if i % 10 == 0:
            print(f"step {i:3d}  loss {float(losses[-1]):.3e}")

    with torch.no_grad():
        final = render_tiled(model.cloud(), camera, settings)
    save_png(torch.cat([final, target], dim=1), args.out)
    print(f"wrote {args.out} (optimised | target), loss {float(losses[0]):.4e} -> {float(losses[-1]):.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
