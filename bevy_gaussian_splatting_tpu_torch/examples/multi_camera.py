"""Multi-camera example (reference: examples/multi_camera.rs): one cloud
from two cameras, the views side by side in one PNG.

    python -m bevy_gaussian_splatting_tpu_torch.examples.multi_camera [--device cpu] [--out multi_camera.png]
"""

from __future__ import annotations

import argparse
import sys

import torch

from bevy_gaussian_splatting_tpu_torch.device import resolve_device
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_gaussians_3d_seeded
from bevy_gaussian_splatting_tpu_torch.render.multi_camera import render_multi_camera
from bevy_gaussian_splatting_tpu_torch.utils.image import non_black_pixel_count, save_png


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--out", default="multi_camera.png", help="PNG to write")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cloud = random_gaussians_3d_seeded(10_000, seed=0, device=dev)
    cameras = [
        Camera.create(eye=(0.0, 1.5, 60.0), width=256, height=256, device=dev),
        Camera.create(eye=(40.0, 10.0, 40.0), width=256, height=256, device=dev),
    ]
    batch = render_multi_camera(cloud, cameras, device=dev)
    side = torch.cat(list(batch), dim=1)
    save_png(side, args.out)
    print(f"wrote {args.out} (left / right viewports, {non_black_pixel_count(side)} non-black pixels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
