"""Minimal example (reference: examples/minimal.rs): a seeded random cloud,
rendered once and written as a PNG.

    python -m bevy_gaussian_splatting_tpu_torch.examples.minimal [--device cpu] [--out minimal.png]
"""

from __future__ import annotations

import argparse
import sys

from bevy_gaussian_splatting_tpu_torch.device import resolve_device
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_gaussians_3d_seeded
from bevy_gaussian_splatting_tpu_torch.render.api import render
from bevy_gaussian_splatting_tpu_torch.utils.image import non_black_pixel_count, save_png


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--out", default="minimal.png", help="PNG to write")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cloud = random_gaussians_3d_seeded(10_000, seed=0, device=dev)
    camera = Camera.create(eye=(0.0, 0.0, 60.0), width=512, height=512, device=dev)
    image = render(cloud, camera, device=dev)
    save_png(image, args.out)
    print(f"wrote {args.out} ({non_black_pixel_count(image)} non-black pixels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
