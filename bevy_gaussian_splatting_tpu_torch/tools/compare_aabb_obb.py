"""AABB vs OBB bounding comparison scene (reference: tools/compare_aabb_obb.rs;
the JAX package's ``tools/compare_aabb_obb.py``).

Renders a grid of anisotropic gaussians twice, axis-aligned quads (left)
and eigen-oriented quads (right), side by side into one PNG.

    python -m bevy_gaussian_splatting_tpu_torch.tools.compare_aabb_obb [-o out.png] [--size 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def grid_arrays() -> dict:
    """The 4x4 grid of anisotropic gaussians, drawn as the JAX tool draws it."""
    rng = np.random.default_rng(4)
    n = 16
    xs, ys = np.meshgrid(np.linspace(-2, 2, 4), np.linspace(-2, 2, 4))
    pos = np.stack([xs.ravel(), ys.ravel(), np.zeros(n)], axis=1).astype(np.float32)
    sh = np.zeros((n, 48), np.float32)
    sh[:, :3] = rng.uniform(-1.5, 1.5, (n, 3))
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    so = np.concatenate(
        [np.tile(np.array([[0.4, 0.1, 0.02]], np.float32), (n, 1)), np.full((n, 1), 0.9, np.float32)], axis=1
    )
    return {
        "position_visibility": np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1),
        "spherical_harmonic": sh,
        "rotation": quat,
        "scale_opacity": so,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--output", default="compare_aabb_obb.png")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    import torch

    from bevy_gaussian_splatting_tpu_torch.device import resolve_device
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.render.api import render
    from bevy_gaussian_splatting_tpu_torch.utils.image import save_png

    dev = resolve_device(args.device)
    cloud = cloud_from_numpy(grid_arrays(), dev)
    cam = Camera.create(eye=(0, 0, 6), target=(0, 0, 0), width=args.size, height=args.size, device=dev)
    obb = render(cloud, cam, CloudSettings(aabb=False), device=dev)
    aabb = render(cloud, cam, CloudSettings(aabb=True), device=dev)
    save_png(torch.cat([aabb, obb], dim=1), args.output)
    print(f"wrote {args.output} (left: AABB, right: OBB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
