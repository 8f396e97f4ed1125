"""Orbit turntable renderer: the interactive viewer's pan-orbit camera as a
batch render (reference: viewer/viewer.rs pan-orbit + screenshot hotkey; the
JAX package's ``tools/orbit_turntable.py``).

Renders N camera positions on a circular orbit around the cloud into a
contact sheet and, with ``--gif``, a looping animated GIF beside it
(``utils/image.py`` ``save_gif``: a fixed 6x6x6 palette, 120 ms a frame).

    python -m bevy_gaussian_splatting_tpu_torch.tools.orbit_turntable --test-model --gif [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input-cloud", default=None)
    p.add_argument("--gaussian-count", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test-model", action="store_true")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--radius", type=float, default=None, help="orbit radius (default: 3x cloud extent)")
    p.add_argument("--elevation", type=float, default=0.3, help="camera height as a fraction of radius")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--gif", action="store_true", help="also write a GIF")
    p.add_argument("-o", "--output", default="turntable.png")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    import torch

    from bevy_gaussian_splatting_tpu_torch.device import resolve_device
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.models.cloud import random_gaussians_3d_seeded, test_model_3d
    from bevy_gaussian_splatting_tpu_torch.render.multi_camera import render_multi_camera
    from bevy_gaussian_splatting_tpu_torch.utils.image import save_gif, save_png

    dev = resolve_device(args.device)
    if args.input_cloud:
        from bevy_gaussian_splatting_tpu_torch.io.loader import load_cloud

        cloud = load_cloud(args.input_cloud, device=dev)
    elif args.test_model:
        cloud = test_model_3d(device=dev)
    else:
        cloud = random_gaussians_3d_seeded(args.gaussian_count, args.seed, device=dev)

    mn, mx = (t.cpu().numpy() for t in cloud.compute_aabb())
    center = (mn + mx) / 2.0
    extent = float(np.abs(mx - mn).max())
    radius = args.radius or max(3.0 * extent, 1.0)

    cams = []
    for i in range(args.frames):
        theta = 2.0 * np.pi * i / args.frames
        eye = center + radius * np.array([np.cos(theta), args.elevation, np.sin(theta)])
        cams.append(Camera.create(eye=tuple(eye), target=tuple(center), width=args.size, height=args.size,
                                  device=dev))

    batch = render_multi_camera(cloud, cams, device=dev)
    save_png(torch.cat(list(batch), dim=1), args.output)
    print(f"wrote {args.output} ({args.frames} frames)")

    if args.gif:
        gif_path = os.path.splitext(args.output)[0] + ".gif"
        save_gif(list(batch), gif_path)
        print(f"wrote {gif_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
