"""2DGS surfel vs 3DGS debug scene (reference: tools/surfel_plane.rs; the JAX
package's ``tools/surfel_plane.py``).

Renders the same flattened-gaussian grid (``models/cloud.py``
``surfel_grid_arrays``) in 2DGS surfel mode (left) and 3DGS mode (right)
side by side.

    python -m bevy_gaussian_splatting_tpu_torch.tools.surfel_plane [-o out.png] [--size 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--output", default="surfel_plane.png")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    import torch

    from bevy_gaussian_splatting_tpu_torch.device import resolve_device
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, surfel_grid_arrays
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
    from bevy_gaussian_splatting_tpu_torch.render.api import render
    from bevy_gaussian_splatting_tpu_torch.utils.image import save_png

    dev = resolve_device(args.device)
    cloud = cloud_from_numpy(surfel_grid_arrays(), dev)
    cam = Camera.create(eye=(2.5, 2.0, 6.0), target=(0, 0, 0), width=args.size, height=args.size, device=dev)
    img2d = render(cloud, cam, CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D), device=dev)
    img3d = render(cloud, cam, CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_3D), device=dev)
    save_png(torch.cat([img2d, img3d], dim=1), args.output)
    print(f"wrote {args.output} (left: 2DGS surfel, right: 3DGS)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
