"""Streaming + LOD flyby (the reference's declared src/stream intent; the JAX
package's ``examples/streaming_lod.py``).

Slices a cloud into a chunk grid, builds a per-chunk LOD chain, then flies a
camera along +z: each frame picks each chunk's LOD level by distance and
renders the assembled set.  Writes one PNG per frame.

    python -m bevy_gaussian_splatting_tpu_torch.examples.streaming_lod [--device cpu]

Environment knobs: FLY_N (20000), FLY_FRAMES (5), FLY_SIZE (128), FLY_OUT
(the temporary directory).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from bevy_gaussian_splatting_tpu_torch.device import resolve_device
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_gaussians_3d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
from bevy_gaussian_splatting_tpu_torch.stream import build_lod_chain, concat_clouds, select_lod, slice_cloud
from bevy_gaussian_splatting_tpu_torch.utils.image import save_png


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    n = int(os.environ.get("FLY_N", 20_000))
    frames = int(os.environ.get("FLY_FRAMES", 5))
    size = int(os.environ.get("FLY_SIZE", 128))
    out_dir = os.environ.get("FLY_OUT", tempfile.gettempdir())
    levels = 3

    cloud = random_gaussians_3d_seeded(n, seed=0, device=dev)
    chunks = slice_cloud(cloud, grid=(2, 2, 2))
    chains = [build_lod_chain(c.cloud, levels=levels, ratio=0.3) for c in chunks]
    settings = CloudSettings()

    for f in range(frames):
        z = 120.0 - 18.0 * f  # fly toward the scene
        eye = (0.0, 0.0, z)
        cam = Camera.create(eye=eye, target=(0, 0, 0), width=size, height=size, device=dev)
        picks = [select_lod(c.aabb_min, c.aabb_max, eye, levels, base_distance=40.0) for c in chunks]
        resident = concat_clouds([chains[i][lv] for i, lv in enumerate(picks)]).pad(multiple=4096)
        img = render_tiled(resident, cam, settings, width=size, height=size)
        path = os.path.join(out_dir, f"flyby_{f:02d}.png")
        save_png(img, path)
        counts = [len(chains[i][lv]) for i, lv in enumerate(picks)]
        print(f"frame {f}: z={z:5.1f} levels={picks} gaussians={sum(counts)} -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
