"""PLY -> gcloud converter CLI (reference: tools/ply_to_gcloud.rs; the JAX
package's ``tools/ply_to_gcloud.py``).

    python -m bevy_gaussian_splatting_tpu_torch.tools.ply_to_gcloud input.ply [output.gcloud]
        [--filter-sparse] [--radius R] [--neighbor-threshold K] [--npz] [--device cpu]

Optionally removes sparse outliers (k-d tree radius count) before writing,
and prints the output byte size like the reference tool.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help="input .ply (3D gaussian schema)")
    p.add_argument("output", nargs="?", default=None, help="output path (default: input with .gcloud)")
    p.add_argument("--filter-sparse", action="store_true",
                   help="remove sparse outliers before writing (SparseSelect)")
    p.add_argument("--radius", type=float, default=0.05)
    p.add_argument("--neighbor-threshold", type=int, default=3)
    p.add_argument("--npz", action="store_true", help="write the fast columnar .npz format instead")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from bevy_gaussian_splatting_tpu_torch.io.loader import load_cloud, save_cloud

    cloud = load_cloud(args.input, device=args.device)
    print(f"loaded {len(cloud)} gaussians from {args.input}")

    if args.filter_sparse:
        from bevy_gaussian_splatting_tpu_torch.query.sparse import remove_outliers

        cloud = remove_outliers(cloud, args.radius, args.neighbor_threshold)
        print(f"after sparse filter: {len(cloud)} gaussians")

    output = args.output
    if output is None:
        output = os.path.splitext(args.input)[0] + (".npz" if args.npz else ".gcloud")
    nbytes = save_cloud(cloud, output)
    print(f"wrote {output} ({nbytes} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
