#!/usr/bin/env python3
"""Time the PyTorch port's segmented-reduce kernel (``csrc/reduce.cu``) of
one source tree on the count tables of the 3DGS, 2DGS and 4DGS bench
scenes, on one NVIDIA card.

    python3 tools/torch_reduce_timing.py TREE [TREE ...]

Each TREE is a directory that holds a ``bevy_gaussian_splatting_tpu_torch``
package (this checkout's root, or a copy with another ``csrc/reduce.cu``,
for example the parent commit unpacked by ``git archive`` into a directory
that git ignores).  Each tree runs in a process of its own, in the order
given, so that copies of a kernel can be timed in turns (A B B A) on one
card.  The count tables are those of ``chip_smoke.py``'s scenes at pose 0:
the 1M bench scene in OBB (10 columns) and 2DGS (16 columns), and the 4DGS
scene (``random_gaussians_4d_seeded(1M, seed=3)`` at time 0.25, 10
columns), at 512x512 and 1920x1080; they are computed once with this
checkout's package and kept in a file under the system's temporary
directory for the trees.
For each table the kernel is held bit-equal to its plain version and timed
by ``chip_smoke.cuda_ms`` over 50 launches.  One line a tree:
``[reduce TREE] obb 512x512 <ms> | ...``, then each tree's ptxas report.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = Path(tempfile.gettempdir()) / "bgs_reduce_counts.pt"


def count_tables(cs) -> dict:
    """{label: (cum on the CPU, columns, p_max)} of the six scenes."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, random_arrays_4d_seeded
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt

    three = cloud_from_numpy(cs.bench_arrays(cs.N_GAUSSIANS, 0), "cuda")
    four = cloud_from_numpy(random_arrays_4d_seeded(cs.N_GAUSSIANS, cs.SEED_4D), "cuda")
    scenes = (
        ("obb", three, CloudSettings(), 10),
        ("2d", three, CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D), 16),
        ("4d", four, CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D, time=cs.TIME_4D), 10),
    )
    tables = {}
    for name, cloud, settings, cols in scenes:
        for width, height in cs.SIZES:
            camera = cs.orbit_camera(0.0, width, height, "cuda")
            p_max = rt.pairs_budget(len(cloud), int(rt.pair_count(cloud, camera, settings)))
            splats = rt.project_for_binning(cloud, camera, settings)
            cum = rt.expansion_inputs(splats, width, height, p_max)[0][0]
            tables[f"{name} {width}x{height}"] = (cum.cpu(), cols, p_max)
    return tables


def save_tables() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import build

    build.build_all(("expand",))
    torch.save(count_tables(cs), CACHE)


def time_tree(tree: Path) -> None:
    sys.path.insert(0, str(tree))
    sys.path.insert(1, str(ROOT))
    import torch

    import bevy_gaussian_splatting_tpu_torch as pkg
    import chip_smoke as cs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import build
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import reduce as rd

    if not Path(pkg.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {pkg.__file__}, not the package under {tree}")
    build.build_all(("reduce",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    parts = []
    for label, (cum, cols, p_max) in torch.load(CACHE).items():
        cum = cum.cuda()
        n = cum.shape[0]
        dslot = torch.randn((p_max, cols), device="cuda", generator=gen)
        got = rd.segment_reduce(dslot, cum, n)
        if not torch.equal(got.view(torch.int32), rd.segment_reduce_plain(dslot, cum, n).view(torch.int32)):
            raise AssertionError(f"{tree.name} {label}: the kernel differs from its plain version")
        parts.append(f"{label} {cs.cuda_ms(lambda: rd.segment_reduce(dslot, cum, n), 50):.4f}")
    print(f"[reduce {tree.name}] " + " | ".join(parts), flush=True)
    for kernel, usage in build.ptxas_usage("reduce"):
        print(f"[ptxas {tree.name}] {kernel}: {usage}", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--tables"]:
        save_tables()
        return 0
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        time_tree(Path(sys.argv[2]).resolve())
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    subprocess.run([sys.executable, __file__, "--tables"], check=True)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
