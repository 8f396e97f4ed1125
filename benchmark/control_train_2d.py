"""Readings that set the 2DGS training cell's limits for ``correct``: the
program's own (sound runs) and each control's (``traffic/train_2d.py``
``CONTROLS``: the reference in bfloat16, the reference of half the
surfels, the reference with the distortion left out, and with the expected
depth in place of the median depth), on several seeds in one process.

    python3 -m benchmark.control_train_2d --workload gs2d-1m.train-512 --seeds 11,12,13 [--seconds 3]

For each seed it sets the cell up as a run does, drives a window of
``--seconds`` and prints one JSON line with the numbers compared, by
reading.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import run
from benchmark.traffic import train_2d


def readings(name: str, seed: int, seconds: float, device: str = "cuda", n=None, overrides=None) -> dict:
    """The program's and each control's numbers for one seed."""
    _, workload, config = run.cell_files(name)
    workload = {**workload, **(overrides or {})}
    traffic = train_2d.Traffic(run.Cell(name, workload, config, int(seed), torch.device(device), n))
    traffic.run(seconds=seconds)
    traffic.release()
    out = {"seed": seed, "program": traffic.check()}
    for control in train_2d.CONTROLS:
        out[control] = traffic.check(candidate=traffic.follow(control=control))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    run.pin_caches()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, **readings(args.workload, seed, args.seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
