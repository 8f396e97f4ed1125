"""Readings that set a cell's limits for ``correct``: the program's own
(sound runs) and the control's, on several seeds in one process.

    python3 -m benchmark.control --workload <name> --seeds 11,12,13 [--seconds 3]

For each seed it sets the cell up as a run does, drives a window of
``--seconds`` at the cell's own load, and prints one JSON line with the
numbers compared: ``program`` (what the timed path produced against the
reference), ``control`` (the reference computed in bfloat16, the nearest
precision below the configuration's float32, put in the program's place and
held against the float32 reference) and, in a training cell, ``half_batch``
(the reference with its loss taken over half of the image's rows, a planted
fault).  The benchmark's own runs
do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import run


def readings(name: str, seed: int, seconds: float, device: str = "cuda", n=None, overrides=None) -> dict:
    """The program's and the control's numbers for one seed."""
    _, workload, config = run.cell_files(name)
    workload = {**workload, **(overrides or {})}
    dev = torch.device(device)
    mod = __import__(f"benchmark.traffic.{workload['entry']}", fromlist=["Traffic"])
    traffic = mod.Traffic(run.Cell(name, workload, config, int(seed), dev, n))
    traffic.run(seconds=seconds)
    traffic.release()
    program = traffic.check()
    if traffic.kind == "serve":
        control = traffic.check(candidate=lambda rec: traffic.reference(rec, dtype=torch.bfloat16))
        return {"seed": seed, "program": program, "control": control}
    control = traffic.check(candidate=traffic.follow(dtype=torch.bfloat16))
    # the fault "half of the batch left out, the mean taken over the rest",
    # planted in the reference put in the program's place
    half = traffic.check(candidate=traffic.follow(loss_fn=half_batch_loss))
    return {"seed": seed, "program": program, "control": control, "half_batch": half}


def half_batch_loss(img, target):
    """The splatting loss over the top half of the image's rows only."""
    from benchmark.reference.train import splatting_loss

    h = img.shape[0] // 2
    return splatting_loss(img[:h], target[:h])


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
