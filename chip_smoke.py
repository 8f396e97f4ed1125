#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bevy_gaussian_splatting_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py            # the whole run, about a minute
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of one
                                     # frame per size, written to chiprun_out/

Phases, each of which raises on failure (nothing is caught):

  1. build   every kernel under bevy_gaussian_splatting_tpu_torch/csrc with
             nvcc for sm_90a, one nvcc per source, all started together;
  2. scene   the repo's benchmark scene: 1,000,000 gaussians from
             ``random_gaussians_3d_seeded(n, seed=0)``, positions scaled by
             (1, 1, 0.25), scales by 0.05 (bench.py), camera at (0, 0, 60);
  3. kernels each kernel against its plain PyTorch version on the scene's
             real inputs at 512x512 (and 1920x1080): expansion array-equal,
             compositing within 2e-5;
  4. small   ``render()`` on the card against the port's oracle (3e-5) and
             against the same call on the CPU (2e-5), at 128x128 and 128x120;
  5. main    ``render()`` at four orbit poses at 512x512, then 1920x1080,
             with the launch counters set to 0 just before and read after;
             every frame must launch both kernels and give a finite image
             with at least a quarter of its pixels lit.

It prints the kernels line, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``.  Without a card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_GAUSSIANS = 1_000_000
SIZES = ((512, 512), (1920, 1080))
ORBIT_AZ = (0.0, 0.3, 0.6, 0.9)  # radians about +y, radius 60
TIMED_ROUNDS = 3
LIT_FLOOR = 0.25  # share of pixels with some |rgb| > 1/255
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: HBM3 bandwidth
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet: FP32 outside the tensor cores
# That peak counts an FMA as two operations (132 SMs x 128 lanes x 2 x 1.98
# GHz).  The compositor is built with --fmad=false, so it issues no FMA and
# each of its operations is one instruction: half the peak.
FP32_NO_FMA_OPS_PER_S = FP32_OPS_PER_S / 2
# The expansion is integer work: 64 INT32 lanes per SM (Hopper whitepaper),
# half the FP32 lanes, one operation per instruction.
INT32_OPS_PER_S = FP32_OPS_PER_S / 4
COMPOSITE_OPS_PER_EVAL = 26  # 25 FP32 operations and one expf per (pair, pixel)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_arrays(n: int, seed: int = 0) -> dict:
    from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded

    a = random_arrays_3d_seeded(n, seed=seed)
    a["position_visibility"] = a["position_visibility"] * np.array([1, 1, 0.25, 1], np.float32)
    a["scale_opacity"] = a["scale_opacity"] * np.array([0.05, 0.05, 0.05, 1], np.float32)
    return a


def orbit_camera(az: float, width: int, height: int, device):
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera

    eye = (60.0 * math.sin(az), 0.0, 60.0 * math.cos(az))
    return Camera.create(eye=eye, target=(0.0, 0.0, 0.0), width=width, height=height, device=device)


def phase_build() -> None:
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.build_all()
    seconds = time.perf_counter() - t0
    log(f"[build] {', '.join(build.SOURCES)} built for sm_90a in {seconds:.2f} s")


def phase_kernels(cloud, settings, width: int, height: int) -> dict:
    """Each kernel against its plain version on this frame's real inputs."""
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import expand as ex
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf

    dev = cloud.device
    camera = orbit_camera(0.0, width, height, dev)
    n = len(cloud)
    total = int(rt.pair_count(cloud, camera, settings))
    p_max = rt.pairs_budget(n, total)
    splats = rt.project_for_binning(cloud, camera, settings)
    tx_count = width // rt.TILE
    num_tiles = tx_count * (rt.pad_to_tile(height) // rt.TILE)

    # radix keys: the card's against the CPU's, counted (ROADMAP Queue 3)
    keys_card = splats["sort_key"].cpu()
    cpu_cloud, cpu_cam = cloud.to("cpu"), orbit_camera(0.0, width, height, "cpu")
    keys_cpu = rt.project_for_binning(cpu_cloud, cpu_cam, settings)["sort_key"]
    log(f"[keys {width}x{height}] radix keys differing card vs cpu: {int((keys_card != keys_cpu).sum())} of {n}")

    # ---- pair expansion: array-equal ----
    table, _ = rt.expansion_inputs(splats, width, height, p_max)
    args = (*table, p_max, tx_count, num_tiles)
    got = ex.expand_pairs(*args)
    ref = ex.expand_pairs_plain(*args)
    for name, g, r in zip(("tile", "g_cloud", "rank"), got, ref):
        if not torch.equal(g, r):
            bad = int((g != r).sum())
            raise AssertionError(f"expand_pairs {width}x{height}: {name} differs in {bad} slots")
    exp_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    exp_ms = cuda_ms(lambda: ex.expand_pairs(*args), 20)
    exp_plain_ms = cuda_ms(lambda: ex.expand_pairs_plain(*args), 5)
    exp_bytes = sum(t.numel() * 4 for t in table) + 3 * 4 * p_max
    exp_ops = p_max * (2 * math.ceil(math.log2(n + 1)) + 12)  # search + tile arithmetic

    # ---- compositor: within 2e-5 ----
    params, start, count = rt.composite_inputs(splats, width, height, p_max)
    chunk = tf.preferred_chunk(p_max, num_tiles)
    comp_args = (params, start, count, tx_count, width, height)
    raw = tf.composite_tiles_raw(*comp_args, chunk=chunk)
    walked = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    raw_plain = tf.composite_tiles_raw_plain(*comp_args, chunk=chunk, tile_batch=512, walked=walked)
    comp_err = float((raw - raw_plain).abs().max())
    if not comp_err <= 2e-5:
        raise AssertionError(f"composite_tiles_raw {width}x{height}: max |kernel - plain| = {comp_err:.3e} > 2e-5")
    comp_ms = cuda_ms(lambda: tf.composite_tiles_raw(*comp_args, chunk=chunk), 20)
    comp_plain_ms = cuda_ms(lambda: tf.composite_tiles_raw_plain(*comp_args, chunk=chunk, tile_batch=512), 2)
    evals = int(walked.sum()) * tf.PIX
    comp_bytes = params.numel() * 4 + 2 * 4 * num_tiles + raw.numel() * 4
    comp_ops = evals * COMPOSITE_OPS_PER_EVAL

    log(
        f"[kernels {width}x{height}] pairs {total} p_max {p_max} chunk {chunk} | "
        f"expand equal, {exp_ms:.4f} ms (plain {exp_plain_ms:.4f}) | "
        f"composite max_abs_err {comp_err:.3e}, {comp_ms:.4f} ms (plain {comp_plain_ms:.4f}), "
        f"pairs walked {int(walked.sum())} of {int(count.sum())}"
    )

    def bound(nbytes, nops, ops_per_s):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    eb, eby = bound(exp_bytes, exp_ops, INT32_OPS_PER_S)
    cb, cby = bound(comp_bytes, comp_ops, FP32_NO_FMA_OPS_PER_S)
    return {
        "expand_pairs": dict(max_abs_err=exp_err, ms=exp_ms, plain_ms=exp_plain_ms, bound_ms=eb, bound_by=eby),
        "composite_tiles_raw": dict(max_abs_err=comp_err, ms=comp_ms, plain_ms=comp_plain_ms, bound_ms=cb, bound_by=cby),
    }


def phase_small() -> None:
    """Small inputs: card against the oracle and against the CPU."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.render.api import render

    a = bench_arrays(2000, seed=3)
    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    for width, height in ((128, 128), (128, 120)):
        cam = orbit_camera(0.0, width, height, "cpu")
        cpu = render(cloud_from_numpy(a, "cpu"), cam, background=bg, device="cpu")
        gpu = render(cloud_from_numpy(a, "cuda"), cam.to("cuda"), background=bg.cuda())
        oracle = render(cloud_from_numpy(a, "cuda"), cam.to("cuda"), background=bg.cuda(), impl="oracle")
        e_cpu = float((gpu.cpu() - cpu).abs().max())
        e_oracle = float((gpu - oracle).abs().max())
        log(f"[small {width}x{height}] card vs cpu {e_cpu:.3e} (bar 2e-5), card vs oracle {e_oracle:.3e} (bar 3e-5)")
        if not (e_cpu <= 2e-5 and e_oracle <= 3e-5):
            raise AssertionError(f"small render {width}x{height} disagrees: cpu {e_cpu:.3e}, oracle {e_oracle:.3e}")


def phase_main(cloud, settings, profile: bool) -> dict:
    """The serving path through ``render()``; counters read per frame."""
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import composite_tiles_raw
    from bevy_gaussian_splatting_tpu_torch.render import api

    dev = cloud.device
    counters = (expand_pairs, composite_tiles_raw)
    launches = {f.__name__: 0 for f in counters}
    for width, height in SIZES:
        cams = [orbit_camera(az, width, height, dev) for az in ORBIT_AZ]
        pairs = [int(rt.pair_count(cloud, c, settings)) for c in cams]
        times = []
        for f in counters:
            f.launches = 0
        for rnd in range(TIMED_ROUNDS + 1):  # round 0 warms up
            for cam in cams:
                before = [f.launches for f in counters]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = api.render(cloud, cam, settings)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                for f, b in zip(counters, before):
                    if f.launches <= b:
                        raise AssertionError(f"{f.__name__} did not launch in a {width}x{height} frame")
                if img.shape != (height, width, 4) or not bool(torch.isfinite(img).all()):
                    raise AssertionError(f"bad image {tuple(img.shape)} at {width}x{height}")
                lit = int((img[..., :3].abs().amax(dim=-1) > 1.0 / 255.0).sum())
                if lit < LIT_FLOOR * width * height:
                    raise AssertionError(f"only {lit} lit pixels at {width}x{height}")
                if rnd:
                    times.append(dt)
        for f in counters:
            launches[f.__name__] += f.launches
        bucket = api._BUDGET_STATE[("auto", settings.static_key(), width, height, len(cloud), str(dev))][0]
        log(
            f"[main {width}x{height}] pairs per pose {pairs} p_max {bucket} "
            f"lit {lit} | median {statistics.median(times):.3f} ms/frame over {len(times)} frames "
            f"(min {min(times):.3f}, max {max(times):.3f}) | launches "
            + ", ".join(f"{f.__name__} {f.launches}" for f in counters)
        )
        if profile:
            profile_frame(cloud, settings, cams[0], width, height, statistics.median(times))
    return launches


def profile_frame(cloud, settings, camera, width: int, height: int, frame_ms: float) -> None:
    """Device time by kernel for one warm frame, to chiprun_out/.  The
    idle share is taken against ``frame_ms``, the unprofiled median frame,
    since the profiler slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bevy_gaussian_splatting_tpu_torch.render import api

    api.render(cloud, camera, settings)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        api.render(cloud, camera, settings)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
    (out / f"profile_{width}x{height}.txt").write_text(table)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(
        f"[profile {width}x{height}] {sum(e.count for e in kernels)} kernel launches, device busy "
        f"{busy_ms:.3f} ms of a {frame_ms:.3f} ms frame, idle share {max(0.0, 1 - busy_ms / frame_ms):.3f}; top: "
        + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top)
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="write a per-kernel breakdown to chiprun_out/")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: drives one card, {torch.cuda.device_count()} are visible "
              "(set CUDA_VISIBLE_DEVICES to one)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build()

    t0 = time.perf_counter()
    cloud = cloud_from_numpy(bench_arrays(N_GAUSSIANS, seed=0), "cuda")
    settings = CloudSettings()
    log(f"[scene] {len(cloud)} gaussians on {cloud.device} in {time.perf_counter() - t0:.2f} s")

    results = {}
    for width, height in SIZES:
        res = phase_kernels(cloud, settings, width, height)
        if (width, height) == SIZES[0]:
            results = res
    phase_small()
    launches = phase_main(cloud, settings, opts.profile)

    kernels = []
    sources = {
        "expand_pairs": ("bevy_gaussian_splatting_tpu_torch/csrc/expand.cu",
                         "bevy_gaussian_splatting_tpu/ops/pallas/expand.py:76"),
        "composite_tiles_raw": ("bevy_gaussian_splatting_tpu_torch/csrc/tile_fwd.cu",
                                "bevy_gaussian_splatting_tpu/ops/pallas/tile_fwd.py:237"),
    }
    for name, (source, replaces) in sources.items():
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        })
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
