"""Scaling models of the sharded path and its measured work ratio.

The counterpart of the JAX package's ``parallel/scaling.py``.  The models
take the link rates and the per-collective launch floor as an argument
(:class:`Links`): this module carries no hardware's numbers.

1. **Bytes over bandwidth.** The sharded render's only cross-rank traffic
   is the per-frame exchange of projected rows, whose bytes per rank are
   ``exchange_bytes_per_device``; per-rank work divides by the band count
   (band pair sets partition the frame's), so

       T_n = work_ratio * T_1 / n  +  recv_bytes(n) / link_rate  +  launch
       eff(n) = T_1 / (n * T_n)

2. **Measured work ratio** (:func:`measured_work_ratio`): the total work of
   an n-rank frame over one rank's frame of the whole cloud, the sharding
   overhead (duplicated steps, exchange shuffling, padding) that the model's
   T_1 / n assumes away.  On the CPU it is host wall time, true work only
   where the ranks share one core (:func:`serialized_work_ratio` on the
   CPU pins them to one, as the JAX package pins its virtual devices); on
   one card it is
   the sum of the ranks' device time (kernels and copies, from the
   profiler) over one rank's device time on the whole cloud.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.parallel.exchange import exchange_bytes_per_device


class Links(NamedTuple):
    """A model's link rates (bytes/s per rank) and launch floor (s)."""

    intra_bytes_per_s: float  # between ranks of one host (the tiles axis)
    inter_bytes_per_s: float  # between hosts (the camera axis)
    launch_s: float  # per collective


def exchange_time_s(n_total: int, n_bands: int, cols: int, links: Links, budget: Optional[int] = None,
                    link: str = "intra") -> float:
    """Modeled per-frame exchange time: received bytes over the link rate,
    plus the launch floor."""
    vols = exchange_bytes_per_device(n_total, n_bands, cols, budget)
    recv = vols["bounded"] if budget is not None else vols["allgather"]
    rate = links.intra_bytes_per_s if link == "intra" else links.inter_bytes_per_s
    return recv / rate + links.launch_s


def modeled_efficiency(t_single_s: float, n_total: int, n_bands: int, links: Links, cols: int = 14,
                       budget: Optional[int] = None, link: str = "intra", work_ratio: float = 1.0) -> float:
    """eff(n) = T_1 / (n * T_n), T_n = work_ratio * T_1 / n + T_exchange."""
    t_comm = exchange_time_s(n_total, n_bands, cols, links, budget, link)
    t_n = work_ratio * t_single_s / n_bands + t_comm
    return t_single_s / (n_bands * t_n)


def train_comm_bytes_per_chip(n_total: int, n_bands: int, cols_exchange: int, budget: Optional[int] = None,
                              n_camera: int = 1, cloud_cols: int = 60) -> dict:
    """Bytes each rank receives per training step, by link class.

    ``n_camera`` camera rows (across hosts) of ``n_bands`` bands (within a
    host).  Within a host: the forward exchange and its backward (the same
    volume back), so twice the forward.  Across hosts: a ring all-reduce of
    the shard's gradients (``n_total / n_bands`` rows of ``cloud_cols``
    float32), ``2 (r - 1) / r`` of the shard over ``r`` camera rows."""
    if n_bands <= 1:
        fwd = 0.0  # one band per camera row exchanges nothing
    else:
        vols = exchange_bytes_per_device(n_total, n_bands, cols_exchange, budget)
        fwd = vols["bounded"] if budget is not None else vols["allgather"]
    shard_bytes = (n_total // max(n_bands, 1)) * cloud_cols * 4
    r = max(n_camera, 1)
    inter = 2.0 * (r - 1) / r * shard_bytes if r > 1 else 0.0
    return {"intra": 2.0 * fwd, "inter": inter, "fwd_exchange": fwd, "cloud_shard_bytes": shard_bytes}


def modeled_efficiency_train(t_train_s: float, n_total: int, n_hosts: int, chips_per_host: int, links: Links,
                             cols_exchange: int = 14, budget: Optional[int] = None, cloud_cols: int = 60,
                             work_ratio: float = 1.0, overlap_inter: bool = False) -> float:
    """Training-step efficiency of ``n_hosts`` camera rows of
    ``chips_per_host`` bands: T_n = work_ratio * T_train / n + T_intra +
    T_inter, eff = T_train / (n * T_n).  ``overlap_inter`` models the
    all-reduce across hosts overlapped with compute, T_n = max(compute,
    T_inter) + T_intra (an upper bound)."""
    n = n_hosts * chips_per_host
    vols = train_comm_bytes_per_chip(n_total, chips_per_host, cols_exchange, budget, n_camera=n_hosts,
                                     cloud_cols=cloud_cols)
    t_intra = vols["intra"] / links.intra_bytes_per_s + 2 * links.launch_s if vols["intra"] else 0.0
    t_inter = vols["inter"] / links.inter_bytes_per_s + links.launch_s if vols["inter"] else 0.0
    compute = work_ratio * t_train_s / n
    t_n = max(compute, t_inter) + t_intra if overlap_inter else compute + t_intra + t_inter
    return t_train_s / (n * t_n)


def device_work_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` (kernels and copies of this process, from
    ``torch.profiler``) over ``reps`` runs after one warm run.  Raises if
    the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device rows named like a host op are annotations, not device work
    host_ops = {e.key for e in events if e.device_type == DeviceType.CPU}
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and e.key not in host_ops)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return busy_us / 1e3 / reps


def _wall_s(fn, iters: int) -> float:
    fn()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def measured_work_ratio(cloud, camera, settings, width: int, height: int, mesh, iters: int = 3,
                        exchange: str = "allgather", band_budget: Optional[int] = None,
                        pairs_hint: Optional[int] = None, single_pairs_hint: Optional[int] = None) -> dict:
    """Called on every rank of the 1D ``mesh`` with the whole ``cloud`` on
    the rank's device -> ``{1: t_1, n: t_n, "work_ratio": t_n / t_1,
    "unit": ...}``.  ``t_n``: the sharded frame's total work; ``t_1``: rank
    0's single-rank frame of the whole padded cloud (``render_tiled`` with
    the pair budget of ``single_pairs_hint``: both sides budget-fair).  On
    CUDA the unit is device ms (the sum over ranks of
    :func:`device_work_ms`), on the CPU host seconds (the frame's wall time,
    the ranks' total work only where they share one core)."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import pad_cloud
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import pairs_budget, render_tiled
    from bevy_gaussian_splatting_tpu_torch.parallel.render import (
        TILES_AXIS,
        make_sharded_render,
        shard_cloud,
        shard_multiple,
    )

    n = mesh.shape[TILES_AXIS]
    on_card = cloud.device.type == "cuda"
    shard = shard_cloud(cloud, mesh)
    fn = make_sharded_render(mesh, settings, width, height, exchange=exchange, band_budget=band_budget,
                             pairs_hint=pairs_hint)
    group = mesh.get_group(None)
    if on_card:
        t_n = torch.tensor([device_work_ms(lambda: fn(shard, camera), iters)], device=cloud.device)
        dist.all_reduce(t_n, group=group)
    else:  # the frame ends when its slowest rank's does
        t_n = torch.tensor([_wall_s(lambda: fn(shard, camera), iters)], dtype=torch.float64)
        dist.all_reduce(t_n, op=dist.ReduceOp.MAX, group=group)
    t_n = float(t_n.item())
    t_1 = torch.zeros(1, dtype=torch.float64, device=cloud.device)
    if dist.get_rank() == int(mesh.ranks.reshape(-1)[0]):
        padded = pad_cloud(cloud, shard_multiple(n))
        p_max = pairs_budget(len(padded), single_pairs_hint)

        def single():
            return render_tiled(padded, camera, settings, pairs_max=p_max, differentiable=False,
                                width=width, height=height)

        t_1[0] = device_work_ms(single, iters) if on_card else _wall_s(single, iters)
    dist.all_reduce(t_1, group=group)
    t_1 = float(t_1.item())
    return {1: t_1, n: t_n, "work_ratio": t_n / t_1, "unit": "device ms" if on_card else "host s"}


def _work_ratio_rank(n_gaussians: int, width: int, height: int, device: str) -> dict:
    """A rank of :func:`serialized_work_ratio`'s world (gloo) on ``device``."""
    import numpy as np

    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, random_arrays_3d_seeded
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import pair_count
    from bevy_gaussian_splatting_tpu_torch.parallel.render import make_mesh, plan_exchange

    a = random_arrays_3d_seeded(n_gaussians, seed=0)
    a["position_visibility"] = a["position_visibility"] * np.array([1.0, 1.0, 0.25, 1.0], np.float32)
    a["scale_opacity"] = a["scale_opacity"] * np.array([0.05, 0.05, 0.05, 1.0], np.float32)
    cloud = cloud_from_numpy(a, device)
    cam = Camera.create(eye=(0.0, 0.0, 60.0), target=(0.0, 0.0, 0.0), width=width, height=height, device=device)
    s = CloudSettings()
    mesh = make_mesh()
    mode, budget, pairs = plan_exchange(cloud, cam, s, width, height, mesh, with_pairs=True)
    sp = int(pair_count(cloud, cam, s))
    out = measured_work_ratio(cloud, cam, s, width, height, mesh, iters=2, exchange=mode, band_budget=budget,
                              pairs_hint=pairs, single_pairs_hint=sp)
    n = mesh.shape["tiles"]
    return {"t1": out[1], "tn": out[n], "unit": out["unit"], "work_ratio": out["work_ratio"], "exchange": mode,
            "band_pairs": pairs, "single_pairs": sp}


def _serialized_main(n_devices: int, n_gaussians: int, width: int, height: int, address: str, device: str) -> None:
    from bevy_gaussian_splatting_tpu_torch.parallel.distributed import World

    with World(n_devices, "gloo", address, device=device, timeout_s=900.0) as world:
        print(json.dumps(world.run(_work_ratio_rank, n_gaussians, width, height, device)[0]), flush=True)


def serialized_work_ratio(n_devices: int, n_gaussians: int, width: int = 128, height: int = 128,
                          timeout_s: float = 900.0, device: DeviceLike = None) -> dict:
    """The work ratio with the ranks' work serialized, on the bench-style
    scene of ``n_gaussians`` with the exchange and budgets planned as the
    production path plans them: a subprocess spawns a gloo world of
    ``n_devices`` ranks on ``device`` (default the card) that runs
    :func:`measured_work_ratio`.  On the card the ranks share it and the
    ratio is of device time; on the CPU the subprocess is pinned to one core
    (``taskset -c 0``, the ranks inherit the pin), so the n-rank frame's
    wall time is its total work.  Returns the subprocess's dict (t1, tn,
    unit, work_ratio, exchange, band_pairs, single_pairs)."""
    import tempfile

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        address = "file://" + os.path.join(tmp, "rendezvous")
        code = (
            "from bevy_gaussian_splatting_tpu_torch.parallel.scaling import _serialized_main\n"
            f"_serialized_main({n_devices}, {n_gaussians}, {width}, {height}, {address!r}, {str(dev)!r})\n"
        )
        cmd = [sys.executable, "-c", code]
        if dev.type == "cpu" and shutil.which("taskset"):
            cmd = ["taskset", "-c", "0"] + cmd
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"serialized work-ratio subprocess failed: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def serialized_work_ratio_median(n_devices: int, n_gaussians: int, width: int = 128, height: int = 128,
                                 runs: int = 4, timeout_s: float = 900.0, device: DeviceLike = None) -> dict:
    """The median of ``runs`` :func:`serialized_work_ratio` readings with
    their spread.  With ``runs`` >= 3 the first reading is discarded as a
    warm-up (cold caches, clock ramp).  The median is the upper middle
    reading (for an even count the higher of the two, always a measured
    value)."""
    results = [serialized_work_ratio(n_devices, n_gaussians, width, height, timeout_s=timeout_s, device=device)
               for _ in range(max(runs, 1))]
    if len(results) >= 3:
        results = results[1:]
    ratios = sorted(float(r["work_ratio"]) for r in results)
    med = ratios[len(ratios) // 2]
    out = next(dict(r) for r in results if float(r["work_ratio"]) == med)
    out["work_ratio_runs"] = ratios
    out["work_ratio_spread"] = (ratios[-1] - ratios[0]) / med if med else float("inf")
    return out
