"""Process groups for multi-rank runs: initialization, the host-aware mesh,
a rank's rows of a replicated host array, spawned worlds and the
multi-host dry run.

The counterpart of the JAX package's ``parallel/distributed.py`` on
``torch.distributed``.  Everything is explicit: :func:`initialize` takes the
rendezvous address, the world size, this rank and the backend ("nccl" where
each rank has its own card, "gloo" on the CPU and where ranks share a
card); nothing picks or switches a backend, and nothing moves a tensor to
another device.  :func:`make_multihost_mesh` lays ranks out as hosts of
``ranks_per_host`` so that the tiles axis (the per-frame exchange, the hot
collective) stays within a host and the camera axis (one gradient
all-reduce per step) spans hosts.

:class:`World` spawns ranks as processes that initialize and then run the
functions it sends them; the tests and ``chip_smoke.py`` use it.  The dry
run, ``python -m bevy_gaussian_splatting_tpu_torch.parallel.distributed``,
runs 4 ranks as 2 hosts x 2 and one camera-parallel and pixel-parallel
training step.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import socket
import sys
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device

CAMERA_AXIS = "camera"
TILES_AXIS = "tiles"
BACKENDS = ("nccl", "gloo")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _check_devices(store, world_size: int, rank: int, device: torch.device) -> None:
    """NCCL runs one rank per card: raise on every rank where two ranks name
    the same card (host and device UUID), through the rendezvous store."""
    ident = f"{socket.gethostname()}/{torch.cuda.get_device_properties(device).uuid}"
    store.set(f"bgs_card/{rank}", ident)
    seen = [store.get(f"bgs_card/{r}").decode() for r in range(world_size)]
    if len(set(seen)) != world_size:
        raise ValueError(
            f"backend 'nccl' needs one card per rank, but ranks share cards ({seen}); "
            "use backend='gloo' where ranks share a card"
        )


def initialize(
    address: str,
    world_size: int,
    rank: int,
    backend: str,
    device: DeviceLike = None,
    timeout_s: float = 300.0,
) -> None:
    """Join the process group, once (a second call returns).

    ``address`` is the rendezvous URL (``tcp://host:port`` or
    ``file:///path``), ``world_size`` and ``rank`` this world's, ``backend``
    "nccl" or "gloo".  With "nccl", ``device`` is this rank's card (default
    the current CUDA device), made current; ranks that share a card raise.
    A collective that waits past ``timeout_s`` raises."""
    if is_initialized():
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        card = resolve_device(device)
        if card.type != "cuda":
            raise ValueError(f"backend 'nccl' needs a CUDA device, got {card}")
        torch.cuda.set_device(card)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(address, rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    if backend == "nccl":
        _check_devices(store, world_size, rank, card)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, timeout=timeout)


def make_multihost_mesh(camera_parallel: Optional[int] = None, *, ranks_per_host: int):
    """2D (camera, tiles) mesh over the world, ranks grouped into hosts of
    ``ranks_per_host`` consecutive ranks, laid out so the tiles axis stays
    within a host wherever the sizes allow.

    ``camera_parallel`` defaults to the host count.  ``camera_parallel ==
    hosts * k``: each host gives k camera rows of ``ranks_per_host / k``
    ranks.  ``camera_parallel`` dividing the host count: each camera row
    spans ``hosts / camera_parallel`` whole hosts, so the exchange crosses
    hosts (allowed, slow: a warning is printed)."""
    from bevy_gaussian_splatting_tpu_torch.parallel.render import mesh_from_grid

    world = dist.get_world_size()
    per = int(ranks_per_host)
    if per <= 0 or world % per:
        raise ValueError("uneven rank count per host")
    p = world // per
    grid = np.arange(world).reshape(p, per)
    cp = camera_parallel if camera_parallel is not None else p
    if cp == 0 or world % cp:
        raise ValueError(f"camera_parallel {cp} must divide {world} ranks")
    if cp % p == 0:
        k = cp // p
        if per % k:
            raise ValueError(
                f"camera_parallel {cp} needs {k} camera rows per host; "
                f"{per} ranks per host are not divisible by {k}"
            )
        arr = grid.reshape(p * k, per // k)
    elif p % cp == 0:
        print(
            "make_multihost_mesh: tiles axis spans hosts: the per-frame splat exchange will cross hosts",
            file=sys.stderr,
        )
        arr = grid.reshape(cp, (p // cp) * per)
    else:
        raise ValueError(f"camera_parallel {cp} incompatible with {p} hosts x {per} ranks")
    return mesh_from_grid(arr, (CAMERA_AXIS, TILES_AXIS))


def global_cloud(cloud, mesh, device: DeviceLike = None):
    """This rank's shard of a cloud every rank holds alike (host or any
    device): the rows of its tiles index after padding (``render.shard_cloud``),
    replicated over the camera axis, on ``device`` (default the card)."""
    from bevy_gaussian_splatting_tpu_torch.parallel.render import shard_cloud

    return shard_cloud(cloud, mesh).to(resolve_device(device))


def global_array(arr, mesh, axes: tuple, device: DeviceLike = None) -> torch.Tensor:
    """This rank's block of an array every rank holds alike: dimension i is
    split over mesh axis ``axes[i]`` (None: kept whole), as a
    ``PartitionSpec``; on ``device`` (default the card)."""
    host = torch.as_tensor(np.asarray(arr))
    index = []
    for dim, name in enumerate(axes):
        if name is None:
            index.append(slice(None))
            continue
        parts = mesh.shape[name]
        size = host.shape[dim] // parts
        at = mesh.get_local_rank(name)
        index.append(slice(at * size, (at + 1) * size))
    return host[tuple(index)].to(resolve_device(device))


# ---------------------------------------------------------------------------
# Spawned worlds
# ---------------------------------------------------------------------------


def _rank_loop(rank: int, world_size: int, address: str, backend: str, device, conn, threads: int, timeout_s):
    """A spawned rank: initialize, then run each function the parent sends
    until it sends None; every result or traceback goes back."""
    torch.set_num_threads(threads)
    try:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        initialize(address, world_size, rank, backend, device, timeout_s)
        conn.send(("ok", None))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        fn, args, kwargs = msg
        try:
            conn.send(("ok", fn(*args, **kwargs)))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
    dist.destroy_process_group()


class World:
    """``n_ranks`` spawned processes in one process group: each initializes
    with ``backend`` at ``address`` (every rank's CUDA device ``device``
    where given), keeps ``threads`` PyTorch threads, then runs what
    :meth:`run` sends.  A rank's exception raises here with its traceback;
    a rank that answers nothing within ``timeout_s`` raises here too.  Either
    ends the world (every rank is stopped); close it with :meth:`close` or
    as a context manager."""

    def __init__(self, n_ranks: int, backend: str, address: str, device: DeviceLike = None,
                 threads: int = 1, timeout_s: float = 120.0):
        ctx = multiprocessing.get_context("spawn")
        self.n_ranks, self.timeout_s = n_ranks, timeout_s
        self._conns, self._procs = [], []
        dev = None if device is None else str(device)
        for rank in range(n_ranks):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_rank_loop, args=(rank, n_ranks, address, backend, dev, child, threads,
                                                        timeout_s), daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self._collect()

    def _collect(self) -> list:
        results = [None] * self.n_ranks
        pending = dict(enumerate(self._conns))
        while pending:
            ready = multiprocessing.connection.wait(
                list(pending.values()) + [self._procs[r].sentinel for r in pending], timeout=self.timeout_s
            )
            if not ready:
                self.close()
                raise TimeoutError(f"ranks {sorted(pending)} gave no answer within {self.timeout_s} s")
            for rank, conn in list(pending.items()):
                if conn in ready or self._procs[rank].sentinel in ready:
                    try:
                        status, value = conn.recv()
                    except EOFError:
                        self.close()
                        raise RuntimeError(f"rank {rank} died (exit code {self._procs[rank].exitcode})") from None
                    if status != "ok":
                        self.close()
                        raise RuntimeError(f"rank {rank} failed:\n{value}")
                    results[rank] = value
                    del pending[rank]
        return results

    def submit(self, fn, *args, **kwargs) -> None:
        """Send ``fn(*args, **kwargs)`` to every rank (``fn`` a module-level
        function); :meth:`results` waits for the answers."""
        if not self._procs:
            raise RuntimeError("the world is closed")
        for conn in self._conns:
            conn.send((fn, args, kwargs))

    def results(self) -> list:
        """Every rank's return value of the last :meth:`submit`, in rank order."""
        return self._collect()

    def run(self, fn, *args, **kwargs) -> list:
        self.submit(fn, *args, **kwargs)
        return self.results()

    @property
    def closed(self) -> bool:
        return not self._procs

    def close(self) -> None:
        procs, self._procs = self._procs, []
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in procs:
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        for conn in self._conns:
            conn.close()
        self._conns = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Multi-host dry run
# ---------------------------------------------------------------------------


def run_multihost_dryrun(address: str, world_size: int, rank: int, ranks_per_host: int = 2,
                         exchange: str = "allgather", backend: str = "gloo", device: DeviceLike = None) -> str:
    """One rank of the dry run: initialize, build the host-aware mesh, run
    one camera-parallel and pixel-parallel training step on this rank's
    blocks of the cloud, cameras and targets -> a status line.

    ``device`` is this rank's device (default the card; ``"cpu"`` runs the
    plain versions); ``backend`` "gloo" where ranks share a card or run on
    the CPU, "nccl" where each rank has its own card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize(address, world_size, rank, backend, dev)
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.models.cloud import random_gaussians_3d_seeded
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.parallel.render import make_train_step_multicam

    mesh = make_multihost_mesh(ranks_per_host=ranks_per_host)  # (camera = hosts, tiles = ranks per host)
    n_cam, tiles = mesh.shape[CAMERA_AXIS], mesh.shape[TILES_AXIS]
    width, height = 64, max(16 * tiles, 64)
    if height % (16 * tiles):
        height = 16 * tiles
    cloud = global_cloud(random_gaussians_3d_seeded(512, seed=0, device="cpu"), mesh, dev)
    cams = [Camera.create(eye=(10.0 * c, 5.0, 50.0), target=(0.0, 0.0, 0.0), width=width, height=height, device=dev)
            for c in range(n_cam)]
    targets = torch.zeros((n_cam, height, width, 4), dtype=torch.float32, device=dev)
    step, init = make_train_step_multicam(mesh, CloudSettings(), width, height, exchange=exchange)
    loss = float(step(init(cloud), cams, targets))
    if not (np.isfinite(loss) and loss >= 0.0):
        raise AssertionError(f"dry run loss {loss}")
    hosts = world_size // ranks_per_host
    return (
        f"multihost dryrun OK: {hosts} hosts x {ranks_per_host} ranks, mesh={mesh.shape}, "
        f"backend={backend}, device={dev.type}, exchange={exchange}, loss={loss:.6f}"
    )


def _free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def spawn_multihost_dryrun(world_size: int = 4, ranks_per_host: int = 2, timeout: float = 300.0,
                           exchange: str = "allgather", address: Optional[str] = None,
                           device: DeviceLike = None) -> str:
    """Run the dry run in ``world_size`` local processes, one per rank,
    meeting at ``address`` (default a free local TCP port) with gloo ->
    rank 0's status line.  Every rank runs on ``device`` (default the card,
    which the ranks share; ``"cpu"`` for the plain versions)."""
    import subprocess

    if resolve_device(device).type == "cuda":  # no card: raise here, not in every rank
        from bevy_gaussian_splatting_tpu_torch.ops.cuda.build import build_all

        build_all()  # once, before the ranks load the libraries
    address = address or _free_address()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo_root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "bevy_gaussian_splatting_tpu_torch.parallel.distributed",
             "--address", address, "--world-size", str(world_size), "--rank", str(rank),
             "--ranks-per-host", str(ranks_per_host), "--exchange", exchange]
            + ([] if device is None else ["--device", str(device)]),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world_size)
    ]
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            outs.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"multihost dryrun rank failed (rc={proc.returncode}):\n" + out[-3000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for out in outs:
        for line in out.splitlines():
            if line.startswith("multihost dryrun OK"):
                return line
    raise RuntimeError("no status line from rank 0:\n" + "\n".join(outs)[-3000:])


def _main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one rank of the multi-host dry run (gloo)")
    ap.add_argument("--address", required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--ranks-per-host", type=int, default=2)
    ap.add_argument("--exchange", default="allgather")
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args()
    torch.set_num_threads(1)
    msg = run_multihost_dryrun(args.address, args.world_size, args.rank, args.ranks_per_host, args.exchange,
                               device=args.device)
    if args.rank == 0:
        print(msg, flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
