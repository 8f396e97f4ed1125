"""Rank-side cases of the sharded path's CPU tests (tests/test_torch_parallel.py,
tests/test_torch_exchange.py).

A gloo world of spawned ranks (``parallel/distributed.py`` ``World``) runs
these functions, so they live in a module that imports neither JAX nor the
JAX package: each rank pays ``import torch`` and nothing more.  Every
function runs on every rank; inputs are numpy arrays made from a seed by
the test, results come back as numpy arrays (rank 0's, or every rank's).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
from bevy_gaussian_splatting_tpu_torch.parallel import render as pr
from bevy_gaussian_splatting_tpu_torch.parallel.exchange import band_exchange


def camera(eye, width: int, height: int) -> Camera:
    return Camera.create(eye=eye, target=(0.0, 0.0, 0.0), width=width, height=height, device="cpu")


def _mesh(n_devices=None, camera_parallel: int = 1):
    return pr.make_mesh(n_devices, camera_parallel)


def render(arrays, settings, eye, width, height, exchange="allgather", band_budget=None, pairs_hint=None,
           time=0.0, repeat: int = 1):
    """The sharded frame, ``repeat`` times -> rank 0's frames [repeat, H, W, 4]."""
    mesh = _mesh()
    shard = pr.shard_cloud(cloud_from_numpy(arrays, "cpu"), mesh)
    fn = pr.make_sharded_render(mesh, settings, width, height, exchange=exchange, band_budget=band_budget,
                                pairs_hint=pairs_hint)
    frames = [fn(shard, camera(eye, width, height), time=time).numpy() for _ in range(repeat)]
    return np.stack(frames) if dist.get_rank() == 0 else None


def train(arrays, settings, eye, width, height, target, steps: int = 1, lr: float = 1e-3, exchange="allgather",
          band_budget=None, skip_nonfinite: int = 0, loss: str = "l2"):
    """``steps`` sharded train steps -> this rank's (losses, gradients of
    the first step by field, the shard after the last step by field)."""
    mesh = _mesh()
    step, init = pr.make_train_step(mesh, settings, width, height, learning_rate=lr, loss=loss,
                                    skip_nonfinite=skip_nonfinite, exchange=exchange, band_budget=band_budget)
    state = init(pr.shard_cloud(cloud_from_numpy(arrays, "cpu"), mesh))
    target = torch.from_numpy(np.asarray(target))
    losses, grads = [], None
    for _ in range(steps):
        losses.append(float(step(state, camera(eye, width, height), target)))
        if grads is None:
            grads = {k: (v.numpy().copy() if v is not None else None)
                     for k, v in ((n, getattr(state.model, n).grad) for n in state.model.fields)}
    after = {n: getattr(state.model, n).detach().numpy().copy() for n in state.model.fields}
    return losses, grads, after, (state.notfinite_count, state.total_notfinite, state.last_finite)


def multicam(arrays, settings, eyes, width, height, targets=None, lr: float = 1e-3):
    """On a (camera 2, tiles 2) mesh: rank 0's frames [C, H, W, 4], or
    with ``targets`` one training step -> this rank's (loss, shard after the
    step by field, the step's gradients by field)."""
    mesh = _mesh(camera_parallel=2)
    shard = pr.shard_cloud(cloud_from_numpy(arrays, "cpu"), mesh)
    cams = [camera(e, width, height) for e in eyes]
    if targets is None:
        imgs = pr.make_sharded_render_multicam(mesh, settings, width, height)(shard, cams)
        return imgs.numpy() if dist.get_rank() == 0 else None
    step, init = pr.make_train_step_multicam(mesh, settings, width, height, learning_rate=lr)
    state = init(shard)
    loss = float(step(state, cams, torch.from_numpy(np.asarray(targets))))
    after = {n: getattr(state.model, n).detach().numpy().copy() for n in state.model.fields}
    grads = {n: getattr(state.model, n).grad.numpy().copy() for n in state.model.fields}
    return loss, after, grads


def exchange(payloads, b0s, b1s, acts, n_bands: int, budget: int, weights=None):
    """``band_exchange`` of this rank's inputs -> its received rows, and
    with ``weights`` [ranks, rows, C] the gradient of sum(received *
    weights[rank]) in its payload."""
    r = dist.get_rank()
    payload = torch.from_numpy(np.asarray(payloads[r])).requires_grad_(weights is not None)
    received = band_exchange(payload, torch.from_numpy(np.asarray(b0s[r], np.int64)),
                             torch.from_numpy(np.asarray(b1s[r], np.int64)), torch.from_numpy(np.asarray(acts[r])),
                             n_bands, budget)
    if weights is None:
        return received.numpy()
    torch.sum(received * torch.from_numpy(np.asarray(weights[r]))).backward()
    return received.detach().numpy(), payload.grad.numpy()


def mesh_shapes():
    """This rank's view of the 1D and the (2, 2) mesh."""
    one, two = _mesh(), _mesh(camera_parallel=2)
    return one.shape, two.shape, two.get_local_rank(pr.CAMERA_AXIS), two.get_local_rank(pr.TILES_AXIS)


def multihost_meshes():
    """Shapes of ``make_multihost_mesh`` over 2 hosts x 2 ranks at camera
    axes 2 (the default), 4 and 1, the error at 3, this rank's place in the
    default mesh and its ``global_array`` block of a [4, 4] array split
    (camera, tiles)."""
    from bevy_gaussian_splatting_tpu_torch.parallel.distributed import global_array, make_multihost_mesh

    meshes = [make_multihost_mesh(cp, ranks_per_host=2) for cp in (None, 4, 1)]
    try:
        make_multihost_mesh(3, ranks_per_host=2)
        err = None
    except ValueError:
        err = "ValueError"
    m = meshes[0]
    block = global_array(np.arange(16).reshape(4, 4), m, (pr.CAMERA_AXIS, pr.TILES_AXIS), device="cpu").numpy()
    return [mm.shape for mm in meshes] + [err, (m.get_local_rank(pr.CAMERA_AXIS), m.get_local_rank(pr.TILES_AXIS)),
                                          block]


def work_ratio(arrays, width, height):
    """``scaling.measured_work_ratio`` of the OBB frame on this world."""
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.parallel.scaling import measured_work_ratio

    return measured_work_ratio(cloud_from_numpy(arrays, "cpu"), camera((0.0, 0.0, 60.0), width, height),
                               CloudSettings(), width, height, _mesh(), iters=1)
