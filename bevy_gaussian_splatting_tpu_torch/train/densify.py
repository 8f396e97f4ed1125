"""Adaptive density control: clone, split and prune for 3DGS training.

The counterpart of the JAX package's ``train/densify.py`` (the standard 3DGS
densification, Kerbl et al. section 5.2, in a fixed-capacity buffer): dead
rows carry opacity 0 and visibility 0, each densify step writes at most K
children into dead slots, and pruning zeroes opacity and visibility instead
of compacting.  The same fixed capacity keeps the port's cloud, its Adam
state and its tests shaped like the reference's.

What differs, and why:
  - the PRNG key becomes a ``torch.Generator`` in :class:`DensifyState`; the
    split noise is drawn by :func:`_split_noise` alone, so a test can hand
    both packages the same draw;
  - ``jax.lax.top_k`` returns the lower index first among equal values and
    orders floats totally (+0 above -0); :func:`_top_k` reproduces both with
    a stable sort of the values' total-order integer keys.  Dead slots all
    tie at opacity 0, so the tie order decides which slots get children;
  - norms are taken as XLA evaluates ``jnp.linalg.norm`` (sequential fused
    multiply-adds, :func:`_norm`), so both packages pick the same splats.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud
from bevy_gaussian_splatting_tpu_torch.utils import trace


class DensifyState(NamedTuple):
    grad_accum: torch.Tensor  # [N] f32 accumulated ||d position||
    count: torch.Tensor  # [N] int32 observations since the last densify
    generator: torch.Generator  # split sampling


def init_densify_state(capacity: int, seed: int = 0, device: DeviceLike = None) -> DensifyState:
    """Zeroed accumulators for a cloud of ``capacity`` rows, on the card
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return DensifyState(
        grad_accum=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        count=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        generator=generator,
    )


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of a float32 [..., C] tensor, as
    XLA evaluates ``jnp.linalg.norm``: sqrt(fma(v[C-1], v[C-1], ... fma(v[1],
    v[1], v[0] * v[0]))).  Each float64 product of two float32 values is
    exact, so one rounding to float32 per step is the fused result."""
    w = v.double()
    acc = (w[..., 0] * w[..., 0]).float()
    for i in range(1, v.shape[-1]):
        acc = (w[..., i] * w[..., i] + acc.double()).float()
    return torch.sqrt(acc)


@trace.spanned("gs.densify")
def accumulate_stats(state: DensifyState, grads) -> DensifyState:
    """Fold one step's positional gradients into the accumulators.

    ``grads`` is the cloud-shaped gradient of the training step
    (``TrainableCloud.grads()`` after ``train_step``); the densification
    signal is the norm of d(position).  A call is the span ``gs.densify``
    (``utils/trace.py``)."""
    gnorm = _norm(grads.position_visibility[:, :3])
    return state._replace(
        grad_accum=state.grad_accum + gnorm,
        count=state.count + (gnorm > 0.0).to(torch.int32),
    )


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` for a float32 [N]: the k largest in descending total
    order (+0 above -0), lower index first among equals -> (values, indices)."""
    bits = x.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, descending=True, stable=True).indices[:k]
    return x[idx], idx


def _split_noise(generator: torch.Generator, k: int, device: torch.device) -> torch.Tensor:
    """Standard normal draws [k, 3] for the split children's offsets."""
    return torch.randn((k, 3), generator=generator, device=device)


def _quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [K, 3] by unit quaternions q [K, 4] (w, x, y, z)."""
    w, u = q[:, 0:1], q[:, 1:4]
    t = 2.0 * torch.linalg.cross(u, v)
    return v + w * t + torch.linalg.cross(u, t)


@trace.spanned("gs.densify")
@torch.no_grad()
def densify_and_prune(
    cloud: Gaussian3dCloud,
    state: DensifyState,
    k_budget: int = 1024,
    grad_threshold: float = 2e-4,
    percent_dense: float = 0.01,
    scene_extent: float = 1.0,
    prune_opacity: float = 0.005,
    split_scale_shrink: float = 1.6,
):
    """One adaptive-density step -> (new_cloud, new_state, stats dict).

    The top ``k_budget`` live gaussians by mean positional gradient above
    ``grad_threshold`` are densified into dead slots (lowest opacity first;
    writes past the dead slots are dropped): splats whose largest scale is at
    most ``percent_dense * scene_extent`` are cloned, larger ones split (the
    child drawn from the splat's own distribution, both scales divided by
    ``split_scale_shrink``).  Live gaussians with opacity below
    ``prune_opacity`` are pruned (opacity and visibility zeroed).  Stats are
    int64 scalar tensors: added, split, cloned, pruned, live.  A call is the
    span ``gs.densify`` and adds its added and pruned gaussians to the
    counters ``densify.added`` and ``densify.pruned`` (``utils/trace.py``
    ``count_later``: read only with the counters)."""
    n = len(cloud)
    k = min(k_budget, n)
    pv, sh, rot, so = cloud.position_visibility, cloud.spherical_harmonic, cloud.rotation, cloud.scale_opacity
    live = so[:, 3] > 0.0

    mean_grad = state.grad_accum / torch.clamp(state.count.to(torch.float32), min=1.0)
    score = torch.where(live & (state.count > 0), mean_grad, -1.0)
    top_score, src = _top_k(score, k)
    eligible = top_score > grad_threshold  # [K]

    _, dst = _top_k(-so[:, 3], k)
    write = eligible & (so[dst, 3] <= 0.0)

    src_pv, src_sh, src_rot, src_so = pv[src], sh[src], rot[src], so[src]
    do_split = src_so[:, :3].amax(dim=-1) > percent_dense * scene_extent  # else clone

    # split sample: x ~ N(mean, Sigma) by rotating a scale-weighted normal
    eps = _split_noise(state.generator, k, pv.device) * src_so[:, :3]
    offset = _quat_rotate(src_rot / torch.clamp(_norm(src_rot)[:, None], min=1e-12), eps)
    child_pos = torch.where(do_split[:, None], src_pv[:, :3] + offset, src_pv[:, :3])
    child_scale = torch.where(do_split[:, None], src_so[:, :3] / split_scale_shrink, src_so[:, :3])
    child_pv = torch.cat([child_pos, src_pv[:, 3:4]], dim=-1)
    child_so = torch.cat([child_scale, src_so[:, 3:4]], dim=-1)

    def put(arr, rows):
        """Masked scatter of children into the dead slots ``dst``."""
        out = arr.clone()
        out[dst] = torch.where(write[:, None], rows, arr[dst])
        return out

    new_pv = put(pv, child_pv)
    new_sh = put(sh, src_sh)
    new_rot = put(rot, src_rot)
    new_so = put(so, child_so)

    # split parents shrink in place, reading the scales after the children's
    # write (src and dst overlap when fewer than K candidates are eligible)
    new_so[src, :3] = torch.where(
        (write & do_split)[:, None], src_so[:, :3] / split_scale_shrink, new_so[src, :3]
    )

    prune = live & (new_so[:, 3] < prune_opacity)
    keep_xyz = torch.tensor([1.0, 1.0, 1.0, 0.0], device=pv.device)
    new_so = torch.where(prune[:, None], new_so * keep_xyz, new_so)
    new_pv = torch.where(prune[:, None], new_pv * keep_xyz, new_pv)

    new_cloud = Gaussian3dCloud(
        position_visibility=new_pv, spherical_harmonic=new_sh, rotation=new_rot, scale_opacity=new_so
    )
    new_state = DensifyState(
        grad_accum=torch.zeros_like(state.grad_accum),
        count=torch.zeros_like(state.count),
        generator=state.generator,
    )
    stats = {
        "added": write.sum(),
        "split": (write & do_split).sum(),
        "cloned": (write & ~do_split).sum(),
        "pruned": prune.sum(),
        "live": (new_so[:, 3] > 0.0).sum(),
    }
    trace.count_later("densify.added", stats["added"])
    trace.count_later("densify.pruned", stats["pruned"])
    return new_cloud, new_state, stats
