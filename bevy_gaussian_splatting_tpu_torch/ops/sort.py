"""Depth keys: a bit-exact transcription of the GPU radix sort's key
generation (src/sort/radix.wgsl:86-103):

    dist2 = |transformed_position - camera_position|^2
    key   = in_frustum ? (0xFFFFFFFF - f32_bits(dist2)) : 0xFFFFFFFF
    key >>= (32 - depth_bits)

Ascending key order is far-to-near (back-to-front painter order); the
sentinel 0xFFFFFFFF marks culled entries.  Torch's uint32 coverage is thin,
so the unsigned 32-bit keys are carried in int64 tensors, masked to 32 bits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.ops.transforms import (
    apply_transform,
    in_frustum,
    world_to_clip,
)

SENTINEL_KEY = 0xFFFFFFFF
_U32 = 0xFFFFFFFF


def radix_depth_key(
    position: torch.Tensor,  # [N, 3] cloud-local positions
    model_transform: torch.Tensor,  # [4, 4]
    clip_from_world: torch.Tensor,  # [4, 4]
    camera_position: torch.Tensor,  # [3]
    depth_bits: int = 32,
) -> torch.Tensor:
    """u32 depth keys [N] (as int64) exactly as radix_sort_a computes them."""
    world = apply_transform(model_transform, position)
    clip = world_to_clip(world, clip_from_world)
    visible = in_frustum(clip[..., :3])
    return depth_key(squared_distance(world - camera_position), visible, depth_bits)


def squared_distance(diff: torch.Tensor) -> torch.Tensor:
    """|diff|^2 over the last axis [..., 3], summed in a fixed order with one
    rounding per op on every device (a reduction kernel may associate
    differently and move a depth key by an ulp)."""
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]


def depth_key(dist2: torch.Tensor, visible: torch.Tensor, depth_bits: int = 32) -> torch.Tensor:
    """u32 keys (as int64) from squared camera distances and frustum flags."""
    dist_bits = dist2.contiguous().view(torch.int32).to(torch.int64) & _U32
    key_distance = _U32 - dist_bits
    key = torch.where(visible, key_distance, torch.full_like(key_distance, SENTINEL_KEY))
    return key >> (32 - depth_bits)


def sort_entries(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort -> (sorted_keys, sorted_indices): the
    ``SortedEntries`` {key, index} pairs (src/sort/mod.rs:324-339)."""
    return torch.sort(keys, stable=True)


def sort_gaussians_radix(
    position: torch.Tensor,
    model_transform: torch.Tensor,
    clip_from_world: torch.Tensor,
    camera_position: torch.Tensor,
    depth_bits: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The full device sort, key generation then a stable sort -> (sorted
    keys, sorted indices): back to front, culled (sentinel) entries last."""
    return sort_entries(radix_depth_key(position, model_transform, clip_from_world, camera_position, depth_bits))


def sort_gaussians_host(
    position: np.ndarray,
    model_transform: np.ndarray,
    camera_position: np.ndarray,
) -> np.ndarray:
    """Host sort of SortMode.STD / SortMode.RAYON (src/sort/std_sort.rs:27-130;
    the JAX package's ``ops/sort.py`` ``sort_gaussians_host``): squared
    distance to the camera, descending (back to front), stable, in numpy.
    The host paths cull nothing."""
    mt = np.asarray(model_transform)
    world = position @ mt[:3, :3].T + mt[:3, 3]
    diff = world - np.asarray(camera_position)
    dist2 = np.sum(diff * diff, axis=-1)
    return np.argsort(-dist2, kind="stable").astype(np.uint32)


# -- radix digit bookkeeping (the reference's tests/radix.rs parity) ----------


def digit_places(depth_bits: int) -> int:
    """Radix passes for a key width (ShaderDefines::for_radix_depth_bits,
    src/render/mod.rs:715-722)."""
    return depth_bits // 8


def key_shift(depth_bits: int) -> int:
    """Right shift that keeps a key's top ``depth_bits`` bits."""
    return 32 - depth_bits


def digit_of(key, place: int, bits_per_digit: int = 8):
    """Digit ``place`` of u32 keys, as radix_sort_a extracts it
    (src/sort/radix.wgsl:100-102); numpy uint32 in and out."""
    base = (1 << bits_per_digit) - 1
    return (key >> np.uint32(place * bits_per_digit)) & np.uint32(base)


def final_pass_parity(depth_bits: int) -> int:
    """Which ping-pong buffer the last radix pass writes (tests/radix.rs:65-79):
    the initial parity is ``digit_places % 2``, so that the last pass lands
    in ``sorted_entries``."""
    return digit_places(depth_bits) % 2


# -- host re-sort scheduling (the reference's SortConfig / SortTrigger) -------


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sort_due(moved: bool, now_ms: float, last_sort_ms: float, period_ms: float) -> bool:
    """The reference's throttle (src/sort/mod.rs:76-86, 153-194): sort again
    when the camera moved and at least ``period_ms`` passed since the last
    sort."""
    return moved and (now_ms - last_sort_ms) >= period_ms


def throttle_period_ms(floor_ms: float, sort_ms: float) -> float:
    """The throttle's period after a sort that took ``sort_ms``:
    ``max(floor, 4 x the sort's duration)`` (std_sort.rs:121-129)."""
    return max(floor_ms, 4.0 * sort_ms)


class SortSchedule:
    """The reference's host-sort throttle for SortMode.STD / SortMode.RAYON
    (:func:`sort_due`, :func:`throttle_period_ms` with a floor of 1000 ms)."""

    def __init__(self, period_ms: float = 1000.0):
        self.period_ms = period_ms
        self.last_sort_ms: float = -1e30
        self.last_camera_position = None
        self.order = None

    def needs_sort(self, camera_position, now_ms: float) -> bool:
        if self.order is None or self.last_camera_position is None:
            return True
        moved = not np.allclose(_host(camera_position), self.last_camera_position, atol=1e-6)
        return sort_due(moved, now_ms, self.last_sort_ms, self.period_ms)

    def maybe_sort(self, position, model_transform, camera_position, now_ms=None) -> np.ndarray:
        """The back-to-front order [N] uint32, sorted again only when due."""
        if now_ms is None:
            now_ms = time.perf_counter() * 1e3
        if self.needs_sort(camera_position, now_ms):
            t0 = time.perf_counter()
            self.order = sort_gaussians_host(_host(position), _host(model_transform), _host(camera_position))
            self.period_ms = throttle_period_ms(1000.0, (time.perf_counter() - t0) * 1e3)
            self.last_sort_ms = now_ms
            self.last_camera_position = _host(camera_position).copy()
        return self.order


def back_sorted_entry_indices(back_key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cloud indices of the back-to-front sorted entries ``min(1, n-1)`` and
    ``n-1``, which the reference's depth min/max quirk reads
    (gaussian.wgsl:329-347), by reductions instead of a sort (the JAX
    package's ``rasterize_tile.py`` ``back_sorted_entry_indices``).  Back
    order is key ascending, index ascending, sentinels included."""
    n = back_key.shape[0]
    idx = torch.arange(n, device=back_key.device)
    last = torch.where(back_key == back_key.max(), idx, -1).max()
    if n == 1:
        return torch.zeros_like(last), last
    kmin = back_key.min()
    i0 = torch.where(back_key == kmin, idx, n).min()
    is_first = (back_key == kmin) & (idx == i0)
    key2 = torch.where(is_first, torch.full_like(back_key, SENTINEL_KEY), back_key)
    first = torch.where((key2 == key2.min()) & ~is_first, idx, n).min()
    return first, last
