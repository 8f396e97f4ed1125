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
