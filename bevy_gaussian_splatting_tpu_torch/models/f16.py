"""Half-precision storage: the reference's u32 packing and f16 clouds.

The pack and unpack functions reproduce the reference's bit layout
(src/gaussian/f16.rs:30-263: two f16 per u32 word, ``upper << 16 |
lower``) in numpy, bit for bit the JAX package's ``models/f16.py``.  A
cloud stored in float16 (or bfloat16) holds each value rounded once to
nearest; projection casts it back to float32, so the kernels see float32
rows only.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_f32s_to_u32(upper, lower) -> np.ndarray:
    """f16.rs:244-251: u32 = f16(upper).bits << 16 | f16(lower).bits."""
    ub = np.asarray(upper, np.float32).astype(np.float16).view(np.uint16).astype(np.uint32)
    lb = np.asarray(lower, np.float32).astype(np.float16).view(np.uint16).astype(np.uint32)
    return (ub << 16) | lb


def unpack_u32_to_f32s(value) -> tuple[np.ndarray, np.ndarray]:
    """f16.rs:254-263."""
    v = np.asarray(value, np.uint32)
    upper = (v >> 16).astype(np.uint16).view(np.float16).astype(np.float32)
    lower = (v & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    return upper, lower


def pack_rotation_scale_opacity(rotation: np.ndarray, scale: np.ndarray, opacity: np.ndarray) -> np.ndarray:
    """[N, 4] quat + [N, 3] scale + [N] opacity -> [N, 4] u32
    (RotationScaleOpacityPacked128, f16.rs:30-120: (r0, r1), (r2, r3),
    (s0, s1), (s2, opacity))."""
    return np.stack(
        [
            pack_f32s_to_u32(rotation[:, 0], rotation[:, 1]),
            pack_f32s_to_u32(rotation[:, 2], rotation[:, 3]),
            pack_f32s_to_u32(scale[:, 0], scale[:, 1]),
            pack_f32s_to_u32(scale[:, 2], opacity),
        ],
        axis=1,
    )


def unpack_rotation_scale_opacity(packed: np.ndarray):
    r01 = unpack_u32_to_f32s(packed[:, 0])
    r23 = unpack_u32_to_f32s(packed[:, 1])
    s01 = unpack_u32_to_f32s(packed[:, 2])
    s2o = unpack_u32_to_f32s(packed[:, 3])
    rotation = np.stack([r01[0], r01[1], r23[0], r23[1]], axis=1)
    scale = np.stack([s01[0], s01[1], s2o[0]], axis=1)
    return rotation, scale, s2o[1]


def pack_covariance_3d_opacity(cov3d: np.ndarray, opacity: np.ndarray) -> np.ndarray:
    """[N, 6] upper-triangular covariance + [N] opacity -> [N, 4] u32
    (Covariance3dOpacityPacked128, f16.rs:122-152: (c0, c1), (c2, c3),
    (c4, c5), (opacity, opacity))."""
    return np.stack(
        [
            pack_f32s_to_u32(cov3d[:, 0], cov3d[:, 1]),
            pack_f32s_to_u32(cov3d[:, 2], cov3d[:, 3]),
            pack_f32s_to_u32(cov3d[:, 4], cov3d[:, 5]),
            pack_f32s_to_u32(opacity, opacity),
        ],
        axis=1,
    )


def unpack_covariance_3d_opacity(packed: np.ndarray):
    """Inverse of :func:`pack_covariance_3d_opacity` (f16.rs:154-169: the
    opacity reads the upper half)."""
    c01 = unpack_u32_to_f32s(packed[:, 0])
    c23 = unpack_u32_to_f32s(packed[:, 1])
    c45 = unpack_u32_to_f32s(packed[:, 2])
    opacity, _ = unpack_u32_to_f32s(packed[:, 3])
    cov3d = np.stack([c01[0], c01[1], c23[0], c23[1], c45[0], c45[1]], axis=1)
    return cov3d, opacity


def to_f16_storage(cloud):
    """The cloud with float16 storage (half the memory; projection casts
    back to float32).  ``cloud.astype(torch.bfloat16)`` gives bfloat16."""
    return cloud.astype(torch.float16)


def to_f32(cloud):
    return cloud.astype(torch.float32)
