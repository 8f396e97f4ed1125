"""Spherical- and spherindrical-harmonic colour evaluation.

Basis constants and evaluation order are those of the JAX package's
``ops/sh.py``, transcribed from src/material/spherical_harmonics.wgsl:3-68
(degree <= 3, and the standard real degree-4 terms) and
src/material/spherindrical_harmonics.wgsl:11-126 (4DGS: the spatial basis
times temporal cosine harmonics).  SH storage is interleaved rgb per
coefficient: ``sh[k * 3 + channel]``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.models.cloud import sh_degree_from_width

# src/material/spherical_harmonics.wgsl:3-20
SHC = np.array(
    [
        0.28209479177387814,
        -0.4886025119029199,
        0.4886025119029199,
        -0.4886025119029199,
        1.0925484305920792,
        -1.0925484305920792,
        0.31539156525252005,
        -1.0925484305920792,
        0.5462742152960396,
        -0.5900435899266435,
        2.890611442640554,
        -0.4570457994644658,
        0.3731763325901154,
        -0.4570457994644658,
        1.445305721320277,
        -0.5900435899266435,
    ],
    dtype=np.float32,
)
_SHC = [float(c) for c in SHC]  # float32 values as Python scalars

# Degree-4 real SH constants (standard normalisation, the shc table's sign
# convention).  The reference's sh4 feature stores 25 x 3 coefficients but
# its shader evaluates through degree 3 only, so these are evaluated only on
# request (``spherical_harmonics_lookup``'s ``eval_degree``).
SHC4 = np.array(
    [
        2.5033429417967046,
        -1.7701307697799304,
        0.9461746957575601,
        -0.6690465435572892,
        0.10578554691520431,
        -0.6690465435572892,
        0.47308734787878004,
        -1.7701307697799304,
        0.6258357354491761,
    ],
    dtype=np.float32,
)
_SHC4 = [float(c) for c in SHC4]


def sh_basis(direction: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """Scaled real SH basis shc[k] * Y_k(dir) for [..., 3] unit directions ->
    [..., (degree+1)^2] (spherical_harmonics.wgsl:40-66); degree 4 adds the
    standard real Y_4 polynomials (``SHC4``)."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    c = _SHC
    terms = [torch.full_like(x, c[0])]
    if degree >= 1:
        terms += [c[1] * y, c[2] * z, c[3] * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        terms += [
            c[4] * x * y,
            c[5] * y * z,
            c[6] * (2.0 * zz - xx - yy),
            c[7] * x * z,
            c[8] * (xx - yy),
        ]
    if degree >= 3:
        terms += [
            c[9] * y * (3.0 * xx - yy),
            c[10] * x * y * z,
            c[11] * y * (4.0 * zz - xx - yy),
            c[12] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            c[13] * x * (4.0 * zz - xx - yy),
            c[14] * z * (xx - yy),
            c[15] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        c4 = _SHC4
        xx, yy, zz = x * x, y * y, z * z
        terms += [
            c4[0] * x * y * (xx - yy),
            c4[1] * y * z * (3.0 * xx - yy),
            c4[2] * x * y * (7.0 * zz - 1.0),
            c4[3] * y * z * (7.0 * zz - 3.0),
            c4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            c4[5] * x * z * (7.0 * zz - 3.0),
            c4[6] * (xx - yy) * (7.0 * zz - 1.0),
            c4[7] * x * z * (xx - 3.0 * yy),
            c4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(terms, dim=-1)


def sh_storage_degree(sh: torch.Tensor) -> int:
    """Storage degree encoded by an interleaved-rgb SH array's width."""
    return sh_degree_from_width(sh.shape[-1])


def spherical_harmonics_lookup(
    direction: torch.Tensor,
    sh: torch.Tensor,
    degree: Optional[int] = None,
    eval_degree: Optional[int] = None,
) -> torch.Tensor:
    """SH colour for [..., 3] directions and [..., K] interleaved-rgb
    coefficients -> [..., 3] with the reference's +0.5 bias
    (spherical_harmonics.wgsl:39).

    ``degree`` defaults to the storage degree of the array's width;
    ``eval_degree`` caps the evaluated basis and defaults to ``min(degree,
    3)``, the reference shader's (it stops at shc[15] under the sh4 storage
    feature too).  ``eval_degree=4`` evaluates an sh4 cloud in full."""
    if degree is None:
        degree = sh_storage_degree(sh)
    if eval_degree is None:
        eval_degree = min(degree, 3)
    d = min(eval_degree, degree)
    return 0.5 + _interleaved_contract(sh_basis(direction, d), sh, (d + 1) ** 2)


def _interleaved_contract(basis: torch.Tensor, sh: torch.Tensor, k: int) -> torch.Tensor:
    """sum_j basis[..., j] * sh[..., 3j:3j+3] -> [..., 3], summed in j order."""
    acc = basis[..., 0:1] * sh[..., 0:3]
    for j in range(1, k):
        acc = acc + basis[..., j : j + 1] * sh[..., 3 * j : 3 * j + 3]
    return acc


def spherindrical_harmonics_lookup(
    direction: torch.Tensor,
    dir_t: torch.Tensor,
    sh: torch.Tensor,
    duration: torch.Tensor,
    degree: int = 3,
    degree_time: int = 2,
) -> torch.Tensor:
    """4DGS colour: the spatial SH basis times the temporal harmonics
    cos(2 pi k theta), theta = dir_t / duration, blocks of the full basis
    per harmonic (spherindrical_harmonics.wgsl:77-126).  ``duration`` is a
    float32 tensor (a true division; a Python divisor may be turned into a
    multiplication by its reciprocal)."""
    n_basis = (degree + 1) ** 2
    basis = sh_basis(direction, degree)
    theta = dir_t / duration
    # a Python-float constant times the float32 tensor, as the JAX package
    # writes 2.0 * jnp.pi * k * theta
    blocks = [torch.ones_like(theta)] + [torch.cos(2.0 * math.pi * k * theta) for k in range(1, degree_time + 1)]
    tb = torch.stack(blocks, dim=-1)
    full = (basis[..., None, :] * tb[..., :, None]).reshape(*basis.shape[:-1], n_basis * (degree_time + 1))
    return 0.5 + _interleaved_contract(full, sh, n_basis * (degree_time + 1))


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """Per-channel sRGB EOTF (spherical_harmonics.wgsl:22-33)."""
    return torch.where(
        srgb <= 0.04045,
        srgb / 12.92,
        torch.pow(torch.clamp((srgb + 0.055) / 1.055, min=1e-12), 2.4),
    )


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Per-channel sRGB OETF, the inverse of :func:`srgb_to_linear`: the
    encode of the reference's Rgba8UnormSrgb render target
    (src/render/mod.rs:914-982)."""
    return torch.where(
        linear <= 0.0031308,
        linear * 12.92,
        1.055 * torch.pow(torch.clamp(linear, min=1e-12), 1.0 / 2.4) - 0.055,
    )


def world_to_local_direction(direction: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Rotate a world-space ray direction into the cloud's local frame using
    the normalized model-transform basis (src/render/gaussian.wgsl:186-203)."""
    basis = transform[:3, :3]  # columns are the local axes in world space

    def unit(v):
        return v / torch.sqrt(torch.sum(v * v))

    bx, by, bz = unit(basis[:, 0]), unit(basis[:, 1]), unit(basis[:, 2])
    local = torch.stack([direction @ bx, direction @ by, direction @ bz], dim=-1)
    return local / torch.sqrt(torch.sum(local * local, dim=-1, keepdim=True))
