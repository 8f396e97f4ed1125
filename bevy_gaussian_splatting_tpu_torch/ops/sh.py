"""Spherical-harmonic colour evaluation.

Basis constants and evaluation order are those of the JAX package's
``ops/sh.py``, transcribed from src/material/spherical_harmonics.wgsl:3-68.
SH storage is interleaved rgb per coefficient: ``sh[k * 3 + channel]``.
"""

from __future__ import annotations

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


def sh_basis(direction: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """Scaled real SH basis shc[k] * Y_k(dir) for [..., 3] unit directions ->
    [..., (degree+1)^2] (spherical_harmonics.wgsl:40-66).  Degree 4 is
    evaluated by the reference shader never, and by this port not yet."""
    if degree > 3:
        raise NotImplementedError("degree-4 SH evaluation is not ported yet")
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
    return torch.stack(terms, dim=-1)


def spherical_harmonics_lookup(
    direction: torch.Tensor,
    sh: torch.Tensor,
    degree: Optional[int] = None,
) -> torch.Tensor:
    """SH colour for [..., 3] directions and [..., K] interleaved-rgb
    coefficients -> [..., 3] with the reference's +0.5 bias
    (spherical_harmonics.wgsl:39).  Like the reference shader, at most
    degree 3 is evaluated."""
    if degree is None:
        degree = sh_degree_from_width(sh.shape[-1])
    eval_degree = min(degree, 3)
    n_basis = (eval_degree + 1) ** 2
    basis = sh_basis(direction, eval_degree)
    acc = basis[..., 0:1] * sh[..., 0:3]
    for j in range(1, n_basis):
        acc = acc + basis[..., j : j + 1] * sh[..., 3 * j : 3 * j + 3]
    return 0.5 + acc


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """Per-channel sRGB EOTF (spherical_harmonics.wgsl:22-33)."""
    return torch.where(
        srgb <= 0.04045,
        srgb / 12.92,
        torch.pow(torch.clamp((srgb + 0.055) / 1.055, min=1e-12), 2.4),
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
