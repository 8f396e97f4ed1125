"""Covariance math: quaternion -> rotation, 3D covariance, EWA 2D projection.

The formulas are the JAX package's ``ops/covariance.py`` term for term (same
products, same order), which transcribes the reference shaders:

  - rotation matrix:   src/render/helpers.wgsl:127-168
  - 3D covariance:     src/render/gaussian_3d.wgsl:49-71
  - EWA projection:    src/render/helpers.wgsl:8-55, +0.3 dilation
  - screen bounding:   src/render/helpers.wgsl:57-120

2D covariances are in "vp units" (NDC times viewport extent, half a pixel),
the frame the reference evaluates fragments in.
"""

from __future__ import annotations

from typing import Optional

import torch


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with finite gradients at x <= 0."""
    safe = torch.clamp(x, min=1e-12)
    return torch.where(x > 0, torch.sqrt(safe), torch.zeros_like(x))


def quat_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]
    (get_rotation_matrix, src/render/helpers.wgsl:127-152; not normalized)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y + r * z), 2.0 * (x * z - r * y)],
        dim=-1,
    )
    row1 = torch.stack(
        [2.0 * (x * y - r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z + r * x)],
        dim=-1,
    )
    row2 = torch.stack(
        [2.0 * (x * z + r * y), 2.0 * (y * z - r * x), 1.0 - 2.0 * (x * x + y * y)],
        dim=-1,
    )
    return torch.stack([row0, row1, row2], dim=-2)


def compute_cov3d(
    rotation: torch.Tensor,
    scale: torch.Tensor,
    global_scale: float = 1.0,
    model_transform: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Upper-triangular 3D covariance [..., 6] from quat [..., 4] + scale [..., 3].

    Sigma = (S R)^T (S R) with S = diag(scale * global_scale); with a
    ``model_transform`` [4,4], TS = T Sigma T^T over its 3x3 part."""
    r, x, y, z = (rotation[..., i] for i in range(4))
    rows = (
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y + r * z), 2.0 * (x * z - r * y)),
        (2.0 * (x * y - r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z + r * x)),
        (2.0 * (x * z + r * y), 2.0 * (y * z - r * x), 1.0 - 2.0 * (x * x + y * y)),
    )
    s2 = tuple((scale[..., k] * global_scale) ** 2 for k in range(3))

    def sig(i, j):
        return sum(s2[k] * rows[k][i] * rows[k][j] for k in range(3))

    sigma = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            sigma[i][j] = sigma[j][i] = sig(i, j)
    if model_transform is not None:
        T = model_transform[:3, :3]
        ts = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for j in range(i, 3):
                acc = 0.0
                for k in range(3):
                    for l in range(3):
                        acc = acc + T[i, k] * sigma[k][l] * T[j, l]
                ts[i][j] = ts[j][i] = acc
        sigma = ts
    return torch.stack(
        [sigma[0][0], sigma[0][1], sigma[0][2], sigma[1][1], sigma[1][2], sigma[2][2]],
        dim=-1,
    )


def cov2d(
    position_world: torch.Tensor,
    cov3d: torch.Tensor,
    view_from_world: torch.Tensor,
    clip_from_view: torch.Tensor,
    viewport_size: torch.Tensor,
) -> torch.Tensor:
    """EWA projection of [..., 6] 3D covariance to [..., 3] 2D covariance
    (sigma_xx, sigma_xy, sigma_yy) in vp units, with the +0.3 dilation
    (``cov2d``, src/render/helpers.wgsl:8-55)."""
    rv = view_from_world[:3, :3]
    tv = view_from_world[:3, 3]
    t = position_world @ rv.T + tv
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]

    focal_x = clip_from_view[0, 0] * viewport_size[0]
    focal_y = clip_from_view[1, 1] * viewport_size[1]

    s = 1.0 / (tz * tz)
    j00 = focal_x / tz
    j11 = -focal_y / tz
    j20 = -focal_x * tx * s
    j21 = focal_y * ty * s

    # T = W @ J with W = rv^T: T[:, 0] and T[:, 1]
    T0 = rv[0, :] * j00[..., None] + rv[2, :] * j20[..., None]
    T1 = rv[1, :] * j11[..., None] + rv[2, :] * j21[..., None]

    c0, c1, c2, c3, c4, c5 = (cov3d[..., i] for i in range(6))

    def vrk_mul(v):
        vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
        return torch.stack(
            [
                c0 * vx + c1 * vy + c2 * vz,
                c1 * vx + c3 * vy + c4 * vz,
                c2 * vx + c4 * vy + c5 * vz,
            ],
            dim=-1,
        )

    vT0 = vrk_mul(T0)
    sxx = torch.sum(T0 * vT0, dim=-1) + 0.3
    sxy = torch.sum(T1 * vT0, dim=-1)
    syy = torch.sum(T1 * vrk_mul(T1), dim=-1) + 0.3
    return torch.stack([sxx, sxy, syy], dim=-1)


def cov2d_eigen(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (lambda1 >= lambda2 >= 0) of the [..., 3] 2D covariance
    (src/render/helpers.wgsl:62-74)."""
    sxx, sxy, syy = cov[..., 0], cov[..., 1], cov[..., 2]
    det = sxx * syy - sxy * sxy
    mid = 0.5 * (sxx + syy)
    term = safe_sqrt(mid * mid - det)
    lambda1 = mid + term
    lambda2 = torch.clamp(mid - term, min=0.0)
    return lambda1, lambda2


def _norm_last(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, kept: sqrt(sum(v * v))."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def obb_axes(cov: torch.Tensor, cutoff: torch.Tensor):
    """Oriented bounding box: (major_radius, minor_radius, eigvec1 [..., 2])
    scaled by cutoff (src/render/helpers.wgsl:88-120)."""
    sxx, sxy, syy = cov[..., 0], cov[..., 1], cov[..., 2]
    lambda1, _ = cov2d_eigen(cov)
    b = safe_sqrt((sxx - syy) ** 2 + 4.0 * sxy * sxy)
    major = safe_sqrt((sxx + syy + b) * 0.5) * cutoff
    minor = safe_sqrt((sxx + syy - b) * 0.5) * cutoff
    ev = torch.stack([-sxy, lambda1 - sxx], dim=-1)
    norm = _norm_last(ev)
    unit_x = torch.stack([torch.ones_like(sxy), torch.zeros_like(sxy)], dim=-1)
    ev = torch.where(norm > 1e-12, ev / torch.clamp(norm, min=1e-12), unit_x)
    return major, minor, ev


def opacity_cutoff(opacity: torch.Tensor, adaptive: bool) -> torch.Tensor:
    """Splat extent cutoff in standard deviations: sqrt(9 + 2 ln(opacity))
    when opacity-adaptive-radius is on, else 3 (src/render/gaussian.wgsl:229-235)."""
    if adaptive:
        return torch.sqrt(
            torch.clamp(9.0 + 2.0 * torch.log(torch.clamp(opacity, min=1e-8)), min=1e-6)
        )
    return torch.full_like(opacity, 3.0)
