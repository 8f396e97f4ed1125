"""4DGS temporal conditioning: the 4D gaussian -> a 3D gaussian at time t.

The counterpart of the JAX package's ``ops/gaussian_4d.py``, which
transcribes ``conditional_cov3d`` (src/render/gaussian_4d.wgsl:37-130): the
4D rotation is the isotropic dual-quaternion product M_r . M_l applied to
diag(scale, timescale); the gaussian drawn at time t has the conditional
covariance Sigma_11 - Sigma_12 Sigma_12^T / Sigma_tt, its mean shifted by
Sigma_12 / Sigma_tt * dt and its opacity scaled by the temporal marginal
exp(-dt^2 / (2 Sigma_tt)), masked at or below 0.05.

The products and sums are the JAX package's, component by component and in
its order (each ``sum`` over k starts from 0), so that float32 rounding
agrees with the reference.  The reference does not conjugate the 4D
covariance by the model transform; only the shifted mean goes through it.
"""

from __future__ import annotations

import torch

MARGINAL_MASK_THRESHOLD = 0.05  # gaussian_4d.wgsl:92


def conditional_cov3d(
    rotation: torch.Tensor,  # [..., 4] left quaternion
    rotation_r: torch.Tensor,  # [..., 4] right quaternion
    scale: torch.Tensor,  # [..., 3]
    timescale: torch.Tensor,  # [...]
    timestamp: torch.Tensor,  # [...]
    time: torch.Tensor,  # float32 scalar tensor or [...]
    global_scale: float = 1.0,
) -> dict:
    """-> dict(cov3d [..., 6], delta_mean [..., 3], opacity_modifier [...],
    dir_t [...], mask [...])."""
    dt = time - timestamp

    w, x, y, z = (rotation[..., i] for i in range(4))
    ml = (
        (w, x, y, z),
        (-x, w, z, -y),
        (-y, -z, w, x),
        (-z, y, -x, w),
    )
    wr, xr, yr, zr = (rotation_r[..., i] for i in range(4))
    mr = (
        (wr, xr, yr, zr),
        (-xr, wr, -zr, yr),
        (-yr, zr, wr, -xr),
        (-zr, -yr, xr, wr),
    )
    R = [[sum(mr[i][k] * ml[k][j] for k in range(4)) for j in range(4)] for i in range(4)]
    s4 = (
        scale[..., 0] * global_scale,
        scale[..., 1] * global_scale,
        scale[..., 2] * global_scale,
        timescale,
    )

    # M = R diag(s4); sigma = M^T M: sigma_ij = s4_i s4_j sum_k R[k][i] R[k][j]
    def sig(i, j):
        return s4[i] * s4[j] * sum(R[k][i] * R[k][j] for k in range(4))

    cov_t = sig(3, 3)
    cov_t_safe = torch.where(cov_t > 1e-12, cov_t, 1e-12)
    marginal_t = torch.exp(-0.5 * dt * dt / cov_t_safe)
    mask = marginal_t > MARGINAL_MASK_THRESHOLD

    cov12 = [sig(i, 3) for i in range(3)]
    inv_t = 1.0 / cov_t_safe

    def cond(i, j):
        return sig(i, j) - cov12[i] * cov12[j] * inv_t

    delta_mean = torch.stack([cov12[i] * inv_t * dt for i in range(3)], dim=-1)
    cov3d = torch.stack(
        [cond(0, 0), cond(0, 1), cond(0, 2), cond(1, 1), cond(1, 2), cond(2, 2)], dim=-1
    )
    return {
        "cov3d": cov3d,
        "delta_mean": delta_mean,
        "opacity_modifier": marginal_t,
        "dir_t": dt,
        "mask": mask,
    }
