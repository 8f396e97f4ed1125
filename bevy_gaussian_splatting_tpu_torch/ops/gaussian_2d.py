"""2DGS surfel projection (the 2DGS paper's homography formulation).

The port's own copy of the JAX package's ``ops/gaussian_2d.py``, term for
term (same products, same order), which transcribes
``compute_cov2d_surfel`` / ``get_bounding_box_cov2d`` /
``surfel_fragment_power`` from src/render/gaussian_2d.wgsl:44-156.

The surfel's local tangent plane (u, v) maps to pixel space through
T = world_from_local^T . clip_from_world^T . Ks, a 3x3 homography; the fragment
power is -0.5 * min(3D ray-plane distance^2, 2 * 2D pixel distance^2).

Pixel-coordinate quirk (reproduced, as the JAX package does): the reference
fragment evaluates the surfel in a doubled, y-flipped frame relative to the
homography's true-pixel ``mean_2d``, so the 2D distance scales both axes by
the viewport width (``surfel_affine_power``).
"""

from __future__ import annotations

import torch

from bevy_gaussian_splatting_tpu_torch.ops.covariance import safe_sqrt

FILTER_SIZE = 0.707106  # gaussian_2d.wgsl:51


def intrinsic_matrix(clip_from_view: torch.Tensor, viewport_size: torch.Tensor) -> torch.Tensor:
    """Ks [4, 3] (math layout of the WGSL mat3x4, helpers.wgsl:122-136):
    true-pixel focal lengths and the (size-1)/2 principal point."""
    w, h = viewport_size[0], viewport_size[1]
    fx = clip_from_view[0, 0] * w / 2.0
    fy = clip_from_view[1, 1] * h / 2.0
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, zero, zero]),
        torch.stack([zero, fy, zero]),
        torch.stack([zero, zero, zero]),
        torch.stack([(w - 1.0) / 2.0, (h - 1.0) / 2.0, one]),
    ])


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of size 3 in a fixed order, (x0 + x1) + x2,
    on every device (a reduction kernel may pair the terms otherwise)."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def compute_cov2d_surfel(
    position_world: torch.Tensor,  # [..., 3] transformed gaussian center
    rotation: torch.Tensor,  # [..., 4]
    scale: torch.Tensor,  # [..., 3]
    global_scale: float,
    model_transform: torch.Tensor,  # [4, 4]
    clip_from_world: torch.Tensor,  # [4, 4]
    clip_from_view: torch.Tensor,  # [4, 4]
    viewport_size: torch.Tensor,  # [2]
    cutoff: torch.Tensor,  # [...]
):
    """Returns (local_to_pixel [..., 3, 3] math-layout T, mean_2d [..., 2],
    extent [..., 2], valid [...]) (gaussian_2d.wgsl:77-132).  Only scale x
    and y enter: the surfel is flat, so scale z gets an exact zero
    gradient."""
    r, qx, qy, qz = (rotation[..., i] for i in range(4))
    # rows of the reference rotation matrix (helpers.wgsl get_rotation_matrix)
    R_rows = (
        (1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy + r * qz), 2.0 * (qx * qz - r * qy)),
        (2.0 * (qx * qy - r * qz), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz + r * qx)),
        (2.0 * (qx * qz + r * qy), 2.0 * (qy * qz - r * qx), 1.0 - 2.0 * (qx * qx + qy * qy)),
    )
    s = tuple(scale[..., j] * global_scale for j in range(2))
    T_r = model_transform[:3, :3]
    # L = T_r @ R^T @ S; only columns 0 and 1 feed world_from_local:
    # L[i][j] = sum_k T_r[i, k] R[j][k] * s_j
    L = [[sum(T_r[i, k] * R_rows[j][k] for k in range(3)) * s[j] for j in range(2)] for i in range(3)]

    # m = clip_from_world^T @ Ks, written out term by term in the matrix
    # product's order so that no device reduction picks another order
    ks = intrinsic_matrix(clip_from_view, viewport_size)  # [4, 3]
    m = sum(clip_from_world[i][:, None] * ks[i] for i in range(4))  # [4, 3]
    pos = tuple(position_world[..., k] for k in range(3))
    # T = wfl^T @ m with wfl columns (L[:,0], 0), (L[:,1], 0), (pos, 1)
    # (gaussian_2d.wgsl:103)
    t_rows = [[sum(L[k][i] * m[k, j] for k in range(3)) for j in range(3)] for i in range(2)]
    t_rows.append([sum(pos[k] * m[k, j] for k in range(3)) + m[3, j] for j in range(3)])
    T = torch.stack([torch.stack(row, dim=-1) for row in t_rows], dim=-2)  # [..., 3, 3]

    cut2 = cutoff * cutoff
    test = torch.stack([cut2, cut2, -torch.ones_like(cut2)], dim=-1)  # [..., 3]
    T0, T1, T2 = T[..., :, 0], T[..., :, 1], T[..., :, 2]  # columns
    d = _sum3(test * T2 * T2)
    valid = d.abs() >= 1.0e-4
    # the divisor is 1 where the surfel is invalid: finite values and
    # finite gradients there
    d_safe = torch.where(valid, d, torch.ones_like(d))
    f = test / d_safe[..., None]
    mean_2d = torch.stack([_sum3(f * T0 * T2), _sum3(f * T1 * T2)], dim=-1)
    t = torch.stack([_sum3(f * T0 * T0), _sum3(f * T1 * T1)], dim=-1)
    extent = mean_2d * mean_2d - t
    valid = valid & (extent[..., 0] >= 1.0e-4) & (extent[..., 1] >= 1.0e-4)
    return T, mean_2d, extent, valid


def surfel_bounding_radius(extent: torch.Tensor, cutoff: torch.Tensor) -> torch.Tensor:
    """max_radius in the reference's doubled pixel units; the quad spans
    +- max_radius/2 true pixels around the projected center
    (gaussian_2d.wgsl:44-75)."""
    radius = safe_sqrt(extent)
    return torch.maximum(torch.maximum(radius[..., 0], radius[..., 1]), cutoff * FILTER_SIZE)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with the product unrounded, as a fused multiply-add: the
    float64 product of two float32 values is exact, and the float64 sum,
    rounded to float32, differs from one rounding only at a float32 tie that
    the float64 sum cannot resolve (rare enough never to have been seen)."""
    return (a.double() * b.double() + c.double()).float()


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, in ``jnp.cross``'s products and order, with
    each a1 b2 - a2 b1 contracted as compiled XLA contracts it,
    fma(a1, b2, -(a2 b1))."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([_fma(a1, b2, -(a2 * b1)), _fma(a2, b0, -(a0 * b2)), _fma(a0, b1, -(a1 * b0))], dim=-1)


def surfel_affine_coeffs(local_to_pixel: torch.Tensor, mean_2d: torch.Tensor, width: int):
    """Folded affine form of the fragment homography intersection.

    (pcx*c - a) x (pcy*c - b) with a/b/c the columns of T expands to
    pcx*(bxc) + pcy*(cxa) + (axb); substituting pcx = m2x + dxn*width gives
    q = dxn*A + dyn*B + C with

        A = width*(bxc),  B = width*(cxa),  C = m2x*(bxc) + m2y*(cxa) + axb.

    The products and sums are rounded as the compiled JAX package rounds
    them: XLA contracts each cross product term and m2x*(bxc) + m2y*(cxa)
    into fused multiply-adds, and so does the port (``_fma``).  That keeps
    A, B, C bit-equal to the JAX package's training path: for a surfel seen
    nearly edge-on the gradients amplify one ulp of A or B to a tenth of a
    field's largest gradient (tests/test_torch_2dgs_train.py).  Returns
    (A, B, C), each [..., 3]."""
    a = local_to_pixel[..., :, 0]
    b = local_to_pixel[..., :, 1]
    c = local_to_pixel[..., :, 2]
    u = _cross(b, c)
    v = _cross(c, a)
    w_ = _cross(a, b)
    wf = float(width)
    m2x = mean_2d[..., 0:1]
    m2y = mean_2d[..., 1:2]
    return wf * u, wf * v, _fma(m2x, u, m2y * v) + w_


def surfel_affine_power(A, B, C, dxn, dyn, width: int) -> torch.Tensor:
    """-0.5 * min(s3d, 2 * d2) from the folded coefficients (see
    :func:`surfel_affine_coeffs`); d2 = width^2*(dxn^2 + dyn^2) is the
    doubled-frame 2D distance (both axes scale by width)."""
    q = dxn[..., None] * A + dyn[..., None] * B + C
    pz = torch.where(q[..., 2].abs() > 1e-12, q[..., 2], torch.full_like(q[..., 2], 1e-12))
    inv_pz = 1.0 / pz  # one reciprocal, as every evaluator of the JAX package
    us = q[..., 0] * inv_pz
    vs = q[..., 1] * inv_pz
    s3d = us * us + vs * vs
    d2x2 = (dxn * dxn + dyn * dyn) * (2.0 * float(width) ** 2)
    return -0.5 * torch.minimum(s3d, d2x2)


def surfel_fragment_power(
    local_to_pixel: torch.Tensor, pixel_coord: torch.Tensor, mean_2d: torch.Tensor
) -> torch.Tensor:
    """-0.5 * min(ray-plane 3D distance^2, 2 * 2D distance^2) of a surfel at
    a pixel (gaussian_2d.wgsl:134-156), unfolded: ``local_to_pixel``
    ``[..., 3, 3]``, ``pixel_coord`` and ``mean_2d`` ``[..., 2]`` in the
    reference's fragment frame.  The planes through the pixel are crossed
    as ``jnp.cross`` crosses them (:func:`_cross`), then divided by the
    clamped ``pz`` (two divides, the JAX function's operations; the
    compositors take the folded :func:`surfel_affine_power`)."""
    deltas = mean_2d - pixel_coord
    t0, t1, t2 = local_to_pixel[..., :, 0], local_to_pixel[..., :, 1], local_to_pixel[..., :, 2]
    hu = pixel_coord[..., 0:1] * t2 - t0
    hv = pixel_coord[..., 1:2] * t2 - t1
    p = _cross(hu, hv)
    pz = torch.where(p[..., 2].abs() > 1e-12, p[..., 2], torch.full_like(p[..., 2], 1e-12))
    us = p[..., 0] / pz
    vs = p[..., 1] / pz
    sigmas_3d = us * us + vs * vs
    sigmas_2d = 2.0 * (deltas * deltas).sum(dim=-1)
    return -0.5 * torch.minimum(sigmas_3d, sigmas_2d)
