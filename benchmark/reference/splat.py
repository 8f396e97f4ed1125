"""The plain reference of the splatting path that the benchmark's cells drive.

Plain PyTorch, imported by nothing of the program and importing nothing of
it.  It renders 3DGS and 4DGS clouds with OBB bounds in the COLOR rasterize
mode (SH degree 3, sRGB-encoded colour), the configurations under
``benchmark/configs/``, through the semantics of the renderer under test:

  1. projection (``project``): the vertex stage of ``mosure/bevy_gaussian_splatting``
     (src/render/gaussian.wgsl:205-436), the EWA 2D covariance with the +0.3
     dilation, the opacity-adaptive cutoff, the OBB axes, the SH colour along
     the view ray; for 4DGS the conditional 3D gaussian at the frame time
     (src/render/gaussian_4d.wgsl:37-130), its mean shifted and its opacity
     scaled by the temporal marginal (masked at or below 0.05);
  2. binning (``bin_pairs``): every active splat's clipped tile rectangle,
     the 32-bit radix depth key (src/sort/radix.wgsl:86-103) front to back,
     ties by descending index, the (gaussian, tile) pairs in that order,
     the farthest dropped past the pair cap, each tile's first ``k_max``
     pairs composited;
  3. compositing (``composite``): front to back, alpha = min(g opacity,
     0.999), g = exp(-4.5 (u^2 + v^2)) inside the OBB quad, with the tile's
     early exit, checked between chunks of 512 pairs aligned to 128-pair
     boundaries of the sorted pair list, once every pixel's transmittance
     is at or below 1/255 (the TPU kernel's chunk grid, which the renderer
     keeps because it changes the image).

It is a frozen copy of the plain (CPU) versions of
``bevy_gaussian_splatting_tpu_torch`` at the commit that added the
benchmark: ``ops/project.py``, ``ops/covariance.py``, ``ops/sh.py``,
``ops/gaussian_4d.py``, ``ops/sort.py``, ``ops/transforms.py``,
``models/camera.py`` ``orbit_camera_device`` and ``_look_at_rh_np``,
``ops/rasterize_tile.py`` (binning), ``ops/cuda/tile_fwd.py``
``composite_tiles_raw_plain`` and ``composite_epilogue``, each operation in
the same order so that float32 rounding agrees.  The binning is written
anew: one sort of (tile, depth rank) keys in place of the pair expansion
and the stable tile sort, which give the same pair order.  Later changes to
the program do not change it.

``dtype`` runs the whole reference in another precision: the benchmark's
control computes it in bfloat16 in the program's place.  The radix key is
taken from the float32 value of the squared distance in every precision
(a key is 32 bits of a float32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

TILE = 16
PIX = TILE * TILE
ALPHA_CAP = 0.999
TRANS_EPS = float(np.float32(1.0 / 255.0))
SENTINEL = 0xFFFFFFFF
MARGINAL_MASK = 0.05
CHUNK_ALIGN = 128  # the chunk grid's alignment in the sorted pair list
PAIRS_HEADROOM = 1.25  # the serving budget's headroom over a pair count

# src/material/spherical_harmonics.wgsl:3-20, as float32 values
SHC = [float(c) for c in np.array([
    0.28209479177387814, -0.4886025119029199, 0.4886025119029199, -0.4886025119029199,
    1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792,
    0.5462742152960396, -0.5900435899266435, 2.890611442640554, -0.4570457994644658,
    0.3731763325901154, -0.4570457994644658, 1.445305721320277, -0.5900435899266435,
], dtype=np.float32)]


# -- cameras -----------------------------------------------------------------


def perspective_np(width: int, height: int, fov_y: float = float(np.pi / 4.0), z_near: float = 0.1) -> np.ndarray:
    """glam ``Mat4::perspective_infinite_reverse_rh`` in float32."""
    f = np.float32(1.0) / np.tan(np.float32(fov_y) / np.float32(2.0))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / np.float32(width / height)
    m[1, 1] = f
    m[2, 3] = z_near
    m[3, 2] = -1.0
    return m


def look_at_np(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """glam ``Mat4::look_at_rh`` in float32 (world -> view)."""
    eye, target, up = (np.asarray(v, np.float32) for v in (eye, target, up))
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    return np.stack([
        np.concatenate([s, np.array([-np.dot(s, eye)], np.float32)]),
        np.concatenate([u, np.array([-np.dot(u, eye)], np.float32)]),
        np.concatenate([-f, np.array([np.dot(f, eye)], np.float32)]),
        np.array([0.0, 0.0, 0.0, 1.0], np.float32),
    ]).astype(np.float32)


def host_camera(view: np.ndarray, proj: np.ndarray, width: int, height: int, device) -> dict:
    """A camera from float32 host matrices; its position -R^T t is taken on
    the host, as a host-built camera of the viewer takes it."""
    view_t = torch.from_numpy(np.asarray(view, np.float32))
    return {
        "view": view_t.to(device),
        "proj": torch.from_numpy(np.asarray(proj, np.float32)).to(device),
        "eye": (-view_t[:3, :3].T @ view_t[:3, 3]).to(device),
        "width": int(width),
        "height": int(height),
    }


def _filled(shape, entries: dict, device) -> torch.Tensor:
    t = torch.zeros(shape, dtype=torch.float32, device=device)
    for index, value in entries.items():
        t[index] = value
    return t


def orbit_camera(az: float, el: float, radius: float, width: int, height: int, device) -> dict:
    """The viewer's orbit camera built on ``device`` from float32 (az, el,
    radius) about the origin: eye = r (cos el sin az, sin el, cos el cos az),
    looking at the origin with +y up, in float32 on the device."""
    orbit = torch.from_numpy(np.asarray([az, el, radius, 0.0, 0.0, 0.0], np.float32)).to(device)
    az_t, el_t, r = orbit[0], orbit[1], orbit[2]
    target = orbit[3:6]
    eye = target + r * torch.stack([torch.cos(el_t) * torch.sin(az_t), torch.sin(el_t), torch.cos(el_t) * torch.cos(az_t)])
    up = _filled((3,), {(1,): 1.0}, device)
    f = target - eye
    f = f / torch.linalg.vector_norm(f)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = torch.linalg.cross(s, f)
    view = torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        _filled((4,), {(3,): 1.0}, device),
    ])
    m = perspective_np(width, height)
    proj = _filled((4, 4), {ij: float(m[ij]) for ij in zip(*np.nonzero(m))}, device)
    return {"view": view, "proj": proj, "eye": -view[:3, :3].T @ view[:3, 3], "width": int(width), "height": int(height)}


# -- projection ----------------------------------------------------------------


def _safe_sqrt(x):
    return torch.where(x > 0, torch.sqrt(torch.clamp(x, min=1e-12)), torch.zeros_like(x))


def _cov3d(q, scale):
    r, x, y, z = (q[..., i] for i in range(4))
    rows = (
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y + r * z), 2.0 * (x * z - r * y)),
        (2.0 * (x * y - r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z + r * x)),
        (2.0 * (x * z + r * y), 2.0 * (y * z - r * x), 1.0 - 2.0 * (x * x + y * y)),
    )
    s2 = tuple((scale[..., k] * 1.0) ** 2 for k in range(3))

    def sig(i, j):
        return sum(s2[k] * rows[k][i] * rows[k][j] for k in range(3))

    return [sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)]


def _conditional(rot_l, rot_r, scale, timescale, timestamp, time):
    """4DGS: the 3D gaussian at ``time`` -> (cov3d list of 6, delta_mean
    [N, 3], marginal, dt, mask)."""
    dt = time - timestamp
    w, x, y, z = (rot_l[..., i] for i in range(4))
    ml = ((w, x, y, z), (-x, w, z, -y), (-y, -z, w, x), (-z, y, -x, w))
    wr, xr, yr, zr = (rot_r[..., i] for i in range(4))
    mr = ((wr, xr, yr, zr), (-xr, wr, -zr, yr), (-yr, zr, wr, -xr), (-zr, -yr, xr, wr))
    R = [[sum(mr[i][k] * ml[k][j] for k in range(4)) for j in range(4)] for i in range(4)]
    s4 = (scale[..., 0] * 1.0, scale[..., 1] * 1.0, scale[..., 2] * 1.0, timescale)

    def sig(i, j):
        return s4[i] * s4[j] * sum(R[k][i] * R[k][j] for k in range(4))

    cov_t = sig(3, 3)
    cov_t_safe = torch.where(cov_t > 1e-12, cov_t, 1e-12)
    marginal = torch.exp(-0.5 * dt * dt / cov_t_safe)
    cov12 = [sig(i, 3) for i in range(3)]
    inv_t = 1.0 / cov_t_safe
    delta = torch.stack([cov12[i] * inv_t * dt for i in range(3)], dim=-1)
    cov = [sig(i, j) - cov12[i] * cov12[j] * inv_t for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    return cov, delta, marginal, dt, marginal > MARGINAL_MASK


def _to_clip(p, clip):
    hom = p @ clip[:3, :3].T + clip[:3, 3]
    w = p @ clip[3, :3] + clip[3, 3]
    return torch.cat([hom, w[..., None]], dim=-1) / (w[..., None] + 1e-9)


def _in_frustum(c):
    return (c[..., 0].abs() < 1.1) & (c[..., 1].abs() < 1.1) & ((c[..., 2] - 0.5).abs() < 0.5)


def _dist2(d):
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _sh_basis(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    c = SHC
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, c[0]), c[1] * y, c[2] * z, c[3] * x,
        c[4] * x * y, c[5] * y * z, c[6] * (2.0 * zz - xx - yy), c[7] * x * z, c[8] * (xx - yy),
        c[9] * y * (3.0 * xx - yy), c[10] * x * y * z, c[11] * y * (4.0 * zz - xx - yy),
        c[12] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), c[13] * x * (4.0 * zz - xx - yy),
        c[14] * z * (xx - yy), c[15] * x * (xx - 3.0 * yy),
    ], dim=-1)


def _contract(basis, sh, k):
    acc = basis[..., 0:1] * sh[..., 0:3]
    for j in range(1, k):
        acc = acc + basis[..., j : j + 1] * sh[..., 3 * j : 3 * j + 3]
    return acc


def _srgb_to_linear(s):
    return torch.where(s <= 0.04045, s / 12.92, torch.pow(torch.clamp((s + 0.055) / 1.055, min=1e-12), 2.4))


def depth_key(dist2, visible):
    """The 32-bit radix depth key (back to front ascending), sentinel where
    the unshifted centre is outside the frustum, as int64."""
    bits = dist2.float().contiguous().view(torch.int32).to(torch.int64) & SENTINEL
    return torch.where(visible, SENTINEL - bits, torch.full_like(bits, SENTINEL))


def project(fields: dict, cam: dict, time=None, dtype=torch.float32) -> dict:
    """Per-gaussian splats of a 3DGS cloud (``spherical_harmonic``) or a
    4DGS cloud (``spherindrical_harmonic``, at ``time``) -> dict with
    ``params`` [N, 10] (the compositor's row: cx_vp, cy_vp, e1, b1, b2, rgb,
    alpha, zero where masked), ``mask``, ``key`` and the pixel extents
    ``cx``, ``cy``, ``rx``, ``ry``.  Differentiable in ``fields``."""
    f = {k: v.to(dtype) for k, v in fields.items()}
    view, proj = cam["view"].to(dtype), cam["proj"].to(dtype)
    eye = cam["eye"].to(dtype)
    width, height = cam["width"], cam["height"]
    clip = proj @ view
    pos = f["position_visibility"][:, :3]
    so = f["scale_opacity"]
    scale, opacity = so[:, :3], so[:, 3]
    key_clip = _to_clip(pos, clip)
    key_visible = _in_frustum(key_clip[..., :3])
    cutoff = torch.sqrt(torch.clamp(9.0 + 2.0 * torch.log(torch.clamp(opacity, min=1e-8)), min=1e-6))
    four_d = "spherindrical_harmonic" in f
    if four_d:
        iso, ts = f["isotropic_rotations"], f["timestamp_timescale"]
        t = torch.full((), float(time), dtype=dtype, device=pos.device)
        cov, delta, marginal, dt, cond_mask = _conditional(iso[:, :4], iso[:, 4:8], scale, ts[:, 1], ts[:, 0], t)
        world = pos + delta
        pclip = _to_clip(world, clip)
        visible = _in_frustum(pclip[..., :3]) & cond_mask
        opacity = opacity * marginal
        diff = world - eye
        dist2 = _dist2(diff)
        key_d2 = _dist2(pos - eye)
    else:
        cov = _cov3d(f["rotation"], scale)
        world, pclip, visible = pos, key_clip, key_visible
        diff = world - eye
        key_d2 = dist2 = _dist2(diff)
    key = depth_key(key_d2, key_visible)
    mask = visible & (key != SENTINEL)

    # EWA projection to vp units with the +0.3 dilation
    rv, tv = view[:3, :3], view[:3, 3]
    tt = world @ rv.T + tv
    tx, ty, tz = tt[..., 0], tt[..., 1], tt[..., 2]
    focal_x = proj[0, 0] * float(width)
    focal_y = proj[1, 1] * float(height)
    s = 1.0 / (tz * tz)
    j00, j11 = focal_x / tz, -focal_y / tz
    j20, j21 = -focal_x * tx * s, focal_y * ty * s
    T0 = rv[0, :] * j00[..., None] + rv[2, :] * j20[..., None]
    T1 = rv[1, :] * j11[..., None] + rv[2, :] * j21[..., None]
    cov3 = torch.stack(cov, dim=-1)
    c0, c1, c2, c3, c4, c5 = (cov3[..., i] for i in range(6))

    def vrk(v):
        vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
        return torch.stack([c0 * vx + c1 * vy + c2 * vz, c1 * vx + c3 * vy + c4 * vz, c2 * vx + c4 * vy + c5 * vz], dim=-1)

    vT0 = vrk(T0)
    sxx = torch.sum(T0 * vT0, dim=-1) + 0.3
    sxy = torch.sum(T1 * vT0, dim=-1)
    syy = torch.sum(T1 * vrk(T1), dim=-1) + 0.3
    # OBB axes (src/render/helpers.wgsl:88-120).  The covariance is stacked
    # and read back per use as the program does: where the axis is
    # ill-conditioned (sxy near 0, lambda1 near sxx) the order in which
    # autograd sums the gradients of its uses shows in the gradient.
    cov2 = torch.stack([sxx, sxy, syy], dim=-1)
    e_xx, e_xy, e_yy = cov2[..., 0], cov2[..., 1], cov2[..., 2]
    det = e_xx * e_yy - e_xy * e_xy
    mid = 0.5 * (e_xx + e_yy)
    lambda1 = mid + _safe_sqrt(mid * mid - det)
    sxx, sxy, syy = cov2[..., 0], cov2[..., 1], cov2[..., 2]
    b = _safe_sqrt((sxx - syy) ** 2 + 4.0 * sxy * sxy)
    major = _safe_sqrt((sxx + syy + b) * 0.5) * cutoff
    minor = _safe_sqrt((sxx + syy - b) * 0.5) * cutoff
    ev = torch.stack([-sxy, lambda1 - sxx], dim=-1)
    sq = torch.sum(ev * ev, dim=-1, keepdim=True)
    pos_sq = sq > 0
    norm = torch.where(pos_sq, torch.sqrt(torch.where(pos_sq, sq, torch.ones_like(sq))), torch.zeros_like(sq))
    unit_x = torch.stack([torch.ones_like(sxy), torch.zeros_like(sxy)], dim=-1)
    axis = torch.where(norm > 1e-12, ev / torch.clamp(norm, min=1e-12), unit_x)

    # colour: SH (4DGS: spherindrical) along the view ray, sRGB to linear
    ray = diff / torch.clamp(torch.sqrt(dist2)[..., None], min=1e-12)
    local = torch.stack([ray[..., 0], ray[..., 1], ray[..., 2]], dim=-1)
    local = local / torch.sqrt(torch.sum(local * local, dim=-1, keepdim=True))
    basis = _sh_basis(local)
    if four_d:
        theta = dt / torch.full((), 1.0, dtype=dtype, device=pos.device)
        tb = torch.stack([torch.ones_like(theta)] + [torch.cos(2.0 * math.pi * k * theta) for k in (1, 2)], dim=-1)
        full = (basis[..., None, :] * tb[..., :, None]).reshape(basis.shape[0], 48)
        rgb = 0.5 + _contract(full, f["spherindrical_harmonic"], 48)
    else:
        rgb = 0.5 + _contract(basis, f["spherical_harmonic"], 16)
    rgb = _srgb_to_linear(rgb)

    ndc = pclip[..., :2]
    alpha = opacity * 1.0 * mask.to(dtype)
    params = torch.stack([
        ndc[:, 0] * float(width), ndc[:, 1] * float(height), axis[:, 0], axis[:, 1], major, minor,
        rgb[:, 0], rgb[:, 1], rgb[:, 2], alpha,
    ], dim=-1)
    e1x, e1y = axis[:, 0].detach(), axis[:, 1].detach()
    b1, b2 = major.detach(), minor.detach()
    return {
        "params": params,
        "mask": mask,
        "key": key,
        "cx": (ndc[:, 0].detach() + 1.0) * 0.5 * width,
        "cy": (1.0 - ndc[:, 1].detach()) * 0.5 * height,
        "rx": (e1x.abs() * b1 + e1y.abs() * b2) * 0.5,
        "ry": (e1y.abs() * b1 + e1x.abs() * b2) * 0.5,
        "axis_conditioned": well_conditioned(sxx.detach(), sxy.detach(), syy.detach()),
    }


AXIS_CONDITION = 1e-3


def well_conditioned(sxx, sxy, syy):
    """Splats whose OBB axis has a gradient of more than rounding noise:
    ``|sxy| >= 1e-3 (sxx + syy)``.  Where the 2D covariance is diagonal to
    within that, lambda1 - sxx rounds to (nearly) nothing and the axis's
    gradient is float32 rounding noise divided by |sxy| (up to ~1e8 times
    a splat's true gradient), in any evaluation order; and at a circular
    covariance the same holds for the square root of its eigenvalue gap."""
    return sxy.float().abs() >= AXIS_CONDITION * (sxx.float() + syy.float())


# -- binning -------------------------------------------------------------------


def tile_budget(n: int) -> int:
    """Pairs composited per tile at most (the renderer's ``k_max``)."""
    return int(min(max(2 * n, 1 << 10), 1 << 13))


def pair_cap(n: int) -> int:
    """The renderer's largest pair budget, 6N within [2^14, 3 * 2^22]."""
    return int(min(max(6 * n, 1 << 14), 3 << 22))


def bin_pairs(splats: dict, width: int, height: int, p_max: int | None = None) -> dict:
    """Pairs of each tile, front to back -> dict with ``g`` [P] (gaussian of
    each pair, sorted by tile then depth), ``start`` [T] (first pair of each
    tile), ``count`` [T] (pairs composited, at most ``k_max``), ``pairs``
    (the uncapped total) and ``kept`` (pairs under the cap ``p_max``,
    default :func:`pair_cap`)."""
    n = splats["mask"].shape[0]
    dev = splats["mask"].device
    tx_count, ty_count = width // TILE, -(-height // TILE)
    num_tiles = tx_count * ty_count
    cx, cy, rx, ry = (splats[k].float() for k in ("cx", "cy", "rx", "ry"))
    on_screen = (cx + rx >= 0.0) & (cx - rx <= width) & (cy + ry >= 0.0) & (cy - ry <= height)
    active = splats["mask"] & (rx > 0.0) & (ry > 0.0) & on_screen
    tx0 = torch.clamp(torch.floor((cx - rx) / TILE), 0, tx_count - 1).to(torch.int64)
    tx1 = torch.clamp(torch.floor((cx + rx) / TILE), 0, tx_count - 1).to(torch.int64)
    ty0 = torch.clamp(torch.floor((cy - ry) / TILE), 0, ty_count - 1).to(torch.int64)
    ty1 = torch.clamp(torch.floor((cy + ry) / TILE), 0, ty_count - 1).to(torch.int64)
    w = torch.where(active, tx1 - tx0 + 1, 0)
    h = torch.where(active, ty1 - ty0 + 1, 0)
    # front to back: the float32 bits of the squared distance ascending,
    # ties by descending index (the reverse of the stable back-to-front sort)
    idx = torch.arange(n, device=dev)
    front = SENTINEL - splats["key"]
    order = torch.argsort(torch.where(active, front, 0) * n + (n - 1 - idx))
    area = (w * h)[order]
    cum = torch.cumsum(area, 0)
    total = int(cum[-1]) if n else 0
    cap = pair_cap(n) if p_max is None else int(p_max)
    kept = min(total, cap)
    # pair j of depth rank r: slot cum[r] - area[r] + j, its tile in the
    # rectangle row by row
    rank = torch.repeat_interleave(torch.arange(n, device=dev), area)[:kept]
    j = torch.arange(kept, device=dev) - (cum - area)[rank]
    g = order[rank]
    tile = (ty0[g] + j // w[g]) * tx_count + tx0[g] + j % w[g]
    sorted_keys, perm = torch.sort(tile * n + rank)
    tile_s = sorted_keys // n
    bounds = torch.searchsorted(tile_s, torch.arange(num_tiles + 1, device=dev))
    start, end = bounds[:-1], bounds[1:]
    return {
        "g": g[perm],
        "start": start,
        "count": torch.clamp(end - start, max=tile_budget(n)),
        "pairs": total,
        "kept": kept,
        "tx_count": tx_count,
        "ty_count": ty_count,
    }


def serving_budget(n: int, pairs: int) -> int:
    """The pair budget that a served frame's count sizes: the next of the
    buckets 2^k, 1.5 2^k above ``PAIRS_HEADROOM`` times the count, at least
    2^14 and at most :func:`pair_cap`."""
    need = max(int(pairs * PAIRS_HEADROOM) + 1, 1 << 14)
    bucket = 1 << 14
    while bucket < need:
        bucket *= 2
    if bucket // 2 * 3 // 2 >= need:
        bucket = bucket // 2 * 3 // 2
    return min(bucket, pair_cap(n))


def chunk_for(budget: int, num_tiles: int) -> int:
    """The chunk grid that a pair budget sets: 256 pairs where it averages at
    most 320 a tile, else 512."""
    return 256 if budget / max(num_tiles, 1) <= 320 else 512


# -- compositing ---------------------------------------------------------------


def _pixel_coords(tids, tx_count: int, width: int, height: int, dtype):
    """Pixel centres of tiles ``tids`` in vp units: fma(p, 2 / size, -1)
    rounded once to float32, times the size."""
    inv_w2, inv_h2 = float(np.float32(2.0 / width)), float(np.float32(2.0 / height))
    sub = torch.arange(PIX, device=tids.device)
    px = (tids % tx_count)[:, None] * TILE + (sub % TILE) + 0.5
    py = (tids // tx_count)[:, None] * TILE + (sub // TILE) + 0.5
    x = (px.double() * inv_w2 - 1.0).float() * float(width)
    y = (1.0 - py.double() * inv_h2).float() * float(height)
    return x.to(dtype), y.to(dtype)


def composite_tiles(params, bins: dict, width: int, height: int, chunk: int, tids, counts: dict | None = None):
    """Composite tiles ``tids`` -> (accum [B, 3, 256], trans [B, 256]),
    differentiable in ``params`` [N, 10].  ``counts``, if given, gains the
    pairs walked before the early exit (``walked``) and the (pair, pixel)
    evaluations inside a splat's quad (``inside``)."""
    dev, dtype = params.device, params.dtype
    start = bins["start"][tids]
    base = start // CHUNK_ALIGN * CHUNK_ALIGN
    prefix = start - base
    total = bins["count"][tids] + prefix
    n_chunks = (total + chunk - 1) // chunk
    px, py = _pixel_coords(tids, bins["tx_count"], width, height, dtype)
    px, py = px[:, None, :], py[:, None, :]
    g_pairs = bins["g"]
    n_pairs = g_pairs.shape[0]
    trans = torch.ones((tids.shape[0], PIX), dtype=dtype, device=dev)
    accum = torch.zeros((tids.shape[0], 3, PIX), dtype=dtype, device=dev)
    span = int(total.max()) if tids.numel() else 0
    lane = torch.arange(chunk, device=dev)
    for c in range(int(n_chunks.max()) if tids.numel() else 0):
        running = c < n_chunks
        if c > 0:
            running = running & (trans.detach().amax(dim=1) > TRANS_EPS)
        if not bool(running.any()):
            break
        lane_idx = c * chunk + lane[: span - c * chunk]
        in_rng = (lane_idx >= prefix[:, None]) & (lane_idx < total[:, None]) & running[:, None]
        pidx = (base[:, None] + lane_idx).clamp(max=max(n_pairs - 1, 0))
        # rows out of the tile's range are zeroed: no quad, no colour
        q = params[g_pairs[pidx]] * in_rng[..., None].to(dtype)  # [B, L, 10]
        cx, cy, e1x, e1y, b1, b2 = (q[..., i : i + 1] for i in range(6))
        dx = px - cx
        dy = py - cy
        inv_b1 = 1.0 / torch.clamp(b1, min=1e-12)
        inv_b2 = 1.0 / torch.clamp(b2, min=1e-12)
        u = (dx * e1x + dy * e1y) * inv_b1
        v = (dx * e1y - dy * e1x) * inv_b2
        inside = (u.abs() <= 1.0) & (v.abs() <= 1.0) & (b1 > 0.0) & in_rng[..., None]
        g = torch.where(inside, torch.exp(-4.5 * (u * u + v * v)), 0.0)
        alpha = torch.clamp(g * q[..., 9:10], max=ALPHA_CAP)
        if counts is not None:
            counts["walked"] += int(in_rng.sum())
            counts["inside"] += int(inside.sum())
        cum = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        w = alpha * excl * trans[:, None, :]
        accum = accum + torch.stack([torch.sum(w * q[..., 6 + ch : 7 + ch], dim=1) for ch in range(3)], dim=1)
        trans = trans * cum[:, -1]
    return accum, trans


def tiles_to_image(accum, trans, tx_count: int, ty_count: int, height: int):
    """[T, 3, 256] and [T, 256] over a zero background -> [H, W, 4] linear
    premultiplied RGBA (rows past ``height`` cropped)."""
    tile_img = torch.cat([accum.transpose(1, 2), (1.0 - trans)[..., None]], dim=-1)
    img = tile_img.reshape(ty_count, tx_count, TILE, TILE, 4).permute(0, 2, 1, 3, 4)
    return img.reshape(ty_count * TILE, tx_count * TILE, 4)[:height]


def image_to_tiles(img, tx_count: int, ty_count: int):
    """[H, W, C] (H padded with zero rows to the tile grid) -> [T, C, 256]."""
    pad = ty_count * TILE - img.shape[0]
    if pad:
        img = torch.cat([img, img.new_zeros((pad,) + tuple(img.shape[1:]))])
    c = img.shape[-1]
    return img.reshape(ty_count, TILE, tx_count, TILE, c).permute(0, 2, 4, 1, 3).reshape(ty_count * tx_count, c, PIX)


def render_bins(params, bins: dict, width: int, height: int, chunk: int, batch: int = 128, counts=None):
    """The image of ``params`` composited over ``bins`` -> [H, W, 4]."""
    num_tiles = bins["tx_count"] * bins["ty_count"]
    dev = params.device
    accs, trs = [], []
    for b0 in range(0, num_tiles, batch):
        tids = torch.arange(b0, min(b0 + batch, num_tiles), device=dev)
        a, t = composite_tiles(params, bins, width, height, chunk, tids, counts)
        accs.append(a)
        trs.append(t)
    return tiles_to_image(torch.cat(accs), torch.cat(trs), bins["tx_count"], bins["ty_count"], height)


def render_frame(fields: dict, cam: dict, time=None, bin_cam: dict | None = None, bin_time=None, p_max=None,
                 chunk=None, dtype=torch.float32, counts=None):
    """One served or trained frame -> ([H, W, 4], bins).  ``bin_cam`` and
    ``bin_time`` give the pose at which the frame's pairs were binned (a
    stale binning, replayed with the splats of ``cam`` and ``time``)."""
    width, height = cam["width"], cam["height"]
    with torch.no_grad():
        splats = project(fields, cam, time, dtype)
        bsplats = splats if bin_cam is None else project(fields, bin_cam, time if bin_time is None else bin_time, dtype)
        bins = bin_pairs(bsplats, width, height, p_max)
        if chunk is None:
            chunk = chunk_for(serving_budget(splats["mask"].shape[0], bins["pairs"]),
                              bins["tx_count"] * bins["ty_count"])
        img = render_bins(splats["params"], bins, width, height, chunk, counts=counts)
        if counts is not None:
            counts["visible"] = counts.get("visible", 0) + int(splats["mask"].sum())
            counts["tiles"] = counts.get("tiles", 0) + bins["tx_count"] * bins["ty_count"]
    return img, bins
