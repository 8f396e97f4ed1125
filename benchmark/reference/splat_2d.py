"""The plain reference of the 2DGS surfel path that the benchmark's surfel
cells drive.

Plain PyTorch, imported by nothing of the program and importing nothing of
it; from ``benchmark/reference/splat.py`` it takes the camera, the SH colour,
the radix key, the binning and the chunk grid, which 2DGS shares with 3DGS.
It renders a 3DGS cloud's fields (``spherical_harmonic``, SH degree 3) as
surfels (Huang et al., *2D Gaussian Splatting for Geometrically Accurate
Radiance Fields*, SIGGRAPH 2024) in the COLOR rasterize mode, sRGB-encoded
colour, under the identity model transform:

  1. projection (``project``): the surfel's local tangent plane (u, v), its
     columns R^T S (two scales; the third axis is flat), maps to pixels
     through the 3x3 homography T = world_from_local^T clip_from_world^T Ks
     of ``mosure/bevy_gaussian_splatting`` src/render/gaussian_2d.wgsl:77-132;
     the surfel is valid where |d| and both extents are at least 1e-4, its
     centre is the homography's, its bounding radius
     max(sqrt(extent), cutoff x 0.707106) (:44-75); the position, frustum
     test, opacity-adaptive cutoff and SH colour are the 3DGS vertex
     stage's (src/render/gaussian.wgsl:205-436);
  2. binning (``splat.bin_pairs``): the square of half the radius about the
     centre, the 32-bit radix depth key front to back, the pair cap and
     ``k_max``;
  3. compositing (``composite_tiles``): front to back, alpha = min(g
     opacity, 0.999), g = exp(-0.5 min(s3d, 2 d2)) inside the surfel's
     square, s3d the squared distance of the pixel's ray to the centre in
     the surfel's plane (us^2 + vs^2), d2 the 2D distance to the centre
     (gaussian_2d.wgsl:134-156), with the tile's early exit between chunks
     on the grid of ``splat.composite_tiles``.

Departures from the paper's description, each the renderer's:

  - the fragment frame is the WGSL's doubled, y-flipped one: pixel offsets
    are taken in NDC from the centre and scaled to pixels by the width on
    both axes, so the 2D distance term is 2 width^2 (dxn^2 + dyn^2) and the
    bounding radius is in doubled pixel units (half of it in true pixels);
  - the plane intersection (pcx c - a) x (pcy c - b) of T's columns a, b, c
    is expanded to q = dxn A + dyn B + C with A = width (b x c), B = width
    (c x a), C = m2x (b x c) + m2y (c x a) + a x b, m2 the homography's
    centre (the same function, which the renderer packs per surfel);
  - q.z is clamped to 1e-12 where |q.z| <= 1e-12, which drops its sign
    (a surfel seen exactly edge-on takes the positive side);
  - each a1 b2 - a2 b1 of a cross product and m2x (b x c) + m2y (c x a) are
    fused multiply-adds, as the compiled renderer contracts them;
  - the pixel centre is fma(p, 2 / size, -1) rounded once, in NDC.

Sums over three terms are written out in the renderer's order so that
float32 rounding agrees where a surfel seen nearly edge-on makes the
extents a cancellation.  ``dtype`` runs the whole reference in another
precision: the benchmark's control computes it in bfloat16 in the
program's place.  The radix key is taken from the float32 value of the
squared distance in every precision, as ``splat.py`` takes it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import splat
from benchmark.reference.splat import (
    ALPHA_CAP,
    CHUNK_ALIGN,
    PIX,
    SENTINEL,
    TILE,
    TRANS_EPS,
)

# TF32 would round the reference's products to 10 bits wherever PyTorch
# routes them through a matrix unit
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FILTER_SIZE = 0.707106  # gaussian_2d.wgsl:51
VALID_EPS = 1e-4  # gaussian_2d.wgsl:111-127
PZ_EPS = 1e-12  # gaussian_2d.wgsl:147
PARAM_COLS = 16  # cx, cy (NDC), radius, A, B, C, r, g, b, alpha


def _fma(a, b, c):
    """a b + c with one rounding: the float64 product of two float32 (or
    bfloat16) values is exact, and its sum rounds once more only at a tie."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _cross(a, b):
    """a x b of [..., 3] columns, each a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1))."""
    return [_fma(a[1], b[2], -(a[2] * b[1])), _fma(a[2], b[0], -(a[0] * b[2])), _fma(a[0], b[1], -(a[1] * b[0]))]


def _sum3(x0, x1, x2):
    return (x0 + x1) + x2


def intrinsics(proj, width: int, height: int):
    """Ks [4, 3] (the WGSL's mat3x4): focal lengths in true pixels, the
    principal point at ((w - 1) / 2, (h - 1) / 2)."""
    w, h = float(width), float(height)
    ks = torch.zeros((4, 3), dtype=proj.dtype, device=proj.device)
    ks[0, 0] = proj[0, 0] * w / 2.0
    ks[1, 1] = proj[1, 1] * h / 2.0
    ks[3, 0] = (w - 1.0) / 2.0
    ks[3, 1] = (h - 1.0) / 2.0
    ks[3, 2] = 1.0
    return ks


def project(fields: dict, cam: dict, time=None, dtype=torch.float32) -> dict:
    """Per-surfel splats of a 3DGS cloud's fields drawn as 2DGS -> dict with
    ``params`` [N, 16] (cx, cy in NDC, radius, A, B, C, rgb, alpha, zero
    where masked), ``mask``, ``key`` and the pixel extents ``cx``, ``cy``,
    ``rx``, ``ry``.  ``time`` is unused (a surfel cloud has none)."""
    f = {k: v.to(dtype) for k, v in fields.items()}
    view, proj = cam["view"].to(dtype), cam["proj"].to(dtype)
    eye = cam["eye"].to(dtype)
    width, height = cam["width"], cam["height"]
    clip = proj @ view
    pos = f["position_visibility"][:, :3]
    so = f["scale_opacity"]
    opacity = so[:, 3]
    pclip = splat._to_clip(pos, clip)
    visible = splat._in_frustum(pclip[..., :3])
    cutoff = torch.sqrt(torch.clamp(9.0 + 2.0 * torch.log(torch.clamp(opacity, min=1e-8)), min=1e-6))
    diff = pos - eye
    dist2 = splat._dist2(diff)
    key = splat.depth_key(dist2, visible)

    # T: rows L[:, 0], L[:, 1] (R^T S, the identity model transform) and
    # (position, 1), each times m = clip^T Ks
    q = f["rotation"]
    r, x, y, z = (q[..., i] for i in range(4))
    rows = (
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y + r * z), 2.0 * (x * z - r * y)),
        (2.0 * (x * y - r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z + r * x)),
    )
    s = (so[:, 0] * 1.0, so[:, 1] * 1.0)
    L = [[rows[j][i] * s[j] for j in range(2)] for i in range(3)]
    ks = intrinsics(proj, width, height)
    m = sum(clip[i][:, None] * ks[i] for i in range(4))  # [4, 3]
    T = [[_sum3(L[0][a] * m[0, j], L[1][a] * m[1, j], L[2][a] * m[2, j]) for j in range(3)] for a in range(2)]
    T.append([_sum3(pos[:, 0] * m[0, j], pos[:, 1] * m[1, j], pos[:, 2] * m[2, j]) + m[3, j] for j in range(3)])
    col = [[T[k][j] for k in range(3)] for j in range(3)]  # the columns a, b, c

    cut2 = cutoff * cutoff
    d = _sum3(cut2 * T[0][2] * T[0][2], cut2 * T[1][2] * T[1][2], -1.0 * T[2][2] * T[2][2])
    valid = d.abs() >= VALID_EPS
    d_safe = torch.where(valid, d, torch.ones_like(d))
    fc, fz = cut2 / d_safe, -1.0 / d_safe
    mean = [_sum3(fc * T[0][c] * T[0][2], fc * T[1][c] * T[1][2], fz * T[2][c] * T[2][2]) for c in range(2)]
    extent = [mean[c] * mean[c] - _sum3(fc * T[0][c] * T[0][c], fc * T[1][c] * T[1][c], fz * T[2][c] * T[2][c])
              for c in range(2)]
    valid = valid & (extent[0] >= VALID_EPS) & (extent[1] >= VALID_EPS)
    radius = torch.maximum(torch.maximum(splat._safe_sqrt(extent[0]), splat._safe_sqrt(extent[1])),
                           cutoff * FILTER_SIZE)

    # the folded plane intersection
    u = _cross(col[1], col[2])
    v = _cross(col[2], col[0])
    w_ = _cross(col[0], col[1])
    wf = float(width)
    A = [wf * u[k] for k in range(3)]
    B = [wf * v[k] for k in range(3)]
    C = [_fma(mean[0], u[k], mean[1] * v[k]) + w_[k] for k in range(3)]

    # colour: SH along the view ray, sRGB to linear
    ray = diff / torch.clamp(torch.sqrt(dist2)[..., None], min=1e-12)
    local = ray / torch.sqrt(torch.sum(ray * ray, dim=-1, keepdim=True))
    rgb = splat._srgb_to_linear(0.5 + splat._contract(splat._sh_basis(local), f["spherical_harmonic"], 16))

    mask = visible & valid & (key != SENTINEL)
    ndc = pclip[..., :2]
    alpha = opacity * 1.0 * mask.to(dtype)
    params = torch.stack([ndc[:, 0], ndc[:, 1], radius, *A, *B, *C, rgb[:, 0], rgb[:, 1], rgb[:, 2], alpha], dim=-1)
    half = radius.detach() * 0.5
    return {
        "params": params,
        "mask": mask,
        "key": key,
        "cx": (ndc[:, 0].detach() + 1.0) * 0.5 * width,
        "cy": (1.0 - ndc[:, 1].detach()) * 0.5 * height,
        "rx": half,
        "ry": half,
    }


def _ndc_coords(tids, tx_count: int, width: int, height: int, dtype):
    """Pixel centres of tiles ``tids`` in NDC: fma(p, 2 / size, -1) rounded
    once to float32 (times f32(size f32(1 / size)), 1 at the cells' sizes)."""
    inv_w2, inv_h2 = float(np.float32(2.0 / width)), float(np.float32(2.0 / height))
    sub = torch.arange(PIX, device=tids.device)
    px = (tids % tx_count)[:, None] * TILE + (sub % TILE) + 0.5
    py = (tids // tx_count)[:, None] * TILE + (sub // TILE) + 0.5
    x = (px.double() * inv_w2 - 1.0).float() * float(np.float32(width * np.float32(1.0 / width)))
    y = (1.0 - py.double() * inv_h2).float() * float(np.float32(height * np.float32(1.0 / height)))
    return x.to(dtype), y.to(dtype)


def falloff(q, px, py, width: int, height: int):
    """g of surfel rows ``q`` [..., 16] at NDC pixels ``px``, ``py`` -> (g,
    inside): zero outside the surfel's square."""
    inv_w, inv_h = float(np.float32(1.0 / width)), float(np.float32(1.0 / height))
    two_w2 = float(np.float32(2.0 * width * width))
    dxn = px - q[..., 0:1]
    dyn = py - q[..., 1:2]
    mr = q[..., 2:3]
    inside = (dxn.abs() <= mr * inv_w) & (dyn.abs() <= mr * inv_h)
    qx, qy, qz = (dxn * q[..., 3 + k : 4 + k] + dyn * q[..., 6 + k : 7 + k] + q[..., 9 + k : 10 + k] for k in range(3))
    inv_pz = 1.0 / torch.where(qz.abs() > PZ_EPS, qz, torch.full_like(qz, PZ_EPS))
    us = qx * inv_pz
    vs = qy * inv_pz
    s3d = us * us + vs * vs
    d2x2 = (dxn * dxn + dyn * dyn) * two_w2
    return torch.where(inside, torch.exp(-0.5 * torch.minimum(s3d, d2x2)), 0.0), inside


def composite_tiles(params, bins: dict, width: int, height: int, chunk: int, tids, counts: dict | None = None):
    """Composite tiles ``tids`` -> (accum [B, 3, 256], trans [B, 256]) on the
    chunk grid of ``splat.composite_tiles``.  ``counts``, if given, gains
    the pairs walked before the early exit (``walked``) and the (pair,
    pixel) evaluations inside a surfel's square (``inside``)."""
    dev, dtype = params.device, params.dtype
    start = bins["start"][tids]
    base = start // CHUNK_ALIGN * CHUNK_ALIGN
    prefix = start - base
    total = bins["count"][tids] + prefix
    n_chunks = (total + chunk - 1) // chunk
    px, py = _ndc_coords(tids, bins["tx_count"], width, height, dtype)
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
            running = running & (trans.amax(dim=1) > TRANS_EPS)
        if not bool(running.any()):
            break
        lane_idx = c * chunk + lane[: span - c * chunk]
        in_rng = (lane_idx >= prefix[:, None]) & (lane_idx < total[:, None]) & running[:, None]
        pidx = (base[:, None] + lane_idx).clamp(max=max(n_pairs - 1, 0))
        q = params[g_pairs[pidx]] * in_rng[..., None].to(dtype)  # [B, L, 16]
        g, inside = falloff(q, px, py, width, height)
        inside = inside & in_rng[..., None]
        alpha = torch.where(inside, torch.clamp(g * q[..., 15:16], max=ALPHA_CAP), 0.0)
        if counts is not None:
            counts["walked"] += int(in_rng.sum())
            counts["inside"] += int(inside.sum())
        cum = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        w = alpha * excl * trans[:, None, :]
        accum = accum + torch.stack([torch.sum(w * q[..., 12 + ch : 13 + ch], dim=1) for ch in range(3)], dim=1)
        trans = trans * cum[:, -1]
    return accum, trans


def render_bins(params, bins: dict, width: int, height: int, chunk: int, batch: int = 128, counts=None):
    """The image of surfel ``params`` composited over ``bins`` -> [H, W, 4]."""
    num_tiles = bins["tx_count"] * bins["ty_count"]
    dev = params.device
    accs, trs = [], []
    for b0 in range(0, num_tiles, batch):
        tids = torch.arange(b0, min(b0 + batch, num_tiles), device=dev)
        a, t = composite_tiles(params, bins, width, height, chunk, tids, counts)
        accs.append(a)
        trs.append(t)
    return splat.tiles_to_image(torch.cat(accs), torch.cat(trs), bins["tx_count"], bins["ty_count"], height)


def render_frame(fields: dict, cam: dict, time=None, bin_cam: dict | None = None, bin_time=None, p_max=None,
                 chunk=None, dtype=torch.float32, counts=None):
    """One served surfel frame -> ([H, W, 4], bins).  ``bin_cam`` gives the
    pose at which the frame's pairs were binned (a stale binning, replayed
    with the splats of ``cam``)."""
    width, height = cam["width"], cam["height"]
    with torch.no_grad():
        splats = project(fields, cam, time, dtype)
        bsplats = splats if bin_cam is None else project(fields, bin_cam, bin_time, dtype)
        bins = splat.bin_pairs(bsplats, width, height, p_max)
        if chunk is None:
            chunk = splat.chunk_for(splat.serving_budget(splats["mask"].shape[0], bins["pairs"]),
                                    bins["tx_count"] * bins["ty_count"])
        img = render_bins(splats["params"], bins, width, height, chunk, counts=counts)
        if counts is not None:
            counts["visible"] = counts.get("visible", 0) + int(splats["mask"].sum())
            counts["tiles"] = counts.get("tiles", 0) + bins["tx_count"] * bins["ty_count"]
    return img, bins
