"""The plain reference of a 2DGS training step as Huang et al. train it: the
surfel image and its surface maps, ``L_c + alpha L_d + beta L_n``, the
gradients by autograd, and Adam.

Plain PyTorch in float32 with TF32 off, imported by nothing of the program
and importing nothing of it.  From ``benchmark/reference/splat_2d.py`` it
takes the surfel projection (the packed rows), from ``splat.py`` the
binning, the chunk grid and the tile layout, from ``train.py`` the
photometric loss (0.8 L1 + 0.2 D-SSIM) and Adam.  The rest is written here
from the surfel equations of *2D Gaussian Splatting for Geometrically
Accurate Radiance Fields* (SIGGRAPH 2024, arXiv:2403.17888), section 4,
and the official rasteriser (``hbb1/diff-surfel-rasterization``
``forward.cu`` ``renderCUDA`` with ``RENDER_AXUTILITY``) and trainer
(``hbb1/2d-gaussian-splatting`` ``train.py``, ``utils/point_utils.py``):

  - per fragment i of a pixel, front to back: w_i = alpha_i T_i; z_i =
    (u_i, v_i, 1) . c_i, the depth of the ray-plane intersection, with (u_i,
    v_i) = (q.x, q.y) / q.z the intersection in the surfel's plane that the
    falloff computes and c_i the homography's column 2 (the official
    ``Tw``); n_i the surfel's unit normal, the rotation's third axis in view
    space, negated where it faces away from the camera;
  - the maps: N = sum w n, D = sum w z, the median depth (the z of the last
    fragment whose incoming T is above 0.5) and the distortion sum_{j<i} w_i
    w_j (m_i - m_j)^2 with m = f / (f - n) (1 - n / z), n = 0.2, f = 100;
  - L_d and L_n the means over pixels of the distortion and of 1 - N . N_d,
    N_d the normal of the surface depth (1 - r) D / A + r median
    back-projected (central differences, the one-pixel border zero) times
    the detached alpha A.

Departures from the paper, each the official code's or the program's
renderer's, and held the same here:

  - the distortion is the official code's squared form; the paper writes
    |m_i - m_j|;
  - it is accumulated over inverse depth: m_i - m_j = n f / (f - n) (1/z_j -
    1/z_i), so the distortion of m is (n f / (f - n))^2 times that of 1/z, as
    a running sum w_i (z_i^-2 A_{<i} + M2_{<i} - 2 z_i^-1 M1_{<i}) with
    A_{<i} the sum of the earlier weights (the official ``1 - T``), M1, M2
    the sums of w / z and w / z^2; equal in exact arithmetic to the m form,
    without subtracting terms near 1 in float32;
  - a fragment enters the maps where its alpha is at least 1/255 and its
    depth at least n, as the official rasteriser's fragments do, but every
    fragment stays in the colour: the program's renderer blends all of them
    (no per-fragment skip, no per-pixel early exit);
  - the renderer's surfel quirks (``splat_2d.py``, ``ops/gaussian_2d.py`` of
    the program): the doubled, y-flipped fragment frame, the folded plane
    intersection q = dxn A + dyn B + C, the clamp of q.z to 1e-12 that drops
    its sign, and the quaternion taken unnormalised, so that the normal,
    normalised here, is the rotation matrix's third row and not the cross
    product of the tangent axes;
  - normals and back-projected points are in view space (N . N_d is the
    official world-space product: one rotation of both);
  - the depth (u, v, 1) . c is evaluated as det T0 / q0.z, the same
    number: c . q = det T (c . (b x c) = c . (c x a) = 0), and scaling T's
    rows by the scales scales det T and q.z alike, so T0 is the homography
    with both scales 1.  Evaluated as the product, the depth's gradient in
    the scales is a difference of terms of z / s each, rounding noise that
    outgrows a small surfel's true gradient; the scales now enter only
    through the centre of the renderer's fragment frame.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import splat, splat_2d
from benchmark.reference import train as ref_train
from benchmark.reference.splat import ALPHA_CAP, CHUNK_ALIGN, PIX, TRANS_EPS

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEAR, FAR = 0.2, 100.0  # the official rasteriser's near_n, far_n
ALPHA_MIN = float(np.float32(1.0 / 255.0))  # the official rasteriser's least fragment alpha
MEDIAN_T = 0.5
DEPTH_EPS = 1e-6  # the least |q0.z| of a fragment's depth (not sign-preserving)


def surface_columns(fields: dict, cam: dict, dtype=torch.float32):
    """Per surfel, a fragment's depth coefficients [N, 4], (det T0, A0.z,
    B0.z, C0.z) of the homography with both scales 1 folded about the
    centre (a fragment's depth is det T0 / (dxn A0.z + dyn B0.z + C0.z)),
    and the camera-facing unit normal in view space [N, 3].  The centre is
    ``splat_2d.project``'s, from the homography with the scales."""
    f = {k: v.to(dtype) for k, v in fields.items()}
    view, proj = cam["view"].to(dtype), cam["proj"].to(dtype)
    clip = proj @ view
    pos = f["position_visibility"][:, :3]
    so = f["scale_opacity"]
    r, x, y, z = (f["rotation"][..., i] for i in range(4))
    rows = (
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y + r * z), 2.0 * (x * z - r * y)),
        (2.0 * (x * y - r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z + r * x)),
        (2.0 * (x * z + r * y), 2.0 * (y * z - r * x), 1.0 - 2.0 * (x * x + y * y)),
    )
    ks = splat_2d.intrinsics(proj, cam["width"], cam["height"])
    m = sum(clip[i][:, None] * ks[i] for i in range(4))  # [4, 3]
    t2 = [sum(pos[:, k] * m[k, j] for k in range(3)) + m[3, j] for j in range(3)]
    # the centre, as splat_2d.project finds it from the homography T
    s = (so[:, 0] * 1.0, so[:, 1] * 1.0)
    L = [[rows[j][i] * s[j] for j in range(2)] for i in range(3)]
    T = [[splat_2d._sum3(L[0][a] * m[0, j], L[1][a] * m[1, j], L[2][a] * m[2, j]) for j in range(3)] for a in range(2)]
    T.append(t2)
    cutoff = torch.sqrt(torch.clamp(9.0 + 2.0 * torch.log(torch.clamp(so[:, 3], min=1e-8)), min=1e-6))
    cut2 = cutoff * cutoff
    d = splat_2d._sum3(cut2 * T[0][2] * T[0][2], cut2 * T[1][2] * T[1][2], -1.0 * T[2][2] * T[2][2])
    d_safe = torch.where(d.abs() >= splat_2d.VALID_EPS, d, torch.ones_like(d))
    fc, fz = cut2 / d_safe, -1.0 / d_safe
    mean = [splat_2d._sum3(fc * T[0][k] * T[0][2], fc * T[1][k] * T[1][2], fz * T[2][k] * T[2][2]) for k in range(2)]
    # T0: the rows u0, u1 (the tangent axes, both scales 1) and t2; det T0 =
    # t2 . (u0 x u1), and the z components of its columns' b x c, c x a and
    # a x b are those of u0 x u1.  The depth is a quotient of sums that
    # cancel at a ray nearly in the plane: it is evaluated in the program's
    # operations (batched products, one cross product), which any other
    # order of the same sums would move by more than rounding there
    axes = torch.stack([torch.stack(rows[j], dim=-1) for j in range(2)], dim=-2)  # [N, 2, 3]
    u = axes @ m[:3]
    uxu = torch.linalg.cross(u[:, 0], u[:, 1], dim=-1)
    det = torch.sum(torch.stack(t2, dim=-1) * uxu, dim=-1)
    wf = float(cam["width"])
    depth = torch.stack([det, wf * uxu[:, 0], wf * uxu[:, 1], (mean[0] * uxu[:, 0] + mean[1] * uxu[:, 1]) + uxu[:, 2]],
                        dim=-1)
    axis = torch.stack(rows[2], dim=-1)
    n = axis @ view[:3, :3].T
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    p_view = pos @ view[:3, :3].T + view[:3, 3]
    n = torch.where(torch.sum(n * p_view, dim=-1, keepdim=True) > 0.0, -n, n)
    return depth, n


def _falloff(q, px, py, width: int, height: int):
    """``splat_2d.falloff`` that also returns the pixel's offsets (dxn,
    dyn) from the centre."""
    inv_w, inv_h = float(np.float32(1.0 / width)), float(np.float32(1.0 / height))
    two_w2 = float(np.float32(2.0 * width * width))
    dxn = px - q[..., 0:1]
    dyn = py - q[..., 1:2]
    mr = q[..., 2:3]
    inside = (dxn.abs() <= mr * inv_w) & (dyn.abs() <= mr * inv_h)
    qx, qy, qz = (dxn * q[..., 3 + k : 4 + k] + dyn * q[..., 6 + k : 7 + k] + q[..., 9 + k : 10 + k] for k in range(3))
    inv_pz = 1.0 / torch.where(qz.abs() > splat_2d.PZ_EPS, qz, torch.full_like(qz, splat_2d.PZ_EPS))
    us = qx * inv_pz
    vs = qy * inv_pz
    d2x2 = (dxn * dxn + dyn * dyn) * two_w2
    g = torch.where(inside, torch.exp(-0.5 * torch.minimum(us * us + vs * vs, d2x2)), 0.0)
    return g, inside, dxn, dyn


def composite_tiles(params, surf, bins: dict, width: int, height: int, chunk: int, tids, near: float = NEAR,
                    counts: dict | None = None):
    """Composite tiles ``tids`` with the surface maps -> (accum [B, 3, 256],
    trans [B, 256], maps [B, 6, 256]: N.xyz, D, the distortion of 1 / z, the
    median depth), differentiable in ``params`` [N, 16] and ``surf`` [N, 7]
    (the depth's coefficients, n), on ``splat.composite_tiles``'s chunk grid.  ``counts``, if
    given, gains the pairs walked before the early exit (``walked``), the
    (pair, pixel) evaluations inside a surfel's square (``inside``) and the
    fragments among them that enter the maps (``frags``)."""
    dev, dtype = params.device, params.dtype
    start = bins["start"][tids]
    base = start // CHUNK_ALIGN * CHUNK_ALIGN
    prefix = start - base
    total = bins["count"][tids] + prefix
    n_chunks = (total + chunk - 1) // chunk
    px, py = splat_2d._ndc_coords(tids, bins["tx_count"], width, height, dtype)
    px, py = px[:, None, :], py[:, None, :]
    g_pairs = bins["g"]
    n_pairs = g_pairs.shape[0]
    b = tids.shape[0]
    trans = torch.ones((b, PIX), dtype=dtype, device=dev)
    accum = torch.zeros((b, 3, PIX), dtype=dtype, device=dev)
    normal = torch.zeros((b, 3, PIX), dtype=dtype, device=dev)
    depth = torch.zeros((b, PIX), dtype=dtype, device=dev)
    dist = torch.zeros((b, PIX), dtype=dtype, device=dev)
    median = torch.zeros((b, PIX), dtype=dtype, device=dev)
    a_run = torch.zeros((b, PIX), dtype=dtype, device=dev)
    m1_run = torch.zeros((b, PIX), dtype=dtype, device=dev)
    m2_run = torch.zeros((b, PIX), dtype=dtype, device=dev)
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
        keep = in_rng[..., None].to(dtype)
        q = params[g_pairs[pidx]] * keep  # [B, L, 16]
        s = surf[g_pairs[pidx]] * keep  # [B, L, 7]
        g, inside, dxn, dyn = _falloff(q, px, py, width, height)
        inside = inside & in_rng[..., None]
        alpha = torch.where(inside, torch.clamp(g * q[..., 15:16], max=ALPHA_CAP), 0.0)
        cum = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        t_i = excl * trans[:, None, :]
        w = alpha * t_i
        accum = accum + torch.stack([torch.sum(w * q[..., 12 + ch : 13 + ch], dim=1) for ch in range(3)], dim=1)
        # the fragments of the maps
        q0z = (dxn * s[..., 1:2] + dyn * s[..., 2:3]) + s[..., 3:4]
        z = s[..., 0:1] * (1.0 / torch.where(q0z.abs() > DEPTH_EPS, q0z, torch.full_like(q0z, DEPTH_EPS)))
        frag = (alpha >= ALPHA_MIN) & (z >= near)
        if counts is not None:
            counts["walked"] += int(in_rng.sum())
            counts["inside"] += int(inside.sum())
            counts["frags"] += int(frag.sum())
        we = torch.where(frag, w, 0.0)
        inv_z = torch.where(frag, 1.0 / torch.where(frag, z, 1.0), 0.0)
        normal = normal + torch.stack([torch.sum(we * s[..., 4 + k : 5 + k], dim=1) for k in range(3)], dim=1)
        depth = depth + torch.sum(we * z, dim=1)

        def before(run, v):
            cs = torch.cumsum(v, dim=1)
            return run[:, None, :] + torch.cat([torch.zeros_like(cs[:, :1]), cs[:, :-1]], dim=1)

        wz = we * inv_z
        a_b, m1_b, m2_b = before(a_run, we), before(m1_run, wz), before(m2_run, wz * inv_z)
        dist = dist + torch.sum(we * ((inv_z * inv_z) * a_b + m2_b - 2.0 * inv_z * m1_b), dim=1)
        a_run = a_run + torch.sum(we, dim=1)
        m1_run = m1_run + torch.sum(wz, dim=1)
        m2_run = m2_run + torch.sum(wz * inv_z, dim=1)
        lanes = torch.arange(alpha.shape[1], device=dev)[None, :, None]
        last = torch.where(frag & (t_i > MEDIAN_T), lanes, -1).amax(dim=1)
        picked = torch.gather(z, 1, last.clamp(min=0)[:, None, :])[:, 0]
        median = torch.where(last >= 0, picked, median)
        trans = trans * cum[:, -1]
    maps = torch.cat([normal, depth[:, None], dist[:, None], median[:, None]], dim=1)
    return accum, trans, maps


def geometry_terms(alpha, maps: dict, cam: dict, depth_ratio: float = 1.0, near: float = NEAR, far: float = FAR):
    """(L_d, L_n) of one image's maps ([H, W] each, ``normal`` [H, W, 3])."""
    h, w = alpha.shape
    dev, dtype = alpha.device, alpha.dtype
    # D / A, 0 where A is (the official nan_to_num), with a gradient that
    # stays finite there
    covered = alpha > 0.0
    expected = torch.where(covered, maps["depth"] / torch.where(covered, alpha, 1.0), 0.0)
    surface = (1.0 - depth_ratio) * expected + depth_ratio * maps["median"]
    proj = cam["proj"].to(dtype)
    x = (torch.arange(w, device=dev, dtype=dtype) + 0.5) * (2.0 / w) - 1.0
    y = 1.0 - (torch.arange(h, device=dev, dtype=dtype) + 0.5) * (2.0 / h)
    # a perspective projection (clip w = -view z): the point at clip w d of
    # the pixel's ray
    rx = (x + proj[0, 2]) / proj[0, 0]
    ry = (y + proj[1, 2]) / proj[1, 1]
    pts = torch.stack([rx[None, :] * surface, ry[:, None] * surface, -surface], dim=-1)
    down = pts[2:, 1:-1] - pts[:-2, 1:-1]
    across = pts[1:-1, 2:] - pts[1:-1, :-2]
    nd = torch.zeros_like(pts)
    nd[1:-1, 1:-1] = F.normalize(torch.linalg.cross(down, across, dim=-1), dim=-1)
    nd = nd * alpha.detach()[..., None]
    normal_loss = torch.mean(1.0 - torch.sum(maps["normal"] * nd, dim=-1))
    dist_loss = (near * far / (far - near)) ** 2 * torch.mean(maps["distortion"])
    return dist_loss, normal_loss


def _maps_image(alpha_tiles, maps_tiles, bins, height):
    """Tiles [T, 256] and [T, 6, 256] -> the image's alpha [H, W] and maps."""
    tx, ty = bins["tx_count"], bins["ty_count"]
    rows = torch.cat([alpha_tiles[:, None], maps_tiles], dim=1)  # [T, 7, 256]
    img = rows.transpose(1, 2).reshape(ty, tx, splat.TILE, splat.TILE, 7).permute(0, 2, 1, 3, 4)
    img = img.reshape(ty * splat.TILE, tx * splat.TILE, 7)[:height]
    return img[..., 0], {"normal": img[..., 1:4], "depth": img[..., 4], "distortion": img[..., 5],
                         "median": img[..., 6]}


def render_maps(fields: dict, cam: dict, chunk: int, batch: int = 32, dtype=torch.float32, counts=None):
    """The image [H, W, 4] (zero background), its alpha and maps, without a
    graph.  ``counts``, if given, gains :func:`composite_tiles`'s counts and
    the frame's ``visible`` surfels and ``tiles``."""
    with torch.no_grad():
        splats = splat_2d.project(fields, cam, None, dtype)
        surf = torch.cat(surface_columns(fields, cam, dtype), dim=-1)
        bins = splat.bin_pairs({k: v for k, v in splats.items() if k != "params"}, cam["width"], cam["height"])
        if counts is not None:
            counts["visible"] = counts.get("visible", 0) + int(splats["mask"].sum())
            counts["tiles"] = counts.get("tiles", 0) + bins["tx_count"] * bins["ty_count"]
        return _render(splats["params"], surf, bins, cam, chunk, batch, counts)


def _render(params, surf, bins, cam, chunk, batch, counts=None, near: float = NEAR):
    width, height = cam["width"], cam["height"]
    num_tiles = bins["tx_count"] * bins["ty_count"]
    accs, trs, mps = [], [], []
    for b0 in range(0, num_tiles, batch):
        tids = torch.arange(b0, min(b0 + batch, num_tiles), device=params.device)
        a, t, m = composite_tiles(params, surf, bins, width, height, chunk, tids, near, counts)
        accs.append(a)
        trs.append(t)
        mps.append(m)
    accum, trans, maps = torch.cat(accs), torch.cat(trs), torch.cat(mps)
    img = splat.tiles_to_image(accum, trans, bins["tx_count"], bins["ty_count"], height)
    alpha, mp = _maps_image(1.0 - trans, maps, bins, height)
    return img, alpha, mp


def loss_and_grads(fields: dict, cam: dict, target: torch.Tensor, chunk: int = 512, dtype=torch.float32,
                   batch: int = 32, lambda_dist: float = 1000.0, lambda_normal: float = 0.05,
                   depth_ratio: float = 1.0, near: float = NEAR, far: float = FAR, photometric=None, terms=None):
    """The objective ``L_c + lambda_dist L_d + lambda_normal L_n`` of
    rendering ``fields`` through ``cam`` against ``target`` and its gradient
    in every field -> (loss float, {field: grad}, (L_d, L_n) floats).
    ``photometric`` replaces the 3DGS loss and ``terms`` :func:`geometry_terms`
    (the planted faults of the controls).

    The image's and the maps' gradients reach the surfels tile batch by tile
    batch, as ``train.loss_and_grads`` does it: composited once without a
    graph, the loss's gradient taken at the image and the maps, each batch
    composited again under autograd with its share of that gradient."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in fields.items()}
    width, height = cam["width"], cam["height"]
    splats = splat_2d.project(leaves, cam, None, dtype)
    surf = torch.cat(surface_columns(leaves, cam, dtype), dim=-1)
    bins = splat.bin_pairs({k: v.detach() for k, v in splats.items() if k != "params"}, width, height)
    params = splats["params"]
    p_det = params.detach().requires_grad_(True)
    s_det = surf.detach().requires_grad_(True)
    with torch.no_grad():
        img, alpha, maps = _render(p_det, s_det, bins, cam, chunk, batch, near=near)
    img_leaf = img.detach().requires_grad_(True)
    alpha_leaf = alpha.detach().requires_grad_(True)
    map_leaves = {k: v.detach().requires_grad_(True) for k, v in maps.items()}
    l_c = (photometric or ref_train.splatting_loss)(img_leaf, target.to(dtype))
    l_d, l_n = (terms or geometry_terms)(alpha_leaf, map_leaves, cam, depth_ratio, near, far)
    loss = l_c + lambda_dist * l_d + lambda_normal * l_n
    loss.backward()
    tx, ty = bins["tx_count"], bins["ty_count"]
    d_img = splat.image_to_tiles(img_leaf.grad, tx, ty)  # [T, 4, 256]
    grads_maps = [alpha_leaf.grad[..., None], map_leaves["normal"].grad] + [
        map_leaves[k].grad[..., None] for k in ("depth", "distortion", "median")
    ]
    d_maps = splat.image_to_tiles(torch.cat(grads_maps, dim=-1), tx, ty)  # [T, 7, 256]
    num_tiles = d_img.shape[0]
    for b0 in range(0, num_tiles, batch):
        tids = torch.arange(b0, min(b0 + batch, num_tiles), device=params.device)
        accum, trans, mp = composite_tiles(p_det, s_det, bins, width, height, chunk, tids, near)
        d, dm = d_img[tids], d_maps[tids]
        # image rgb = accum, image alpha and the alpha map = 1 - trans
        part = torch.sum(accum * d[:, :3]) - torch.sum(trans * (d[:, 3] + dm[:, 0])) + torch.sum(mp * dm[:, 1:])
        if part.requires_grad:
            part.backward()
    outs = [t for t, g in ((params, p_det.grad), (surf, s_det.grad)) if g is not None]
    if outs:
        torch.autograd.backward(outs, [g for g in (p_det.grad, s_det.grad) if g is not None])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).float() for k, v in leaves.items()}
    return float(loss.detach()), grads, (float(l_d.detach()), float(l_n.detach()))


EDGE_ON_COS = 1e-2


def well_conditioned(fields: dict, cam: dict):
    """Surfels whose gradient is more than float32 rounding noise: those not
    seen nearly edge-on, |n . ray| >= ``EDGE_ON_COS`` with n the unit normal
    and ray the unit direction from the camera to the centre.  Seen nearly
    edge-on, the plane intersection's folded coefficients A and B are small
    differences, and one ulp of them moves the gradient by up to a tenth of a
    field's largest (``ops/gaussian_2d.py`` of the program), in any
    evaluation order."""
    with torch.no_grad():
        view = cam["view"].float()
        p_view = fields["position_visibility"][:, :3].float() @ view[:3, :3].T + view[:3, 3]
        ray = p_view / torch.clamp(torch.linalg.norm(p_view, dim=-1, keepdim=True), min=1e-12)
        _, n = surface_columns(fields, cam)
        return torch.sum(n * ray, dim=-1).abs() >= EDGE_ON_COS


Adam = ref_train.Adam
