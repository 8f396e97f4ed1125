"""PyTorch port, 2DGS trained with its published objective (Huang et al.,
SIGGRAPH 2024, section 4.2): the surface maps that the compositor writes
beside the colour under ``render_tiled(..., aux_near=...)``, their
hand-derived backward and ``train_step(..., surface_loss=...)``, on the CPU
against the plain reference ``benchmark/reference/train_2d.py`` (plain
PyTorch, no code of the port):

  - the twin's normal, depth, median depth and distortion maps against the
    reference's, within 1e-5 of each map's norm;
  - the distortion against the brute-force double sum over fragment pairs
    sum_{j<i} w_i w_j (m_i - m_j)^2 of the mapped depth m, in float64, at
    the pixels where it is largest;
  - the gradient of the whole objective L_c + 1000 L_d + 0.05 L_n in every
    field against the reference's autograd, within 1e-3 of its largest;
  - the colour and alpha bitwise the same with the maps on and off;
  - five Adam steps against the reference's.

On the card (``cuda``): the kernels' maps, totals and per-pair gradients
against their plain twins, up to 1M surfels at 512x512, and the 23-column
reduce bitwise against its twin.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import splat, splat_2d, train_2d
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud, random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import reduce as red
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_bwd as tb
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf
from bevy_gaussian_splatting_tpu_torch.ops.cuda.project import project_splats
from bevy_gaussian_splatting_tpu_torch.train.losses import SurfaceLoss, gaussian_splatting_loss
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step

S2D = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)
FIELDS = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")
MAP_BAR = 1e-5  # of each map's norm
GRAD_BAR = 1e-3  # of each field's largest |reference|
EYE = (4.0, 3.0, 14.0)
# (surfels, width, height): 40 is off the 16-grid
CASES = [(160, 32, 32), (256, 64, 40)]
IDS = [f"{n}-{w}x{h}" for n, w, h in CASES]


def _scene(n: int, seed: int = 5) -> dict:
    a = random_arrays_3d_seeded(n, seed=seed)
    a["scale_opacity"] = a["scale_opacity"] * np.array([0.3, 0.3, 0.3, 1], np.float32)
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _cams(width: int, height: int, device="cpu"):
    view, proj = splat.look_at_np(EYE), splat.perspective_np(width, height)
    return (Camera.from_matrices(view, proj, width, height, device=device),
            splat.host_camera(view, proj, width, height, device))


def _chunk(n, width, height):
    return splat.chunk_for(splat.pair_cap(n), (width // 16) * (-(-height // 16)))


def _rel(got, want) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_maps_match_the_reference(case):
    n, width, height = case
    fields = _scene(n)
    cam, rcam = _cams(width, height)
    with torch.no_grad():
        img, aux = rt.render_tiled(Gaussian3dCloud(**fields), cam, S2D, aux_near=tf.AUX_NEAR)
        plain = rt.render_tiled(Gaussian3dCloud(**fields), cam, S2D)
    rimg, ralpha, rmaps = train_2d.render_maps(fields, rcam, _chunk(n, width, height))
    # the colour and alpha are the serving branch's, bit for bit
    assert torch.equal(img, plain)
    assert _rel(img, rimg) <= MAP_BAR and _rel(aux["alpha"], ralpha) <= MAP_BAR
    for key in ("normal", "depth", "distortion", "median"):
        assert float(rmaps[key].abs().max()) > 0, key
        assert _rel(aux[key], rmaps[key]) <= MAP_BAR, (key, _rel(aux[key], rmaps[key]))


def _brute_distortion(fields, rcam, chunk, pixels):
    """sum_{j<i} w_i w_j (m_i - m_j)^2 at ``pixels`` (row, col), in float64,
    fragment by fragment in the tile's order (one chunk: no early exit)."""
    width, height = rcam["width"], rcam["height"]
    f64 = {k: v.double() for k, v in fields.items()}
    splats = splat_2d.project(f64, rcam, None, torch.float64)
    surf = torch.cat(train_2d.surface_columns(f64, rcam, torch.float64), dim=-1)
    bins = splat.bin_pairs({k: v for k, v in splats.items() if k != "params"}, width, height)
    tx = bins["tx_count"]
    near, far = train_2d.NEAR, train_2d.FAR
    out = []
    for row, col in pixels:
        t = (row // 16) * tx + col // 16
        start, count = int(bins["start"][t]), int(bins["count"][t])
        assert (start % 128) + count <= chunk  # one chunk
        px, py = splat_2d._ndc_coords(torch.tensor([t]), tx, width, height, torch.float64)
        k = (row % 16) * 16 + col % 16
        g_idx = bins["g"][start:start + count]
        q, s = splats["params"][g_idx], surf[g_idx]
        g, inside, dxn, dyn = train_2d._falloff(q[None], px[:, None, k:k + 1], py[:, None, k:k + 1], width, height)
        alpha = torch.where(inside, torch.clamp(g * q[None, :, 15:16], max=0.999), 0.0)[0, :, 0]
        z = s[:, 0] / ((dxn[0, :, 0] * s[:, 1] + dyn[0, :, 0] * s[:, 2]) + s[:, 3])
        trans, frags = 1.0, []
        for i in range(count):
            w = float(alpha[i]) * trans
            if float(alpha[i]) >= train_2d.ALPHA_MIN and float(z[i]) >= near:
                frags.append((w, far / (far - near) * (1.0 - near / float(z[i]))))
            trans *= 1.0 - float(alpha[i])
        out.append(sum(wi * wj * (mi - mj) ** 2 for i, (wi, mi) in enumerate(frags) for wj, mj in frags[:i]))
    return np.array(out)


def test_distortion_is_the_pairwise_sum():
    n, width, height = 200, 64, 48
    fields = _scene(n)
    cam, rcam = _cams(width, height)
    with torch.no_grad():
        _, aux = rt.render_tiled(Gaussian3dCloud(**fields), cam, S2D, aux_near=tf.AUX_NEAR)
    near, far = train_2d.NEAR, train_2d.FAR
    got = aux["distortion"].double() * (near * far / (far - near)) ** 2
    flat = torch.argsort(got.flatten(), descending=True)[:6]
    pixels = [(int(i) // width, int(i) % width) for i in flat]
    want = _brute_distortion(fields, rcam, _chunk(n, width, height), pixels)
    have = np.array([float(got[r, c]) for r, c in pixels])
    assert (want > 0).all()
    rel = np.abs(have - want) / want
    print(f"\n[distortion] brute-force sums {want}, relative gaps {rel}")
    assert (rel <= 1e-4).all(), rel


# (photometric weight, lambda_dist, lambda_normal, depth_ratio): the published
# objective, each geometric term alone (the distortion's weight brings it to
# the photometric loss's scale), and the expected depth as the surface
OBJECTIVES = {
    "published": (1.0, 1000.0, 0.05, 1.0),
    "distortion": (0.0, 1e6, 0.0, 1.0),
    "normal": (0.0, 0.0, 1.0, 1.0),
    "expected-depth": (1.0, 1000.0, 0.05, 0.0),
}


def _port_objective(fields, cam, target, weights):
    w_c, l_d, l_n, ratio = weights
    model = TrainableCloud(Gaussian3dCloud(**fields))
    img, aux = rt.render_tiled(model.cloud(), cam, S2D, aux_near=tf.AUX_NEAR)
    loss = w_c * gaussian_splatting_loss(img, target) + SurfaceLoss(l_d, l_n, ratio)(aux, cam)
    loss.backward()
    return float(loss.detach()), {f: getattr(model, f).grad for f in FIELDS}


@pytest.mark.parametrize("objective", list(OBJECTIVES))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_objective_gradients_match_the_reference(case, objective):
    n, width, height = case
    weights = OBJECTIVES[objective]
    fields = _scene(n)
    cam, rcam = _cams(width, height)
    target = train_2d.render_maps(_scene(n, seed=6), rcam, _chunk(n, width, height))[0]
    loss, grads = _port_objective(fields, cam, target, weights)
    w_c, l_d, l_n, ratio = weights

    def photometric(img, tgt):
        return w_c * train_2d.ref_train.splatting_loss(img, tgt)

    r_loss, r_grads, _ = train_2d.loss_and_grads(fields, rcam, target, _chunk(n, width, height), lambda_dist=l_d,
                                                 lambda_normal=l_n, depth_ratio=ratio, photometric=photometric)
    assert abs(loss - r_loss) <= 1e-5 * r_loss
    assert float(r_grads["position_visibility"].abs().max()) > 0
    for f in FIELDS:
        scale = float(r_grads[f].abs().max())
        if scale == 0.0:  # the colour, under the geometric terms alone
            assert f == "spherical_harmonic" and w_c == 0.0 and not grads[f].any()
            continue
        gap = float((grads[f] - r_grads[f]).abs().max()) / scale
        print(f"[{objective}] {f} gap {gap:.2e}")
        assert gap <= GRAD_BAR, (f, gap)
    # the surfel is flat: scale z enters nowhere
    assert not grads["scale_opacity"][:, 2].any()


def test_adam_steps_match_the_reference():
    n, width, height, lr, steps = 200, 64, 48, 0.01, 5
    fields = _scene(n)
    cam, rcam = _cams(width, height)
    chunk = _chunk(n, width, height)
    target = train_2d.render_maps(_scene(n, seed=6), rcam, chunk)[0]
    model = TrainableCloud(Gaussian3dCloud(**fields))
    opt = adam(model, lr)
    got = [float(train_step(model, opt, cam, target, S2D, gaussian_splatting_loss, surface_loss=SurfaceLoss()))
           for _ in range(steps)]
    cur = dict(fields)
    ref_adam = train_2d.Adam(cur, lr)
    want = []
    for _ in range(steps):
        loss, grads, _ = train_2d.loss_and_grads(cur, rcam, target, chunk)
        want.append(loss)
        cur = ref_adam.step(cur, grads)
    drift = np.abs(np.array(got) / np.array(want) - 1.0)
    print(f"\n[2DGS objective, Adam lr {lr}] losses {got}, relative drift {drift.tolist()}")
    assert (drift <= 1e-4).all()
    assert got[-1] < got[0]
    for f in FIELDS:
        assert _rel(getattr(model, f).detach(), cur[f]) <= 1e-4, f


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_rows(n, width, height, dev):
    """A seeded bench-like scene's 23-column rows, binned, on ``dev``."""
    from benchmark import scenes
    from benchmark.run import load_json, BENCH

    scene = scenes.make_scene(load_json(BENCH / "configs" / "gs2d-1m.json"), 11, dev, n)
    view, proj = splat.look_at_np((0.0, 0.0, 60.0) if n > 100_000 else (0.0, 0.0, 40.0)), splat.perspective_np(
        width, height)
    cam = Camera.from_matrices(view, proj, width, height, device=dev)
    splats = project_splats(Gaussian3dCloud(**scene), cam, S2D, surface=True)
    p_max = rt.pairs_budget(n)
    bins = rt.tile_bins(splats, width, height, p_max)
    rows = splats["params"][bins.g_s].contiguous()
    chunk = tf.preferred_chunk(p_max, bins.start.shape[0])
    return rows, bins, chunk


CARD_CASES = [(20_000, 128, 120), (1_000_000, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[f"{n}-{w}x{h}" for n, w, h in CARD_CASES])
def test_card_maps_and_gradients_match_their_twins(case):
    dev = _card()
    n, width, height = case
    rows, bins, chunk = _card_rows(n, width, height, dev)
    args = (rows, bins.start, bins.count, width // 16, width, height)
    kw = dict(chunk=chunk, mode=tf.MODE_2D, aux_near=tf.AUX_NEAR)
    raw, maps, totals = tf.composite_tiles_raw(*args, **kw)
    p_raw, p_maps, p_totals = tf.composite_tiles_raw_plain(*args, chunk=chunk, mode=tf.MODE_2D, aux_near=tf.AUX_NEAR)
    # the colour is the serving instantiation's, bit for bit
    serve = tf.composite_tiles_raw(rows[:, :16].contiguous(), *args[1:], chunk=chunk, mode=tf.MODE_2D)
    assert torch.equal(raw, serve)
    assert float((raw - p_raw).abs().max()) <= 1e-4
    for k, bar in ((0, 1e-4), (1, 1e-4), (2, 1e-4), (3, 1e-4), (4, 1e-3)):
        assert _rel(maps[:, k], p_maps[:, k]) <= bar, (k, _rel(maps[:, k], p_maps[:, k]))
    # the median: the same fragment but where T meets 0.5 within rounding
    assert float((maps[:, 5] != p_maps[:, 5]).float().mean()) <= 1e-4
    assert float((totals[:, 3] != p_totals[:, 3]).float().mean()) <= 1e-4
    g = torch.Generator(device=dev).manual_seed(3)
    grad_raw = torch.randn(raw.shape, generator=g, device=dev) * 1e-3
    grad_maps = torch.randn(maps.shape, generator=g, device=dev) * 1e-3
    gbar = tb.pack_gbar(grad_raw, raw)
    gaux = tb.pack_surface_gbar(grad_maps, maps, totals)
    bargs = (rows, bins.start, bins.count, gbar, width // 16, width, height)
    got = tb.composite_backward(*bargs, chunk=chunk, mode=tf.MODE_2D, gaux=gaux, aux_near=tf.AUX_NEAR)
    want = tb.composite_backward_plain(*bargs, chunk=chunk, mode=tf.MODE_2D, gaux=gaux, aux_near=tf.AUX_NEAR)
    assert got.shape == want.shape == (rows.shape[0], 23)
    assert not got[:, 2].any() and not want[:, 2].any()
    live = [c for c in range(23) if c != 2]
    scale = want[:, live].abs().amax(dim=0)
    assert bool((scale > 0).all())
    gap = (got[:, live] - want[:, live]).abs().amax(dim=0) / scale
    print(f"\n[{n} {width}x{height}] surface backward, kernel vs twin per column / max: {float(gap.max()):.3e}")
    assert bool((gap <= 1e-3).all()), gap
    # the 23-column reduce, bitwise its twin
    dslot = torch.empty_like(got)
    dslot[bins.order] = got
    assert torch.equal(red.segment_reduce(dslot, bins.cum, bins.perm.shape[0]),
                       red.segment_reduce_plain(dslot, bins.cum, bins.perm.shape[0]))
