"""The compositors' per-warp cull on the CPU.

csrc/tile_fwd.cu and csrc/tile_bwd.cu walk a pair only in the warps of its
mask (csrc/cull.cuh); the twin of that mask is ``ops/cuda/cull.py``
``warp_masks``, written with the kernels' float32 operations in their order
(tests/test_torch_cuda.py ties the two on the card: a row whose twin mask is
empty gets no gradient from the backward, and the culled forward matches its
plain version).  The cull is exact only if every (pair, warp) it leaves out
has no pixel inside the splat, so g is exactly 0 there, and no pixel of the
overlay's edge band: checked here with ``splat_falloff(..., with_edge=True)``
(the kernels' falloff and edge) at every pixel of every left-out 4x8-pixel
warp, in OBB, AABB and 2DGS, on

  - the tiles of the bench scene (small splats) and of the wide scene
    (large splats spanning many tiles) at 128x128, at the non-16 height
    128x120 and in a band (``y0`` = 16 of a 136-row frame);
  - adversarial rows (tests/torch_port_cases.py ``adversarial_rows`` and
    ``special_rows``, two seeds): extents snapped to a pixel's offset and
    moved by -2 ... 2 ulps (|u| or |v| at 1 +- 1 ulp; a splat just inside
    or just outside a warp strip; a 2DGS square on a warp boundary), b1 <=
    0, b2 <= 0, r = 0, a zero OBB axis, and splats that cover the whole
    tile.

The forward's claim, that skipping a left-out (pair, warp) changes no bit
of the image or of the exit vote, is checked end to end on the plain
version: ``composite_tiles_raw_plain`` with alpha forced to exactly 0 (and
the edge to false) at every pixel of every left-out (pair, warp) gives the
same raw image, bit for bit, in all six (mode, overlay) instantiations.  A
row whose alpha or colour is not finite keeps every warp (0 * inf is not
0).

``-s`` prints the share of (pair, warp) visits the cull keeps beside the
share that reaches a pixel.  The file imports neither JAX nor the JAX
package.
"""

import numpy as np
import pytest
import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import cull
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf
from torch_port_cases import MODE, adversarial_rows, cloud_arrays, special_rows

SETTINGS = {
    "obb": CloudSettings(),
    "aabb": CloudSettings(aabb=True),
    "2d": CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D),
}


def _check(params, tile_start, tile_count, tx_count, width, full_height, y0, mode):
    """Assert the cull is sound: no left-out (pair, warp) has a pixel inside
    the splat, a nonzero g or an edge pixel ->
    (masks of the pairs [N] int64, kept share, exact share)."""
    kmode = MODE[mode]
    masks = cull.warp_masks(params, tile_start, tile_count, tx_count, width, full_height, y0, kmode)
    tids, pair = cull.tile_pairs(tile_start, tile_count)
    q = params[pair]
    px, py = tf.tile_pixel_coords(tids, tx_count, width, full_height, y0, kmode)
    g, inside, _, edge = tf.splat_falloff(q, px, py, kmode, width, full_height, with_edge=True)
    wp = cull.warp_pixels()  # [8, 32]
    reached = inside[:, wp].any(dim=-1) | (g != 0.0)[:, wp].any(dim=-1)  # [N, 8]
    m = masks[pair].to(torch.int64)
    kept = ((m[:, None] >> torch.arange(cull.WARPS)) & 1).bool()
    left_out = ~kept & reached
    assert not bool(left_out.any()), f"{int(left_out.sum())} left-out (pair, warp)s reach a pixel"
    assert not bool(g[:, wp][~kept].any())
    assert not bool(edge[:, wp][~kept].any()), "a left-out (pair, warp) has an edge pixel"
    n = max(kept.numel(), 1)
    return m, float(kept.sum()) / n, float(reached.sum()) / n


def _scene_inputs(scene, mode, width, height):
    cloud = cloud_from_numpy(cloud_arrays(*SCENES[scene]), "cpu")
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=width, height=height, device="cpu")
    settings = SETTINGS[mode]
    p_max = rt.pairs_budget(len(cloud), int(rt.pair_count(cloud, cam, settings)))
    splats = rt.project_for_binning(cloud, cam, settings)
    bins = rt.tile_bins(splats, width, height, p_max)
    params = splats["params"][bins.g_s].contiguous()
    return params, bins.start, bins.count


# torch_port_cases.py's cases (kind, n, seed): small splats, large ones
SCENES = {"bench": ("bench", 2000, 3), "wide": ("wide", 400, 1)}
# (width, height, y0, full height): the square frame, the non-16 height, a band
FRAMES = [(128, 128, 0, 128), (128, 120, 0, 120), (128, 120, 16, 136)]
FRAME_IDS = ["128x128", "128x120", "band-y0-16"]


def _scene_check(scene, mode, frame):
    """Assert the cull is sound on ``scene``'s tiles -> (kept, exact)."""
    width, height, y0, full_height = frame
    params, start, count = _scene_inputs(scene, mode, width, height)
    m, kept, exact = _check(params, start, count, width // 16, width, full_height, y0, mode)
    print(f"[cull {mode} {scene} {FRAME_IDS[FRAMES.index(frame)]}] pairs {m.numel()}, "
          f"kept {kept:.4f} of (pair, warp) visits, exact {exact:.4f}")
    assert exact <= kept
    return kept, exact


@pytest.mark.parametrize("frame", FRAMES, ids=FRAME_IDS)
@pytest.mark.parametrize("mode", list(MODE))
def test_cull_is_sound_on_bench_tiles(mode, frame):
    kept, _ = _scene_check("bench", mode, frame)
    # the bench scene's splats are small: the cull leaves out most visits
    assert kept <= 0.5


@pytest.mark.parametrize("frame", FRAMES, ids=FRAME_IDS)
@pytest.mark.parametrize("mode", list(MODE))
def test_cull_is_sound_on_wide_tiles(mode, frame):
    # large splats: many warps kept, some still left out
    kept, exact = _scene_check("wide", mode, frame)
    assert 0.0 < exact <= kept < 1.0


@pytest.mark.parametrize("seed", [21, 19])
@pytest.mark.parametrize("mode", list(MODE))
def test_cull_is_sound_on_adversarial_rows(mode, seed):
    width, height, y0 = 32, 48, 8  # tile 0 of a 2x3-tile grid, 8 rows into a 48-row frame
    rows = adversarial_rows(mode, width, height, y0, 4000, seed=seed)
    special = special_rows(mode, width, height, y0)
    params = torch.cat([rows, torch.stack([r for r, _ in special])]).contiguous()
    n = params.shape[0]
    start = torch.tensor([0, n, n, n, n, n], dtype=torch.int32)
    count = torch.tensor([n, 0, 0, 0, 0, 0], dtype=torch.int32)
    m, kept, exact = _check(params, start, count, width // 16, width, height, y0, mode)
    print(f"[cull {mode} adversarial seed {seed}] rows {n}, kept {kept:.4f}, exact {exact:.4f}")
    for i, (_, want) in enumerate(special):
        if want is not None:
            assert int(m[rows.shape[0] + i]) == want, (i, int(m[rows.shape[0] + i]), want)
    # every row reaches the tile somewhere: some (pair, warp) are left out,
    # some kept, so the checks above had both kinds to look at
    assert 0.0 < exact <= kept < 1.0


# the warp of each of a tile's 256 pixels
WARP_OF_PIXEL = torch.empty(tf.PIX, dtype=torch.int64)
WARP_OF_PIXEL[cull.warp_pixels()] = torch.arange(cull.WARPS)[:, None]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _culled_plain(monkeypatch, args, mode, bbox, chunk=tf.MAX_CHUNK):
    """``composite_tiles_raw_plain(*args)`` as it is, and again with alpha
    forced to exactly 0 and the edge to false at every pixel of every
    (pair, warp) that the twin of the cull leaves out -> (raw, culled raw,
    left-out (pair, pixel)s seen)."""
    kmode = MODE[mode]
    raw = tf.composite_tiles_raw_plain(*args, chunk=chunk, mode=kmode, bbox=bbox)
    falloff, alpha = tf.splat_falloff, tf.overlay_alpha
    state = {"left_out": 0}

    def culled_falloff(q, px, py, fmode, width, full_height, with_edge=False):
        keep = cull.row_warps(q, px[..., : tf.TILE], py[..., :: tf.TILE], fmode, width, full_height)
        state["keep"] = keep[..., WARP_OF_PIXEL]  # [tiles, chunk, 256]
        state["left_out"] += int((~state["keep"]).sum())
        return falloff(q, px, py, fmode, width, full_height, with_edge)

    def culled_alpha(g, edge, q, amode):
        a, e = alpha(g, edge, q, amode)
        keep = state.pop("keep")
        return torch.where(keep, a, 0.0), (None if e is None else e & keep)

    monkeypatch.setattr(tf, "splat_falloff", culled_falloff)
    monkeypatch.setattr(tf, "overlay_alpha", culled_alpha)
    culled = tf.composite_tiles_raw_plain(*args, chunk=chunk, mode=kmode, bbox=bbox)
    monkeypatch.undo()
    return raw, culled, state["left_out"]


@pytest.mark.parametrize("frame", FRAMES, ids=FRAME_IDS)
@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("bbox", [False, True], ids=["plain", "bbox"])
@pytest.mark.parametrize("mode", list(MODE))
def test_culled_blend_is_bitwise_the_same_on_scene_tiles(monkeypatch, mode, bbox, scene, frame):
    # the forward kernel skips the left-out (pair, warp)s: blending them with
    # alpha exactly 0 must change no bit of the raw image (nor the exit vote)
    width, height, y0, full_height = frame
    params, start, count = _scene_inputs(scene, mode, width, height)
    args = (params, start, count, width // 16, width, full_height, y0)
    raw, culled, left_out = _culled_plain(monkeypatch, args, mode, bbox)
    assert left_out > 0
    if bbox:
        assert int((raw[:, 3] == 0.0).sum()) > 0  # some edge closed a pixel
    assert torch.equal(_bits(raw), _bits(culled))


@pytest.mark.parametrize("seed", [21, 19])
@pytest.mark.parametrize("bbox", [False, True], ids=["plain", "bbox"])
@pytest.mark.parametrize("mode", list(MODE))
def test_culled_blend_is_bitwise_the_same_on_adversarial_rows(monkeypatch, mode, bbox, seed):
    # one chunk of rows at the edge of warp strips (+- 2 ulps) on tile 0:
    # a box one ulp too small would zero a pixel with g > 0 and move bits
    width, height, y0 = 32, 48, 8
    rows = adversarial_rows(mode, width, height, y0, 480, seed=seed)
    params = torch.cat([rows, torch.stack([r for r, _ in special_rows(mode, width, height, y0)])]).contiguous()
    n = params.shape[0]
    start = torch.tensor([0, n, n, n, n, n], dtype=torch.int32)
    count = torch.tensor([n, 0, 0, 0, 0, 0], dtype=torch.int32)
    args = (params, start, count, width // 16, width, height, y0)
    raw, culled, left_out = _culled_plain(monkeypatch, args, mode, bbox)
    assert left_out > 0
    assert float(raw[0, 3].max()) < 1.0  # the rows reach every pixel of the tile
    assert torch.equal(_bits(raw), _bits(culled))


@pytest.mark.parametrize("column", ["r", "g", "b", "alpha"])
@pytest.mark.parametrize("mode", list(MODE))
def test_rows_with_a_non_finite_colour_or_alpha_keep_every_warp(mode, column):
    # rows whose mask would be partial or empty (b1 <= 0, far away, small)
    # keep all eight warps once a colour or alpha is inf, -inf or NaN
    width, height, y0 = 32, 48, 8
    rows = adversarial_rows(mode, width, height, y0, 300, seed=7)
    special = torch.stack([r for r, _ in special_rows(mode, width, height, y0)])
    params = torch.cat([rows, special]).contiguous()
    n = params.shape[0]
    start = torch.tensor([0, n, n, n, n, n], dtype=torch.int32)
    count = torch.tensor([n, 0, 0, 0, 0, 0], dtype=torch.int32)
    args = (start, count, width // 16, width, height, y0, MODE[mode])
    finite = cull.warp_masks(params, *args)
    assert int((finite != 0xFF).sum()) > n // 2  # most masks are partial
    col = tf.rgb_row(MODE[mode]) + ["r", "g", "b", "alpha"].index(column)
    bad = params.clone()
    bad[:, col] = torch.tensor([np.inf, -np.inf, np.nan])[torch.arange(n) % 3]
    assert bool((cull.warp_masks(bad, *args) == 0xFF).all())
    # a finite value anywhere else in the row leaves the mask as it was
    bad[:, col] = params[:, col] * 2.0
    assert torch.equal(cull.warp_masks(bad, *args), finite)
