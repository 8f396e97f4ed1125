"""The PyTorch twin of the per-warp footprint cull that both tile
compositors share (``csrc/cull.cuh``).

A tile of 16 x 16 pixels is one block of 256 threads; its eight warps are
blocks of 4 x 8 pixels (``WARP_ROWS`` x ``WARP_COLS``), two across and four
down.  When a chunk of pairs is staged, each pair gets a mask of the warps
its splat's box may reach, and each warp walks only the pairs whose mask
holds it.  A left-out (pair, warp) has g = 0 at all 32 pixels (and no
overlay edge), so leaving it out changes no float of the forward's image or
the backward's gradients.  :func:`warp_masks` gives the kernel's masks with
its float32 operations in its order; the tests hold it to the falloff
(``tests/test_torch_cull.py``) and, on the card, to the kernels' outputs.
"""

from __future__ import annotations

import torch

from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import (
    MODE_AABB,
    MODE_OBB,
    TILE,
    _surfel_constants,
    rgb_row,
    tile_pixel_coords,
)

WARPS = 8  # warps of a tile's block
WARP_ROWS, WARP_COLS = 4, 8  # the kernel's warp shape in pixels
OBB_MARGIN = 2.0**-13  # OBB's box margin, a share of hx + hy
MIN_AXIS_NORM2 = 2.0**-100  # below this |e1|^2 the OBB box keeps every warp


def tile_pairs(tile_start: torch.Tensor, counts: torch.Tensor):
    """(tile, pair) [N] int64 of the first ``counts[t]`` pairs of each tile
    t's range in the pair-sorted layout (``tile_count`` for all of them)."""
    counts = counts.to(torch.int64).clamp(min=0)
    tids = torch.repeat_interleave(torch.arange(tile_start.shape[0], device=counts.device), counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    offset = torch.arange(tids.shape[0], device=counts.device) - first
    return tids, torch.repeat_interleave(tile_start.to(torch.int64), counts) + offset


def row_warps(q, colx, rowy, mode: int, width: int, full_height: int) -> torch.Tensor:
    """Warps [..., WARPS] bool that the splats of rows ``q`` [...,
    param_width(mode)] may reach in tiles whose 16 columns lie at ``colx``
    and 16 rows at ``rowy`` [..., 16] in the falloff's frame (broadcast
    against ``q``'s leading dimensions), as ``warp_mask`` in csrc/cull.cuh.

    The box |px - cx| <= hx, |py - cy| <= hy: OBB's rotated rectangle (b1
    |e1x| + b2 |e1y|, b1 |e1y| + b2 |e1x|) / |e1|^2 widened by
    ``OBB_MARGIN`` of hx + hy, empty where b1 <= 0, every warp where |e1|^2
    < ``MIN_AXIS_NORM2``; AABB the radius; 2DGS the staged (mr / W, mr / H).
    A strip of warps is left out where px - cx (or py - cy), rounded, lies
    beyond the box at both of its extreme pixels.  A row whose alpha or any
    colour is not finite keeps every warp: a skipped blend step is exact
    only for finite values."""
    full = torch.zeros(q.shape[:-1], dtype=torch.bool, device=q.device)
    empty = torch.zeros_like(full)
    if mode == MODE_OBB:
        floor = torch.tensor(1e-12, dtype=torch.float32, device=q.device)
        empty = ~(q[..., 4] > 0.0)
        b1, b2 = torch.fmax(q[..., 4], floor), torch.fmax(q[..., 5], floor)
        ax, ay = q[..., 2].abs(), q[..., 3].abs()
        n2 = q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3]
        full = ~(n2 >= MIN_AXIS_NORM2)
        hx = (b1 * ax + b2 * ay) / n2
        hy = (b1 * ay + b2 * ax) / n2
        grow = (hx + hy) * OBB_MARGIN
        hx, hy = hx + grow, hy + grow
    elif mode == MODE_AABB:
        hx = hy = q[..., 5]
    else:
        inv_w, inv_h, _ = _surfel_constants(width, full_height)
        hx, hy = q[..., 2] * inv_w, q[..., 2] * inv_h
    cx, cy = q[..., 0:1], q[..., 1:2]
    hx, hy = hx[..., None], hy[..., None]
    xlo = colx[..., 0::WARP_COLS] - cx
    xhi = colx[..., WARP_COLS - 1 :: WARP_COLS] - cx
    yhi = rowy[..., 0::WARP_ROWS] - cy
    ylo = rowy[..., WARP_ROWS - 1 :: WARP_ROWS] - cy
    xs = ~((xlo > hx) | (xhi < -hx))  # [..., 2 column strips]
    ys = ~((ylo > hy) | (yhi < -hy))  # [..., 4 row strips]
    keep = (ys[..., :, None] & xs[..., None, :]).flatten(-2)  # warp w = (w // 2, w % 2)
    ro = rgb_row(mode)
    nonfinite = ~torch.isfinite(q[..., ro : ro + 4]).all(dim=-1)
    return ((keep | full[..., None]) & ~empty[..., None]) | nonfinite[..., None]


def warp_masks(
    params: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tx_count: int,
    width: int,
    full_height: int,
    y0: int = 0,
    mode: int = MODE_OBB,
) -> torch.Tensor:
    """The kernels' per-pair warp masks [P] uint8: bit w set where the
    splat of the pair's row may reach a pixel of warp w of its tile
    (:func:`row_warps`); 0 for pairs in no tile's range."""
    tids, pair = tile_pairs(tile_start, tile_count)
    px, py = tile_pixel_coords(tids, tx_count, width, full_height, y0, mode)
    # the falloff frame's x of the 16 columns and y of the 16 rows (decreasing)
    keep = row_warps(params[pair], px[:, :TILE], py[:, ::TILE], mode, width, full_height)
    bits = (keep.to(torch.int64) << torch.arange(WARPS, device=params.device)).sum(dim=1)
    masks = torch.zeros(params.shape[0], dtype=torch.uint8, device=params.device)
    masks[pair] = bits.to(torch.uint8)
    return masks


def warp_pixels() -> torch.Tensor:
    """Pixel indices [8, 32] of each warp of a tile (row-major pixel index
    p = row * 16 + col), as the kernels map their threads."""
    w = torch.arange(WARPS)[:, None]
    lane = torch.arange(32)[None, :]
    row = (w // 2) * WARP_ROWS + lane // WARP_COLS
    col = (w % 2) * WARP_COLS + lane % WARP_COLS
    return row * TILE + col
