"""The yardstick's work counts of a served 2DGS surfel frame, beside
``benchmark/counts.py`` (whose peaks, least time and 3D counts they reuse).

The compositor's per-visit counts are ``chip_smoke.py:282-291``'s for its
2DGS branch: staging, per walked pair, 2 (mr / W, mr / H); forward, per
inside (pair, pixel), 45 (offsets 2, the square 4, q 12, the clamp and
reciprocal 4, us, vs, s3d, d2x2 9, min, scale, expf 3, the blend 11).
Bytes, forward: the walked pairs' 16-float rows, each tile's range (two
int32) and the [T, 4, 256] float32 output.

The per-surfel counts are this file's own, from the reference's formulas
(``reference/splat_2d.py`` ``project``), every add, multiply, divide,
compare, select, square root, exponential and logarithm one operation:

  - every surfel: the clip transform 29, the frustum test 7, the depth 8;
    44 (as 3D);
  - every visible surfel: the cutoff 6, the rotation's two rows 24, the
    scales 2, L = T_r R^T S 36 (six entries of 3 multiplies, 2 adds and a
    scaling), the homography's rows 0 and 1 30 and row 2 18, cut^2 1, d 8,
    its test 2 and select 1, the two divisions 2, the centre 16, the
    extent's sums 16 and differences 4, the validity 4, the radius 11 (two
    guarded roots, two maxima, the filter), the three cross products 36
    (each term a multiply, a negation and a multiply-add), A and B 6, C 12,
    the SH ray 13, the degree-3 basis 52, the contraction 99, sRGB to
    linear 18, the packed row and the tile square 24; 441.

The projection kernel's least bytes (``csrc/project.cu``
``project_kernel_2d``): a surfel reads its position and visibility,
quaternion, scales and opacity and 48 SH floats (240 bytes) and writes its
16-float row, centre, radius, mask and key (85 bytes).
"""

from __future__ import annotations

from benchmark.counts import ALL_OPS, EPILOGUE_OPS_PER_PIXEL, HBM_BYTES_PER_S, RANGE_BYTES, FWD_OUT_BYTES_PER_PIXEL

STAGE_OPS_PER_PAIR = 2  # chip_smoke.py:299, 2DGS
FWD_OPS_PER_INSIDE = 45  # chip_smoke.py:305, 2DGS
ROW_BYTES = 16 * 4  # a pair's surfel row
ALL_OPS_2D = ALL_OPS["3d"]
VISIBLE_OPS_2D = 441
PROJECT_READ_BYTES = 4 * (4 + 4 + 4 + 48)
PROJECT_WRITE_BYTES = 16 * 4 + 2 * 4 + 4 + 1 + 8


def compositor_work(walked: int, inside: int, num_tiles: int) -> tuple:
    """(operations, bytes) of one forward compositor pass over a frame."""
    ops = walked * STAGE_OPS_PER_PAIR + inside * FWD_OPS_PER_INSIDE
    nbytes = walked * ROW_BYTES + num_tiles * RANGE_BYTES + num_tiles * 256 * FWD_OUT_BYTES_PER_PIXEL
    return ops, nbytes


def frame_ops(n: int, visible: int, walked: int, inside: int, pixels: int) -> int:
    """Operations of one served surfel frame."""
    fwd, _ = compositor_work(walked, inside, 0)
    return n * ALL_OPS_2D + visible * VISIBLE_OPS_2D + fwd + pixels * EPILOGUE_OPS_PER_PIXEL


def project_least_s(n: int) -> float:
    """The least time of one projection of ``n`` surfels: its bytes."""
    return n * (PROJECT_READ_BYTES + PROJECT_WRITE_BYTES) / HBM_BYTES_PER_S
