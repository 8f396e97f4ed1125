"""The yardstick's work counts of a 2DGS training step with the surface
regularisers (the ``gs2d-1m.train-512`` cell), beside ``counts.py`` and
``counts_2d.py`` (whose peaks, least time and per-surfel counts they reuse).

Every add, multiply, divide, compare and select is one operation, as there.
The compositors' per-visit counts:

  - forward, per (pair, pixel) inside a surfel's square: the serving
    branch's 45 (``counts_2d.FWD_OPS_PER_INSIDE``) and the least-alpha test
    1; per fragment that enters the maps (alpha >= 1/255, z >= near) 32 more:
    the depth det T0 / q0.z 8 (q0.z 4, its clamp 2, the reciprocal and the
    product), its test 1, 1 / z 1, the distortion w ((zeta^2 ad + z2) - 2
    zeta z1) 8, w zeta 1, the running sums ad, z1, z2 4, N 6, D 2, the
    median's test 1 (``csrc/tile_fwd.cu`` kSurface);
  - backward, per inside (pair, pixel): ``chip_smoke.py``'s 2DGS 109 (the
    falloff 4 and 105 more) and the least-alpha test 1; per fragment 60 more:
    the depth and its test 9, 1 / z 1, n . gN 5, the distortion's weight
    gradient 6, gc 5, d(1/z) 5, dz 4, the median's test and add 2, dq0.z 4,
    its share of the centre's two columns 4, the seven columns 7 and their
    sums into the pixel totals 7, and the dn weight 1 (``csrc/tile_bwd.cu``
    kSurface).

Bytes: forward, the walked pairs' 23-float rows, each tile's range and per
pixel the colour and transmittance, the six maps and the four totals (14
floats) out; backward, the walked rows in and their 23-float gradient rows
out, the ranges, per pixel the image's cotangent and final transmittance
(``counts.BWD_IN_BYTES_PER_PIXEL``) and the eleven surface inputs
(``pack_surface_gbar``).

The step: the frame (the surfel projection, ``counts_2d.frame_ops``, and the
surface columns of every visible surfel, 165: the depth's coefficients 119
(the rotation's two rows 24, the unit-scale rows 48, the position's row 18,
det T0 14, the three z components 9, their folding 6) and the normal 46 (its
axis 12, its view rotation 15, its normalisation 10, the facing test 9)),
the photometric loss and its gradient, the
geometric loss and its gradient (per pixel: the expected and surface depth
5, the back-projected point 5, two central differences 6, the cross product
9, its normalisation 7, the alpha scaling 3, N . N_d and 1 - it 6, the
distortion's mean and scale 2; 43, its gradient twice that), the backward
compositor, the backward of the surfel chain twice its forward, and Adam.
"""

from __future__ import annotations

from benchmark import counts, counts_2d

FWD_OPS_PER_INSIDE = counts_2d.FWD_OPS_PER_INSIDE + 1
FWD_OPS_PER_FRAG = 32
BWD_OPS_PER_INSIDE = 109 + 1
BWD_OPS_PER_FRAG = 60
STAGE_OPS_PER_PAIR = counts_2d.STAGE_OPS_PER_PAIR
ROW_BYTES = 23 * 4
FWD_OUT_BYTES_PER_PIXEL = (4 + 6 + 4) * 4
SURFACE_IN_BYTES_PER_PIXEL = 11 * 4
SURFACE_COLS_OPS = 165
GEOMETRY_OPS_PER_PIXEL = 43


def compositor_work(walked: int, inside: int, frags: int, num_tiles: int, backward: bool = False) -> tuple:
    """(operations, bytes) of one pass of the surface compositor over a
    frame."""
    pixels = num_tiles * 256
    if backward:
        ops = walked * STAGE_OPS_PER_PAIR + inside * BWD_OPS_PER_INSIDE + frags * BWD_OPS_PER_FRAG
        nbytes = (walked * ROW_BYTES * 2 + num_tiles * counts.RANGE_BYTES
                  + pixels * (counts.BWD_IN_BYTES_PER_PIXEL + SURFACE_IN_BYTES_PER_PIXEL))
    else:
        ops = walked * STAGE_OPS_PER_PAIR + inside * FWD_OPS_PER_INSIDE + frags * FWD_OPS_PER_FRAG
        nbytes = walked * ROW_BYTES + num_tiles * counts.RANGE_BYTES + pixels * FWD_OUT_BYTES_PER_PIXEL
    return ops, nbytes


def step_ops(n: int, visible: int, walked: int, inside: int, frags: int, pixels: int, param_values: int) -> int:
    """Operations of one training step of the 2DGS objective."""
    fwd, _ = compositor_work(walked, inside, frags, 0)
    bwd, _ = compositor_work(walked, inside, frags, 0, backward=True)
    chain = n * counts_2d.ALL_OPS_2D + visible * (counts_2d.VISIBLE_OPS_2D + SURFACE_COLS_OPS)
    frame = chain + fwd + pixels * counts.EPILOGUE_OPS_PER_PIXEL
    loss = pixels * (3 * counts.LOSS_OPS_PER_VALUE + GEOMETRY_OPS_PER_PIXEL) * (1 + counts.BACKWARD_FACTOR)
    return frame + loss + bwd + chain * counts.BACKWARD_FACTOR + param_values * counts.ADAM_OPS_PER_VALUE
