"""The yardstick's work counts and the chip's peaks.

Operations are FP32 operations, a multiply-add counted as two; bytes are
each input read once and each output written once.  A kernel's least time
is the larger of operations over ``FP32_OPS_PER_S`` and bytes over
``HBM_BYTES_PER_S`` (the H100 SXM data sheet's peaks at the card's full
700 W; the result line gives the card's power limit beside them).  The
counts are of the work that the inputs need, taken from the benchmark's
own reference binning (``reference/splat.py``): pairs walked before a
tile's early exit and (pair, pixel) evaluations inside a splat's quad.
They never come from the program's pair lists or kernels.

The compositors' per-visit counts are ``chip_smoke.py:272-303``'s, copied
with their derivation:

  - staging, per walked pair, OBB: b1 > 0, two clamps, two reciprocals,
    three selects, 8 (``chip_smoke.py:279-281``, ``STAGE_OPS_PER_PAIR``);
  - forward, per inside (pair, pixel), OBB: offsets 2, u 4, v 4, the inside
    test 4, the exponent 4 and one expf, then the blend: g alpha, the cap,
    w, three multiply-adds, 1 - a, T, 11; 30 (``chip_smoke.py:283-286``,
    ``COMPOSITE_OPS_PER_INSIDE``);
  - backward, per inside (pair, pixel), OBB: the falloff 12 and 60 more
    (alpha, transmittance, the gradient chain and one add into each pixel
    sum), 72 (``chip_smoke.py:292-294``, ``BACKWARD_OPS_PER_INSIDE``).

Bytes, forward: the walked pairs' 10-float rows, each tile's range (two
int32) and the [T, 4, 256] float32 output (``chip_smoke.py:494-496``).
Backward: the walked rows, the ranges, the image's cotangent and final
transmittance ([T, 5, 256] float32) in, one 10-float gradient row per
walked pair out.

The per-gaussian counts are this file's own, from the reference's
formulas (``reference/splat.py`` ``project``), every add, multiply,
divide, compare, select, square root, exponential and logarithm one
operation:

  - every gaussian, 3D: the clip transform 29 (3 x 6 for xyz, 6 for w, 4
    divides, 1 epsilon), the frustum test 7, the depth 8; 44;
  - every gaussian, 4D, also the conditional chain: the 4x4 rotation
    product 112 (16 entries of 4 multiplies and 3 adds), s4 3, Sigma's ten
    entries of 4 multiplies, 3 adds and 2 scalings 90, the marginal 5, the
    mask 1, the conditional 3D covariance 18, the mean shift 9 and its add
    3, the second clip transform 29 and frustum test 8; 278;
  - every visible gaussian, 3D: the cutoff 6, the 3D covariance 66 (the
    rotation rows 27, the squared scales 6, six entries of 3 terms 33), the
    EWA projection 96 (view transform 18, Jacobian 13, T0 and T1 18, two
    products with Sigma 30, three sums 17), the OBB axes 35, the SH ray 13,
    the degree-3 basis 52, the contraction 99 (16 coefficients x 3 channels
    as multiply-adds, the bias), sRGB to linear 18, the packed row and the
    tile rectangle 24; 409; 4D has no quaternion covariance (the chain gave
    it, -66) and adds the spherindrical blocks: 2 cosines and their
    arguments 6, the 48-term basis 48 and 32 more coefficients x 3 channels
    as multiply-adds 192; 589;
  - a pixel: the epilogue 2 (1 - T, and the store of rgb); the loss, per
    rgb value, L1 3, SSIM's five separable 11-tap blurs 220 and its ratio
    19, 242, its gradient twice that;
  - a step: the backward of the per-gaussian chain twice its forward, for
    every gaussian that the forward handled; Adam 12 per parameter value
    (two moment updates 7, the bias corrections 2, the root, the eps, the
    step).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: HBM3 bandwidth
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet: FP32 outside the tensor cores, FMA = 2

STAGE_OPS_PER_PAIR = 8  # chip_smoke.py:295, OBB
FWD_OPS_PER_INSIDE = 30  # chip_smoke.py:301, OBB
BWD_OPS_PER_INSIDE = 72  # chip_smoke.py:303, OBB (12 + 60)
ROW_BYTES = 10 * 4  # a pair's parameter row
RANGE_BYTES = 2 * 4  # a tile's start and count
FWD_OUT_BYTES_PER_PIXEL = 4 * 4  # raw rgb and transmittance
BWD_IN_BYTES_PER_PIXEL = 5 * 4  # the cotangent of rgba and the final transmittance

ALL_OPS = {"3d": 44, "4d": 44 + 278}
VISIBLE_OPS = {"3d": 409, "4d": 409 - 66 + 246}
EPILOGUE_OPS_PER_PIXEL = 2
LOSS_OPS_PER_VALUE = 242
ADAM_OPS_PER_VALUE = 12
BACKWARD_FACTOR = 2


def least_time_s(ops: float, nbytes: float) -> float:
    """The least time for ``ops`` operations and ``nbytes`` bytes."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def compositor_work(walked: int, inside: int, num_tiles: int, backward: bool = False) -> tuple:
    """(operations, bytes) of one compositor pass over a frame."""
    pixels = num_tiles * 256
    if backward:
        ops = walked * STAGE_OPS_PER_PAIR + inside * BWD_OPS_PER_INSIDE
        nbytes = walked * ROW_BYTES * 2 + num_tiles * RANGE_BYTES + pixels * BWD_IN_BYTES_PER_PIXEL
    else:
        ops = walked * STAGE_OPS_PER_PAIR + inside * FWD_OPS_PER_INSIDE
        nbytes = walked * ROW_BYTES + num_tiles * RANGE_BYTES + pixels * FWD_OUT_BYTES_PER_PIXEL
    return ops, nbytes


def frame_ops(kind: str, n: int, visible: int, walked: int, inside: int, pixels: int) -> int:
    """Operations of one served frame."""
    fwd, _ = compositor_work(walked, inside, 0)
    return n * ALL_OPS[kind] + visible * VISIBLE_OPS[kind] + fwd + pixels * EPILOGUE_OPS_PER_PIXEL


def step_ops(kind: str, n: int, visible: int, walked: int, inside: int, pixels: int, param_values: int) -> int:
    """Operations of one training step: the frame, the loss and its
    gradient, the backward compositor, the backward of the per-gaussian
    chain and Adam."""
    bwd, _ = compositor_work(walked, inside, 0, backward=True)
    chain = n * ALL_OPS[kind] + visible * VISIBLE_OPS[kind]
    loss = pixels * 3 * LOSS_OPS_PER_VALUE * (1 + BACKWARD_FACTOR)
    return (frame_ops(kind, n, visible, walked, inside, pixels) + loss + bwd
            + chain * BACKWARD_FACTOR + param_values * ADAM_OPS_PER_VALUE)
