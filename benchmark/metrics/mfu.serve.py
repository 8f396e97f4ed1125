"""The whole served frame's share of the chip's FP32 peak, %: the frame's
counted operations (``benchmark/counts.py`` ``frame_ops``, from the
reference's binning of the traced frames) over 67 TFLOP/s times the
untraced window's wall time (only where the trace saw the device work) a frame.  Layer: the whole frame."""

from benchmark.counts import FP32_OPS_PER_S


def read(r):
    ops = r.work.get("ops")
    if r.kind != "serve" or not ops or r.wall_per_unit_s <= 0.0 or r.trace["busy_s"] <= 0.0:
        return None
    return 100.0 * ops / (FP32_OPS_PER_S * r.wall_per_unit_s)
