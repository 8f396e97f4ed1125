"""The whole training step's share of the chip's FP32 peak, %: the step's
counted operations (``benchmark/counts.py`` ``step_ops``) over 67 TFLOP/s
times the untraced window's wall time (only where the trace saw the device work) a step.  Layer: the whole step."""

from benchmark.counts import FP32_OPS_PER_S


def read(r):
    ops = r.work.get("ops")
    if r.kind != "train" or not ops or r.wall_per_unit_s <= 0.0 or r.trace["busy_s"] <= 0.0:
        return None
    return 100.0 * ops / (FP32_OPS_PER_S * r.wall_per_unit_s)
