"""The backward tile compositor's share of its roofline in training steps,
%: the least time of the work these steps need (``benchmark/counts.py``,
from the reference's binning) over the device time of
``composite_bwd_kernel`` in the traced window.  Layer:
``ops/cuda/tile_bwd.py`` (``csrc/tile_bwd.cu``)."""

KERNEL = "composite_bwd_kernel"


def read(r):
    if r.kind != "train":
        return None
    spent = sum(s for name, s in r.trace["kernel_s"].items() if KERNEL in name)
    least = r.work.get("bwd_least_s", 0.0) * r.units
    if spent <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / spent
