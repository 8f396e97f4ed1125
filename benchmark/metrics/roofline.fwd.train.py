"""The forward tile compositor's share of its roofline in training steps
with the 2DGS surface maps, %: the least time of the forward work these
steps need, the maps with the colour (``benchmark/counts_2d_train.py``,
from the reference's binning), over the device time of
``composite_fwd_kernel`` in the traced window.  None where the cell's
traffic counts no forward work (``fwd_least_s``) or the trace saw no such
kernel.  Layer: ``ops/cuda/tile_fwd.py`` (``csrc/tile_fwd.cu``)."""

KERNEL = "composite_fwd_kernel"


def read(r):
    if r.kind != "train":
        return None
    spent = sum(s for name, s in r.trace["kernel_s"].items() if KERNEL in name)
    least = r.work.get("fwd_least_s", 0.0) * r.units
    if spent <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / spent
