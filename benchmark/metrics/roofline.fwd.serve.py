"""The forward tile compositor's share of its roofline in served frames, %:
the least time of the work these frames need (``benchmark/counts.py``, from
the reference's binning) over the device time of ``composite_fwd_kernel``
in the traced window.  Layer: ``ops/cuda/tile_fwd.py`` (``csrc/tile_fwd.cu``)."""

KERNEL = "composite_fwd_kernel"


def read(r):
    if r.kind != "serve":
        return None
    spent = sum(s for name, s in r.trace["kernel_s"].items() if KERNEL in name)
    least = r.work.get("fwd_least_s", 0.0) * r.units
    if spent <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / spent
