"""The fused projection kernel's share of its roofline in served frames, %:
the least time of the bytes its projections must move (``work()``'s
``project_least_s`` a frame, ``benchmark/counts_2d.py``) over the device
time of ``project_kernel`` in the traced window.  None where the traffic
counts no projection bytes or the trace saw no such kernel (a program that
projects through the eager chain).  Layer: ``ops/cuda/project.py``
(``csrc/project.cu``)."""

KERNEL = "project_kernel"


def read(r):
    if r.kind != "serve":
        return None
    spent = sum(s for name, s in r.trace["kernel_s"].items() if KERNEL in name)
    least = r.work.get("project_least_s", 0.0) * r.units
    if spent <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / spent
