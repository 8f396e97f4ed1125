"""Share of the training projections' colour stages that the SH kernels
ran, %: the program's counters ``sh.fused`` (each forward launch of
``ops/cuda/sh.py`` ``sh_colour``) over ``sh.calls`` (each colour stage of
``ops/project.py`` ``project_gaussians`` in COLOR or CLASSIFICATION), over
the run.  None where the program keeps no such counters or ran no colour
stage, or where the trace saw no kernel (a run off the card).  Layer:
``ops/cuda/sh.py`` (``csrc/sh.cu``)."""


def read(r):
    if r.kind != "train" or r.trace["launches"] <= 0:
        return None
    try:
        from bevy_gaussian_splatting_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    c = counters()
    calls = c.get("sh.calls", 0)
    return 100.0 * c.get("sh.fused", 0) / calls if calls else None
