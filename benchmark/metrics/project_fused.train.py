"""Share of the training steps' projections that a projection kernel made,
%: the program's counters ``project.fused`` (each forward launch of
``ops/cuda/project.py``'s kernels: ``ProjectCore``'s in 3DGS training) over
``project.calls`` (each ``ops/rasterize_tile.py`` ``project_for_binning``),
over the run.  None where the program keeps no such counters or made no
projection, or where the trace saw no kernel (a run off the card).  Layer:
``ops/cuda/project.py`` (``csrc/project.cu``)."""


def read(r):
    if r.kind != "train" or r.trace["launches"] <= 0:
        return None
    try:
        from bevy_gaussian_splatting_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    c = counters()
    calls = c.get("project.calls", 0)
    return 100.0 * c.get("project.fused", 0) / calls if calls else None
