"""CUDA kernel launches a training step: the traced window's kernels over
its steps.  Layer: host dispatch."""


def read(r):
    if r.kind != "train" or not r.units or r.trace["launches"] <= 0:
        return None
    return r.trace["launches"] / r.units
