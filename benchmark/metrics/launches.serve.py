"""CUDA kernel launches a served frame: the traced window's kernels over
its frames.  Layer: host dispatch."""


def read(r):
    if r.kind != "serve" or not r.units or r.trace["launches"] <= 0:
        return None
    return r.trace["launches"] / r.units
