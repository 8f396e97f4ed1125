"""Device time a training step, ms: the traced window's busy time (the
union of its kernels, copies and fills) over its steps.  Beside the host's
``step_ms`` it is the steady reading of what the device does.  Layer:
device."""


def read(r):
    if r.kind != "train" or not r.units or r.trace["busy_s"] <= 0.0:
        return None
    return 1e3 * r.trace["busy_s"] / r.units
