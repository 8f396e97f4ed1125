"""Share of a training step's wall time in which the device runs nothing,
%: 1 minus the traced window's busy time a step over the untraced window's
wall time a step, both taken in the same process.  Layer: device."""


def read(r):
    if r.kind != "train" or not r.units or r.wall_per_unit_s <= 0.0 or r.trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.units / r.wall_per_unit_s)
