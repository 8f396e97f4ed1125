"""Pair-budget fill of the served frames, %: the pairs that the budget's
recounts counted over the buckets they sized (the program's counters
``budget.pairs_counted`` and ``budget.sized``, ``render/api.py``
``_current_bucket``, every recount of the run).  None where the program
keeps no such counters or made no recount, or where the trace saw no
kernel (a run off the card).  Layer: ``render/api.py`` pair budget."""


def read(r):
    if r.kind != "serve" or r.trace["launches"] <= 0:
        return None
    try:
        from bevy_gaussian_splatting_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    c = counters()
    sized = c.get("budget.sized", 0)
    return 100.0 * c["budget.pairs_counted"] / sized if sized else None
