"""Pair-budget fill of the training steps, %: each step's uncapped pairs
over the pair budget it binned at (the program's counters ``train.pairs``
and ``train.budget``, ``train/step.py`` ``train_step``, every step of the
run).  None where the program keeps no such counters or took no step, or
where the trace saw no kernel (a run off the card).  Layer:
``ops/rasterize_tile.py`` pair budget."""


def read(r):
    if r.kind != "train" or r.trace["launches"] <= 0:
        return None
    try:
        from bevy_gaussian_splatting_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    c = counters()
    budget = c.get("train.budget", 0)
    return 100.0 * c["train.pairs"] / budget if budget else None
