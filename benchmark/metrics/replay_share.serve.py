"""Share of the window's served frames that replayed a stale binning
(``InteractiveRenderer.stats``: replays over bins, replays and one-pass
frames), in %.  Layer: ``render/api.py`` ``InteractiveRenderer``."""


def read(r):
    if r.kind != "serve":
        return None
    total = sum(r.stats.get(k, 0) for k in ("bins", "replays", "oneshots"))
    return 100.0 * r.stats.get("replays", 0) / total if total else None
