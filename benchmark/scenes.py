"""Scenes and cameras of the benchmark's cells, made from ``--seed``.

A configuration file (``benchmark/configs/<name>.json``) holds the recipe:
its ``kind`` (``3d`` or ``4d``), ``n_gaussians`` and ``scene``, the ranges
of uniform draws and the scalings after them.  The recipes are those of the
program's seeded stand-in scenes, drawn here on the device from a
``torch.Generator`` in a few large calls (not numpy's bits):

  - 3D, ``models/cloud.py`` ``_random_3d`` (SH degree 3, 48 coefficients)
    with ``chip_smoke.py:420-426``'s scaling (positions x (1, 1, 0.25),
    scales x 0.05), the scene of the repo's 3D bench (``bench.py:88-108``);
  - 4D, ``models/cloud.py`` ``_random_4d`` (144 spherindrical coefficients,
    unit left and right quaternions, timestamp and timescale), the 4D bench's
    scene (``bench.py:340-369``), unscaled.

A scene is a dict of float32 field tensors named as the program's cloud
classes name them, so that both the program and the reference take it.
"""

from __future__ import annotations

import torch

SH_WIDTH_3D = 48  # pad_4(3 * (3 + 1)^2)
SH_WIDTH_4D = 144  # pad_4(3 * 16 * 3)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(lo, hi, generator=gen)


def make_scene(config: dict, seed: int, device, n: int | None = None) -> dict:
    """The configuration's scene drawn from ``seed`` on ``device`` -> dict of
    float32 fields.  ``n`` overrides the configuration's count (tests)."""
    n = int(config["n_gaussians"] if n is None else n)
    rec = config["scene"]
    gen = generator(seed, device)
    pos_lo, pos_hi = rec["position_range"]
    pos = _uniform(gen, (n, 3), pos_lo, pos_hi, device) * torch.tensor(rec["position_scale"], device=device)
    pv = torch.cat([pos, torch.ones((n, 1), device=device)], dim=1)
    scale = _uniform(gen, (n, 3), *rec["scale_range"], device) * float(rec["scale_scale"])
    opacity = _uniform(gen, (n, 1), *rec["opacity_range"], device)
    so = torch.cat([scale, opacity], dim=1)
    if config["kind"] == "3d":
        sh = _uniform(gen, (n, SH_WIDTH_3D), *rec["sh_range"], device)
        rot = _uniform(gen, (n, 4), *rec["rotation_range"], device)
        return {"position_visibility": pv, "spherical_harmonic": sh, "rotation": rot, "scale_opacity": so}
    sh = _uniform(gen, (n, SH_WIDTH_4D), *rec["sh_range"], device)
    q = _uniform(gen, (n, 8), *rec["rotation_range"], device).reshape(n, 2, 4)
    iso = (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).reshape(n, 8)
    ts = torch.cat([
        _uniform(gen, (n, 1), *rec["timestamp_range"], device),
        _uniform(gen, (n, 1), *rec["timescale_range"], device),
    ], dim=1)
    return {
        "position_visibility": pv,
        "spherindrical_harmonic": sh,
        "isotropic_rotations": iso,
        "scale_opacity": so,
        "timestamp_timescale": ts,
    }


def moved(scene: dict, offset) -> dict:
    """The scene with every position moved by ``offset`` (a training cell's
    target, as ``examples/training.py`` moves its cloud)."""
    out = dict(scene)
    shift = torch.tensor([*offset, 0.0], dtype=torch.float32, device=scene["position_visibility"].device)
    out["position_visibility"] = scene["position_visibility"] + shift
    return out
