"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Every case is built once in numpy from a seed and handed to both packages:
the JAX package as jnp arrays, the port through ``cloud_from_numpy`` on the
CPU.  The rule is the JAX package's ``_random_3d``; the "bench" cases apply
bench.py's squash (positions * (1, 1, 0.25), scales * 0.05), the "wide"
cases keep the raw draw (large splats spanning many tiles), and "occluded"
is a denser form of test_pallas.py's heavy-occlusion scene (many opaque
overlapping splats; scales * 3 so whole tiles saturate).  The 2DGS cases add
the surfel grid of ``tools/surfel_plane.py`` (the port's numpy copy of
``make_surfel_grid`` is ``models/cloud.py`` ``surfel_grid_arrays``) seen from
its camera eye, ``SURFEL_EYE``.

The module imports JAX and the JAX package only inside the functions that
build the JAX side, so that the card tests (tests/test_torch_cuda.py), which
run where JAX is not installed, share the backward cull's rows
(``adversarial_rows``, ``special_rows``) with tests/test_torch_cull.py.
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera as TCamera
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    cloud_from_numpy,
    random_arrays_3d_seeded,
    sh_coeff_width,
)
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf

# The suite runs in several pytest-xdist workers at once, and every worker
# imports this module while collecting.  PyTorch's default intra-op pool, one
# thread per core in each worker, oversubscribes the cores: a test that takes
# 15 s alone took 590 s in a six-worker run
# (test_backward_matches_autograd_through_oracle[bench2000-128x120-bg]).  The
# port's test tensors gain nothing from more threads (that test takes 15 s
# alone with one thread or eight), so each worker keeps one.
torch.set_num_threads(1)

EYE = (0.0, 0.0, 60.0)
SURFEL_EYE = (2.5, 2.0, 6.0)  # tools/surfel_plane.py


def cloud_arrays(kind: str, n: int, seed: int) -> dict:
    a = random_arrays_3d_seeded(n, seed=seed)
    if kind == "bench":
        a["position_visibility"] = a["position_visibility"] * np.array([1, 1, 0.25, 1], np.float32)
        a["scale_opacity"] = a["scale_opacity"] * np.array([0.05, 0.05, 0.05, 1], np.float32)
    elif kind == "occluded":
        a["position_visibility"] = a["position_visibility"] * np.array([0.05, 0.05, 0.2, 1], np.float32)
        a["scale_opacity"] = a["scale_opacity"] * np.array([3, 3, 3, 1], np.float32) + np.array(
            [0, 0, 0, 0.6], np.float32
        )
    elif kind != "wide":
        raise ValueError(kind)
    return a


def edge_cloud_arrays(n: int, seed: int) -> dict:
    """A 3D cloud of the projection's edge cases seen from ``EYE``, a row in
    eight of each: at the camera or a step in front of it (inside the near
    plane), spread far past the frustum and astride its edges, zero scales,
    zero quaternions, opacities 0 and 1, long thin splats, and depths
    stretched past the camera."""
    a = random_arrays_3d_seeded(n, seed=seed)
    pv, so, rot = a["position_visibility"], a["scale_opacity"], a["rotation"]
    k = np.arange(n) % 8
    pv[k == 0, :3] = np.array(EYE, np.float32)
    pv[(k == 0) & (np.arange(n) % 16 == 8), 2] -= 0.05
    pv[k == 1, :2] *= 60.0
    so[k == 2, :3] = 0.0
    rot[k == 3] = 0.0
    so[k == 4, 3] = 0.0
    so[k == 5, 3] = 1.0
    so[k == 6, :3] *= np.array([40.0, 0.01, 0.01], np.float32)
    pv[k == 7, :3] *= np.array([3.0, 3.0, 20.0], np.float32)
    return a


def jax_cloud(arrays: dict):
    """The JAX package's cloud of the class that the field names say (as
    the port's ``cloud_from_numpy`` tells them apart)."""
    import jax.numpy as jnp

    import bevy_gaussian_splatting_tpu as bgs
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_class

    cls = getattr(bgs, cloud_class(arrays).__name__)
    return cls(**{k: jnp.asarray(v) for k, v in arrays.items()})


def torch_cloud(arrays: dict):
    return cloud_from_numpy(arrays, device="cpu")


def cameras(width: int, height: int, eye=EYE):
    """The same camera in both packages."""
    import bevy_gaussian_splatting_tpu as bgs

    return (
        bgs.Camera.create(eye=eye, target=(0.0, 0.0, 0.0), width=width, height=height),
        TCamera.create(eye=eye, target=(0.0, 0.0, 0.0), width=width, height=height, device="cpu"),
    )


# (kind, n, seed, width, height): 128x128 and the non-16 height 128x120
CASES = [
    ("bench", 2000, 3, 128, 128),
    ("bench", 2000, 3, 128, 120),
    ("wide", 400, 1, 128, 128),
    ("wide", 400, 1, 128, 120),
]
CASE_IDS = [f"{k}{n}-{w}x{h}" for k, n, _, w, h in CASES]


def jax_splats(cloud, camera, settings):
    """The JAX package's binning inputs, prepared as its render_tiled does."""
    import jax.numpy as jnp

    from bevy_gaussian_splatting_tpu.ops import sort as sort_ops
    from bevy_gaussian_splatting_tpu.ops.project import project_gaussians

    mt = jnp.eye(4, dtype=jnp.float32)
    back_key = sort_ops.radix_depth_key(
        cloud.position, mt, camera.clip_from_view @ camera.view_from_world,
        camera.world_position, settings.radix_sort_depth_bits.bits,
    )
    splats = project_gaussians(cloud, camera, settings, mt)
    splats["sort_key"] = back_key
    splats["mask"] = splats["mask"] & (back_key != sort_ops.SENTINEL_KEY)
    return splats


def overlay_settings(mode: str, **kw):
    """The same bounding-box overlay settings in both packages, for kernel
    mode ``mode`` ("obb", "aabb" or "2d"), with ``kw`` on top."""
    import bevy_gaussian_splatting_tpu as bgs
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode

    j = {"aabb": mode == "aabb", "visualize_bounding_box": True, **kw}
    t = dict(j)
    if mode == "2d":
        j["gaussian_mode"] = bgs.GaussianMode.GAUSSIAN_2D
        t["gaussian_mode"] = GaussianMode.GAUSSIAN_2D
    return bgs.CloudSettings(**j), CloudSettings(**t)


def green_pixels(img: np.ndarray) -> int:
    """Pixels whose colour is the overlay's green (an edge on top)."""
    return int((np.abs(img[..., :3] - np.array([0.3, 1.0, 0.1], np.float32)).max(axis=-1) < 1e-6).sum())


# the backward cull's rows (tests/test_torch_cull.py, tests/test_torch_cuda.py)
MODE = {"obb": tf.MODE_OBB, "aabb": tf.MODE_AABB, "2d": tf.MODE_2D}


def _tile_coords(mode, width, height, y0):
    """Columns' x and rows' y of the frame's tile 0, in ``mode``'s frame."""
    px, py = tf.tile_pixel_coords(torch.tensor([0]), width // 16, width, height, y0, MODE[mode])
    return px[0, :16], py[0, ::16]


def _nudge(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x moved by k ulps (float32, k in -2..2)."""
    out = x.clone()
    for _ in range(2):
        up = k > 0
        down = k < 0
        out = torch.where(up, torch.nextafter(out, torch.tensor(np.inf, dtype=torch.float32)), out)
        out = torch.where(down, torch.nextafter(out, torch.tensor(-np.inf, dtype=torch.float32)), out)
        k = k - up.to(k.dtype) + down.to(k.dtype)
    return out


def adversarial_rows(mode, width, height, y0, n, seed):
    """[n, param_width(mode)] rows for tile 0 of a ``width`` x ``height``
    frame placed at ``y0``: centres on pixels, between them or anywhere near
    the tile, extents snapped to one pixel's offset and moved by -2 ... 2
    ulps."""
    rng = np.random.default_rng(seed)
    colx, rowy = _tile_coords(mode, width, height, y0)
    spacing_x = float(colx[1] - colx[0])
    spacing_y = float(rowy[0] - rowy[1])
    # centres on pixels, halfway between them, or anywhere in and around the tile
    ci = rng.integers(0, 16, n)
    ri = rng.integers(0, 16, n)
    jitter = rng.choice([0.0, 0.5, -0.5], n)[:, None] * np.array([spacing_x, spacing_y])
    free = rng.uniform(-3, 19, (n, 2)) * np.array([spacing_x, -spacing_y]) + np.array([float(colx[0]), float(rowy[0])])
    pick = rng.random(n) < 0.3
    cx = np.where(pick, free[:, 0], colx.numpy()[ci] + jitter[:, 0]).astype(np.float32)
    cy = np.where(pick, free[:, 1], rowy.numpy()[ri] + jitter[:, 1]).astype(np.float32)
    cx_t, cy_t = torch.from_numpy(cx), torch.from_numpy(cy)
    # a target pixel per row, whose offset sets an extent
    tx_ = torch.from_numpy(rng.integers(0, 16, n))
    ty_ = torch.from_numpy(rng.integers(0, 16, n))
    ox = colx[tx_] - cx_t  # the kernel's rounded offsets, pixel minus centre
    oy = rowy[ty_] - cy_t
    k = torch.from_numpy(rng.integers(-2, 3, n))
    cols = tf.param_width(MODE[mode])
    rows = torch.zeros((n, cols), dtype=torch.float32)
    rows[:, 0], rows[:, 1] = cx_t, cy_t
    ro = tf.rgb_row(MODE[mode])
    rows[:, ro : ro + 3] = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    rows[:, ro + 3] = torch.from_numpy(rng.uniform(0.05, 1, n).astype(np.float32))
    if mode == "obb":
        theta = rng.uniform(0, np.pi, n)
        axis = rng.random(n) < 0.3  # some axis-aligned, where u or v is one offset
        theta = np.where(axis, rng.choice([0.0, np.pi / 2], n), theta)
        e1 = torch.from_numpy(np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32))
        rows[:, 2:4] = e1
        # |u| = 1 at the target pixel: b1 = |dx e1x + dy e1y| in float32, then
        # moved by k ulps; b2 likewise for v, or free
        b1 = (ox * e1[:, 0] + oy * e1[:, 1]).abs()
        b2 = (ox * e1[:, 1] - oy * e1[:, 0]).abs()
        free_b = torch.from_numpy(np.exp(rng.uniform(np.log(0.05), np.log(60.0), (n, 2))).astype(np.float32))
        snap = torch.from_numpy(rng.integers(0, 3, n))  # 0: b1 snapped, 1: b2 snapped, 2: both
        b1 = torch.where(snap != 1, _nudge(b1, k), free_b[:, 0])
        b2 = torch.where(snap != 0, _nudge(b2, -k), free_b[:, 1])
        rows[:, 4], rows[:, 5] = torch.clamp(b1, min=1e-6), torch.clamp(b2, min=1e-6)
    elif mode == "aabb":
        r = torch.maximum(ox.abs(), oy.abs())
        rows[:, 5] = _nudge(r, k)
        # a conic with power <= 0 near the centre and > 0 nowhere needed
        s = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1.0), (n, 2))).astype(np.float32))
        rows[:, 2], rows[:, 4] = s[:, 0], s[:, 1]
        rows[:, 3] = torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32)) * torch.sqrt(s[:, 0] * s[:, 1])
    else:
        inv_w, inv_h, _ = tf._surfel_constants(width, height)
        # mr with fl(mr / W) or fl(mr / H) at one offset, then k ulps
        on_x = rng.random(n) < 0.5
        mr = torch.where(torch.from_numpy(on_x), ox.abs() / inv_w, oy.abs() / inv_h)
        rows[:, 2] = _nudge(mr.to(torch.float32), k)
        rows[:, 3:12] = torch.from_numpy(rng.normal(0, 1, (n, 9)).astype(np.float32))
        rows[:, 11] = rows[:, 11].abs() + 0.5  # C.z away from 0
    return rows


def special_rows(mode, width, height, y0):
    """Rows with a known mask: [(row, expected mask), ...]."""
    colx, rowy = _tile_coords(mode, width, height, y0)
    cx, cy = float(colx[7]), float(rowy[7])
    cols = tf.param_width(MODE[mode])
    out = []

    def row(**kw):
        r = torch.zeros(cols, dtype=torch.float32)
        r[0], r[1] = cx, cy
        ro = tf.rgb_row(MODE[mode])
        r[ro : ro + 4] = torch.tensor([0.5, 0.5, 0.5, 0.8])
        for i, v in kw.items():
            r[int(i[1:])] = v
        return r

    if mode == "obb":
        out += [(row(c2=1.0, c4=0.0, c5=3.0), 0), (row(c2=1.0, c4=-2.0, c5=3.0), 0)]  # b1 <= 0: empty
        out += [(row(c2=0.6, c3=0.8, c4=1e4, c5=1e4), 0xFF)]  # covers the tile
        out += [(row(c2=0.0, c3=0.0, c4=1.0, c5=1.0), 0xFF)]  # no axis: u = v = 0 everywhere
        out += [(row(c2=1.0, c4=3.0, c5=-1.0), None)]  # b2 <= 0 with b1 > 0
    elif mode == "aabb":
        out += [(row(c2=0.1, c4=0.1, c5=0.0), None)]  # r = 0, centre on a pixel: that warp only
        out += [(row(c2=1e-4, c4=1e-4, c5=1e5), 0xFF)]
        out += [(row(c2=0.1, c4=0.1, c5=-1.0), None)]
    else:
        # a square whose bottom edge is the boundary between rows 7 and 8:
        # centre on row 3.5, half-height to row 7 exactly, then one ulp more
        inv_h = tf._surfel_constants(width, height)[1]
        mid = (rowy[3] + rowy[4]) * 0.5
        half = float((rowy[7] - mid).abs())
        for mr in (half / inv_h, float(np.nextafter(np.float32(half / inv_h), np.float32(np.inf)))):
            r = row(c2=mr, c11=1.0, c3=1.0, c7=1.0)
            r[1] = mid
            out.append((r, None))
        out += [(row(c2=1e4, c11=1.0, c3=50.0, c7=50.0), 0xFF)]
    return out


# the expansion's adversarial counts (tests/test_torch_pairs.py on the CPU,
# tests/test_torch_cuda.py on the card); the window matches csrc/expand.cu
EXPAND_COUNT_CASES = ["zero-runs0", "zero-runs1", "whole-frame", "n1", "n0", "all-inactive"]


def expand_counts(case: str, p_max: int) -> torch.Tensor:
    """Inclusive counts ``cum`` [N] int32 for the expansion: random counts
    with interior runs of zero-count ranks longer than a block's window
    ("zero-runs<seed>", clamped at ``p_max``), one splat over all 120 x 68
    tiles of 1920x1080, one gaussian, none, or 50 inactive ones."""
    if case.startswith("zero-runs"):
        from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import WINDOW

        rng = np.random.default_rng(int(case[len("zero-runs"):]))
        n, longest = 6000, 2000
        counts = rng.integers(1, 4, n)
        for _ in range(4):
            s = int(rng.integers(0, n - longest))
            counts[s : s + int(rng.integers(WINDOW + 1, longest))] = 0
        return torch.from_numpy(np.minimum(np.cumsum(counts), p_max).astype(np.int32))
    values = {"whole-frame": [8160], "n1": [3], "n0": [], "all-inactive": [0] * 50}[case]
    return torch.tensor(values, dtype=torch.int32)


def expand_table(cum: torch.Tensor, seed: int = 0):
    """A full expansion table around ``cum``: rect widths 0-4 (0 where a
    rank owns no slot; a whole-frame splat 120 wide), rectangle corners and
    a permutation, all int32 [N]."""
    n = cum.shape[0]
    rng = np.random.default_rng(seed)
    counts = torch.diff(cum.to(torch.int64), prepend=torch.zeros(1, dtype=torch.int64)).numpy()
    rect_w = np.where(counts > 0, rng.integers(1, 5, n), 0)
    rect_w[counts == 8160] = 120
    cols = [rect_w, rng.integers(0, 10, n), rng.integers(0, 10, n), rng.permutation(n)]
    return (cum, *(torch.from_numpy(np.asarray(c, np.int32)) for c in cols))


def long_run_counts(seed: int = 0, n: int = 1_000_000, most: int = 12) -> torch.Tensor:
    """Inclusive counts ``cum`` [n] int32 shaped like the 4DGS scene's at
    1920x1080 (random_gaussians_4d_seeded(1M, seed=3): 6 pairs a rank on
    average, the longest rank 90): 0 to ``most`` slots a rank, so that most
    runs of 128 ranks pass the reduce's 6,144-float staging buffer."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.cumsum(rng.integers(0, most + 1, n)).astype(np.int32))


def reduce_counts(seed: int, cols: int, stage_floats: int, n: int = 20000) -> torch.Tensor:
    """Inclusive counts ``cum`` [n] int32 for the reduce: 0-3 slots a rank
    (so runs start at odd slots), five empty ranks first, and one rank
    whose rows of ``cols`` floats are twice the ``stage_floats`` staging
    buffer."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, n)
    counts[:5] = 0
    counts[int(rng.integers(n // 5, 4 * n // 5))] = 2 * stage_floats // cols
    return torch.from_numpy(np.cumsum(counts).astype(np.int32))


# The SH colour stage (ops/cuda/sh.py, tests/test_torch_sh_grad.py and the
# card cases in tests/test_torch_cuda.py): 3D rows evaluated through degree
# 0-3, a degree-4 row (evaluated through 3, its last 28 columns unread) and
# the 4D row; d_dir and d_dir_t within SH_GRAD_REL (norm of the difference
# over norm) of float64 autograd.
SH_KINDS = ["deg0", "deg1", "deg2", "deg3", "deg4-row", "4d"]
SH_GRAD_REL = 1e-5


def sh_stage_inputs(kind: str, n: int, seed: int) -> dict:
    """The colour stage's inputs as numpy: ``d`` [n, 3] unit directions, the
    first ten on the axes and near the poles, ``sh`` [n, W], ``dir_t`` [n]
    and ``duration`` (4D, else None) and a cotangent ``g`` [n, 3] with
    every fifth row 0 (so that its products are signed zeros)."""
    d = np.random.default_rng(seed).normal(size=(n, 3))
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    near_pole = np.array([[1e-4, 0.0, 1.0], [0.0, -3e-5, -1.0], [2e-6, 1e-6, 1.0], [0.0, 1.0, 1e-5]])
    d[: len(axes)] = axes
    d[len(axes): len(axes) + len(near_pole)] = near_pole
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rng = np.random.default_rng(100 + seed)
    if kind == "4d":
        sh = rng.normal(size=(n, 144)).astype(np.float32)
        dir_t = (rng.normal(size=n) * 0.4).astype(np.float32)
        duration = np.float32(1.0 + 0.25 * seed)
    else:
        degree = 4 if kind == "deg4-row" else int(kind[3:])
        sh = rng.normal(size=(n, sh_coeff_width(degree))).astype(np.float32)
        dir_t = duration = None
    g = rng.normal(size=(n, 3)).astype(np.float32)
    g[::5] = 0.0
    return {"d": d, "sh": sh, "dir_t": dir_t, "duration": duration, "g": g}


def sh_stage_tensors(inp: dict, device="cpu", dtype=torch.float32) -> list:
    """direction, sh, dir_t, duration of ``inp`` as tensors, all but
    duration requiring grad (dir_t and duration None in 3D)."""
    def leaf(a):
        return torch.tensor(a, dtype=dtype, device=device).requires_grad_()

    out = [leaf(inp["d"]), leaf(inp["sh"])]
    if inp["dir_t"] is None:
        return out + [None, None]
    return out + [leaf(inp["dir_t"]), torch.tensor(inp["duration"], dtype=dtype, device=device)]


def sh_stage_grads(rgb: torch.Tensor, leaves: list, g) -> tuple:
    """(d_dir, d_sh[, d_dir_t]) of ``rgb`` at the cotangent ``g``; None for
    a leaf the colour does not read."""
    wrt = [t for t in leaves[:3] if t is not None]
    return torch.autograd.grad(rgb, wrt, torch.as_tensor(g, dtype=rgb.dtype, device=rgb.device), allow_unused=True)


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Norm of the difference over the norm of ``want``."""
    return float((got.double() - want.double()).norm() / want.double().norm())
