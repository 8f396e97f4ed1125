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
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera as TCamera
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    cloud_from_numpy,
    random_arrays_3d_seeded,
)

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


def jax_cloud(arrays: dict):
    return bgs.Gaussian3dCloud(**{k: jnp.asarray(v) for k, v in arrays.items()})


def torch_cloud(arrays: dict):
    return cloud_from_numpy(arrays, device="cpu")


def cameras(width: int, height: int, eye=EYE):
    """The same camera in both packages."""
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
