"""PyTorch port, the bounding-box overlay (``CloudSettings(visualize_bounding_box
=True)``) on the CPU against the JAX package, in OBB, AABB and 2DGS: serving
and the oracle (training: test_torch_overlay_train.py).

The JAX package draws the overlay on three paths that do not give the same
image, and each port path is held to its own counterpart.  Here:

  - serving: the plain overlay compositor against the Pallas forward kernel's
    ``bbox=True`` branch (``pallas_forward_raw`` in interpret mode), and
    ``render()`` against ``render_tiled(compositor="pallas",
    differentiable=False)``; edges gated by the packed alpha > 0;
  - the oracle against the JAX oracle; edges gated by the mask, so a
    gaussian of opacity 0 in the mask gets a box there and on no tiled path.

Bar: 2e-5 (2DGS 1e-4, the JAX package's 2DGS bar).  ``pytest -s`` prints
the measured errors and the green pixels.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops.pallas.tile_fwd import pallas_forward_raw
from bevy_gaussian_splatting_tpu.ops.rasterize_ref import render_oracle as j_oracle
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tfwd
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_ref import render_oracle as t_oracle
from bevy_gaussian_splatting_tpu_torch.render import api
from torch_port_cases import cameras, cloud_arrays, green_pixels, jax_cloud, jax_splats, overlay_settings, torch_cloud

MODES = ("obb", "aabb", "2d")
IMAGE_BAR = {"obb": 2e-5, "aabb": 2e-5, "2d": 1e-4}
BG = np.array([0.2, 0.1, 0.4, 1.0], np.float32)


def _arrays() -> dict:
    return cloud_arrays("wide", 400, 1)


@functools.lru_cache(maxsize=None)
def _jax_kernel_case(mode, width, height):
    """The JAX package's serving inputs with the overlay and the Pallas
    kernel's raw output: (start, count, pair-sorted params, chunk, raw)."""
    js_, _ = overlay_settings(mode)
    jc, _ = cameras(width, height)
    cloud = jax_cloud(_arrays())
    splats = jax_splats(cloud, jc, js_)
    p_max = jrt.pairs_budget(400, int(jrt.pair_count(cloud, jc, js_)))
    g_s, tile_s = jrt.bin_gaussians(splats, js_, width, height, p_max, expand="pallas", interpret=True)[:2]
    num_tiles = (width // 16) * (jrt.pad_to_tile(height) // 16)
    start, end = jrt.tile_ranges(tile_s, num_tiles)
    count = jnp.minimum(end - start, jrt.tile_budget(400))
    params = jrt.pack_raster_params(splats, js_, width, height)[g_s]
    chunk = tfwd.preferred_chunk(p_max, num_tiles)
    raw = pallas_forward_raw(
        params, start, count, js_, width, jrt.pad_to_tile(height),
        interpret=True, chunk_size=chunk, full_height=height,
    )
    return (np.array(start), np.array(count, np.int32), np.array(params), chunk,
            np.asarray(raw).reshape(num_tiles, 8, 256)[:, :4])


KERNEL_CASES = [(m, w, h) for m in MODES for w, h in ((128, 128), (128, 120))]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[f"{m}-{w}x{h}" for m, w, h in KERNEL_CASES])
def test_plain_overlay_matches_pallas_kernel(case):
    mode, width, height = case
    start, count, params, chunk, ref = _jax_kernel_case(mode, width, height)
    kmode = {"obb": tfwd.MODE_OBB, "aabb": tfwd.MODE_AABB, "2d": tfwd.MODE_2D}[mode]
    args = (torch.from_numpy(params), torch.from_numpy(start), torch.from_numpy(count), width // 16, width, height)
    got = tfwd.composite_tiles_raw(*args, chunk=chunk, mode=kmode, bbox=True).numpy()
    plain = tfwd.composite_tiles_raw(*args, chunk=chunk, mode=kmode).numpy()
    err = float(np.abs(got - ref).max())
    # an edge drives T to exactly 0; the overlay changes the image
    boxed = int((got[:, 3] == 0.0).sum())
    print(f"\n[{mode} {width}x{height}] plain overlay vs Pallas bbox kernel {err:.3e}, T == 0 at {boxed} pixels")
    assert err <= IMAGE_BAR[mode]
    assert boxed > 100 and np.abs(plain - got).max() > 0.1


def _jax_serving(mode, width, height, bg):
    js_, _ = overlay_settings(mode)
    jc, _ = cameras(width, height)
    cloud = jax_cloud(_arrays())
    bucket = jrt.pairs_budget(400, int(jrt.pair_count(cloud, jc, js_)))
    return np.asarray(jrt.render_tiled(
        cloud, jc, js_, background=jnp.asarray(bg), differentiable=False, compositor="pallas", pairs_max=bucket,
    ))


@pytest.mark.parametrize("mode", MODES)
def test_overlay_render_matches_jax_serving_path(mode):
    width, height = 128, 120
    ref = _jax_serving(mode, width, height, BG)
    _, ts_ = overlay_settings(mode)
    _, tc = cameras(width, height)
    api._BUDGET_STATE.clear()
    got = api.render(torch_cloud(_arrays()), tc, ts_, background=torch.from_numpy(BG), device="cpu").numpy()
    assert got.shape == (height, width, 4) and np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    print(f"\n[{mode} {width}x{height} bg] overlay render() vs JAX serving {err:.3e}, green pixels {green_pixels(got)}")
    assert err <= IMAGE_BAR[mode]
    assert green_pixels(got) > 100


@pytest.mark.parametrize("mode", MODES)
def test_overlay_oracle_matches_jax_oracle(mode):
    jc, tc = cameras(64, 64)
    js_, ts_ = overlay_settings(mode)
    ref = np.asarray(j_oracle(jax_cloud(_arrays()), jc, js_, background=jnp.asarray(BG)))
    got = t_oracle(torch_cloud(_arrays()), tc, ts_, background=torch.from_numpy(BG)).numpy()
    err = float(np.abs(got - ref).max())
    print(f"\n[{mode} 64x64] overlay oracle vs JAX oracle {err:.3e}, green pixels {green_pixels(got)}")
    assert err <= IMAGE_BAR[mode]
    assert green_pixels(got) > 50


