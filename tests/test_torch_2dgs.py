"""PyTorch port, 2DGS surfels (``CloudSettings(gaussian_mode=GAUSSIAN_2D)``) on
the CPU against the JAX package, serving:

  - projection (the surfel homography, its centre and radius, the validity
    folded into the mask) and the 16 packed columns (the folded affine
    coefficients A, B, C);
  - the integer binning of the surfel square, array-equal to the JAX
    package's Pallas-expansion binning;
  - the plain forward compositor against the Pallas forward kernel run in
    interpret mode in its 2DGS branch;
  - ``render()`` and the port's oracle against the JAX serving path and the
    JAX oracle, on the padded grid, with a solid background and on the
    surfel grid of ``tools/surfel_plane.py``.

Bar for images: 1e-4, the JAX package's own 2DGS bar (tests/test_tiled.py,
tests/test_pallas.py): near the reciprocal's pz ~ 0 singularity and under
the doubled-frame distance (2 width^2 per NDC unit squared) an ulp moves g by
up to ~1e-4.  The measured errors print with ``pytest -s``.  The JAX side is
computed once per case and module.  Sizes are test_pallas.py's: 400
gaussians at 64x64, 128x120 for the padded grid, and the 16-surfel grid.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops.gaussian_2d import surfel_affine_coeffs as j_affine
from bevy_gaussian_splatting_tpu.ops.pallas.tile_fwd import pallas_forward_raw
from bevy_gaussian_splatting_tpu.ops.rasterize_ref import render_oracle as j_oracle
from bevy_gaussian_splatting_tpu_torch.models.cloud import surfel_grid_arrays
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.models.settings import GaussianMode as TMode
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tfwd
from bevy_gaussian_splatting_tpu_torch.ops.cuda.project import pack_raster_param_cols as tpack
from bevy_gaussian_splatting_tpu_torch.ops.gaussian_2d import surfel_affine_coeffs as t_affine
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians as tproject
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_ref import render_oracle as t_oracle
from bevy_gaussian_splatting_tpu_torch.render import api
from torch_port_cases import SURFEL_EYE, cameras, cloud_arrays, jax_cloud, jax_splats, torch_cloud

J_2D = bgs.CloudSettings(gaussian_mode=bgs.GaussianMode.GAUSSIAN_2D)
T_2D = TSettings(gaussian_mode=TMode.GAUSSIAN_2D)
IMAGE_BAR = 1e-4
BG = np.array([0.2, 0.1, 0.4, 1.0], np.float32)
# (cloud, width, height): test_pallas.py's size, the padded grid, the surfel grid
CASES = [("wide400", 64, 64), ("wide400", 128, 120), ("surfels", 64, 64)]
CASE_IDS = [f"{c}-{w}x{h}" for c, w, h in CASES]


def _arrays(name: str) -> dict:
    return surfel_grid_arrays() if name == "surfels" else cloud_arrays("wide", 400, 1)


def _cameras(name: str, width: int, height: int):
    return cameras(width, height, SURFEL_EYE) if name == "surfels" else cameras(width, height)


@functools.lru_cache(maxsize=None)
def _jax_case(name, width, height):
    """The JAX package's 2DGS serving inputs, as numpy: (splats, p_max,
    (g_s, tile_s, total), start, count, pair-sorted params, chunk)."""
    jc, _ = _cameras(name, width, height)
    cloud = jax_cloud(_arrays(name))
    n = len(cloud)
    js = jax_splats(cloud, jc, J_2D)
    p_max = jrt.pairs_budget(n, int(jrt.pair_count(cloud, jc, J_2D)))
    g_s, tile_s, _, total = jrt.bin_gaussians(js, J_2D, width, height, p_max, expand="pallas", interpret=True)
    num_tiles = (width // 16) * (jrt.pad_to_tile(height) // 16)
    start, end = jrt.tile_ranges(tile_s, num_tiles)
    count = jnp.minimum(end - start, jrt.tile_budget(n))
    params = jrt.pack_raster_params(js, J_2D, width, height)[g_s]
    splats = {k: np.asarray(v) for k, v in js.items()}
    chunk = tfwd.preferred_chunk(p_max, num_tiles)
    return (
        splats, p_max, (np.asarray(g_s), np.asarray(tile_s), int(total)),
        np.array(start), np.array(count, np.int32), np.array(params), chunk,
    )


def test_surfel_grid_is_make_surfel_grid():
    spec = importlib.util.spec_from_file_location(
        "surfel_plane", Path(__file__).resolve().parents[1] / "tools" / "surfel_plane.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ref = module.make_surfel_grid(n_side=4, seed=5)
    got = surfel_grid_arrays(n_side=4, seed=5)
    for field, value in got.items():
        np.testing.assert_array_equal(value, np.asarray(getattr(ref, field)), err_msg=field)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_2dgs_projection_and_packing_match_jax(case):
    name, width, height = case
    js = _jax_case(name, width, height)[0]
    _, tc = _cameras(name, width, height)
    ts = tproject(torch_cloud(_arrays(name)), tc, T_2D)
    assert not {"obb_axis", "obb_bounds", "conic", "radius_vp"} & set(ts)
    m = js["mask"]
    assert m.sum() >= (12 if name == "surfels" else 300)
    np.testing.assert_array_equal(ts["mask"].numpy(), m)
    for k in ("surfel_t", "mean_2d", "surfel_radius", "center_ndc"):
        ref = js[k][m]
        np.testing.assert_allclose(ts[k].numpy()[m], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(), err_msg=k)
    # the affine coefficients of the same homography: XLA fuses each cross
    # product term into a multiply-add (inside the jitted jnp.cross), and so
    # does the port, so A and B are bit-equal.  C: eager JAX rounds m2x*u +
    # m2y*v + w unfused where the port fuses as compiled JAX does, and the
    # terms cancel: within 1e-4 of the column's largest
    jA, jB, jC = (np.asarray(v)[m] for v in j_affine(jnp.asarray(js["surfel_t"]), jnp.asarray(js["mean_2d"]), width))
    tA, tB, tC = (v.numpy()[m] for v in t_affine(torch.from_numpy(js["surfel_t"]), torch.from_numpy(js["mean_2d"]), width))
    np.testing.assert_array_equal(tA, jA)
    np.testing.assert_array_equal(tB, jB)
    np.testing.assert_allclose(tC, jC, rtol=0, atol=1e-4 * np.abs(jC).max())
    jcols = jrt.pack_raster_param_cols(js, J_2D, width, height)
    tcols = tpack(ts, T_2D, width, height)
    assert len(tcols) == len(jcols) == tfwd.param_width(tfwd.MODE_2D) == 16
    for i, (t, j) in enumerate(zip(tcols, jcols)):
        ref = np.asarray(j)[m]
        atol = (1e-4 if 9 <= i < 12 else 1e-5) * np.abs(ref).max()
        np.testing.assert_allclose(t.numpy()[m], ref, rtol=1e-5, atol=atol, err_msg=f"col {i}")
    assert trt.kernel_mode(T_2D) == tfwd.MODE_2D and tfwd.rgb_row(tfwd.MODE_2D) == 12


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_2dgs_binning_matches_jax(case):
    name, width, height = case
    js, p_max, (g_s, tile_s, total), start, count, _, _ = _jax_case(name, width, height)
    shared = {k: torch.from_numpy(js[k].copy()) for k in ("center_ndc", "surfel_radius", "mask")}
    shared["sort_key"] = torch.from_numpy(js["sort_key"].astype(np.int64))
    bins = trt.bin_gaussians(shared, width, height, p_max)
    assert int(bins[3]) == total and 0 < total < p_max
    np.testing.assert_array_equal(bins[0].numpy(), g_s)
    np.testing.assert_array_equal(bins[1].numpy(), tile_s)
    tb = trt.tile_bins(shared, width, height, p_max)
    np.testing.assert_array_equal(tb.start.numpy(), start)
    np.testing.assert_array_equal(tb.count.numpy(), count)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_2dgs_plain_compositor_matches_pallas(case):
    name, width, height = case
    _, _, _, start, count, params, chunk = _jax_case(name, width, height)
    ref = np.asarray(pallas_forward_raw(
        jnp.asarray(params), jnp.asarray(start), jnp.asarray(count), J_2D, width, jrt.pad_to_tile(height),
        interpret=True, chunk_size=chunk, full_height=height,
    )).reshape(start.shape[0], 8, 256)[:, :4]
    got = tfwd.composite_tiles_raw(
        torch.from_numpy(params), torch.from_numpy(start), torch.from_numpy(count),
        width // 16, width, height, chunk=chunk, mode=tfwd.MODE_2D,
    ).numpy()
    err = float(np.abs(got - ref).max())
    print(f"\n[{name} {width}x{height}] plain 2DGS compositor vs Pallas: {err:.3e}")
    assert err <= IMAGE_BAR
    assert (ref[:, 3] < 0.99).sum() > (300 if name == "surfels" else 1000)  # the surfels cover the frame
    with pytest.raises(ValueError, match="16"):  # a 10-column table is not a surfel table
        tfwd.composite_tiles_raw(torch.from_numpy(params[:, :10].copy()), torch.from_numpy(start),
                                 torch.from_numpy(count), width // 16, width, height, mode=tfwd.MODE_2D)


def _jax_serving(name, width, height, bg):
    jc, _ = _cameras(name, width, height)
    cloud = jax_cloud(_arrays(name))
    bucket = jrt.pairs_budget(len(cloud), int(jrt.pair_count(cloud, jc, J_2D)))
    return np.asarray(jrt.render_tiled(
        cloud, jc, J_2D, background=jnp.asarray(bg), differentiable=False, compositor="pallas", pairs_max=bucket,
    ))


@pytest.mark.parametrize("case,with_bg", [(CASES[0], False), (CASES[1], True), (CASES[2], False)],
                         ids=[CASE_IDS[0], CASE_IDS[1] + "-bg", CASE_IDS[2]])
def test_2dgs_render_matches_jax_serving_path(case, with_bg):
    name, width, height = case
    bg = BG if with_bg else np.zeros(4, np.float32)
    ref = _jax_serving(name, width, height, bg)
    _, tc = _cameras(name, width, height)
    api._BUDGET_STATE.clear()
    got = api.render(torch_cloud(_arrays(name)), tc, T_2D, background=torch.from_numpy(bg), device="cpu").numpy()
    assert got.shape == (height, width, 4) and np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    print(f"\n[{name} {width}x{height}{' bg' if with_bg else ''}] 2DGS render() vs JAX: {err:.3e}")
    assert err <= IMAGE_BAR
    assert (np.abs(ref[..., :3]).max(axis=-1) > 1.0 / 255.0).sum() > 0.1 * width * height


@pytest.mark.parametrize("case", [CASES[1], CASES[2]], ids=[CASE_IDS[1], CASE_IDS[2]])
def test_2dgs_oracle_matches_jax_oracle_and_tiled(case):
    name, width, height = case
    jc, tc = _cameras(name, width, height)
    bg = torch.from_numpy(BG)
    ref = np.asarray(j_oracle(jax_cloud(_arrays(name)), jc, J_2D, background=jnp.asarray(BG)))
    cloud = torch_cloud(_arrays(name))
    got = t_oracle(cloud, tc, T_2D, background=bg).numpy()
    tiled = api.render(cloud, tc, T_2D, background=bg, device="cpu").numpy()
    errs = float(np.abs(got - ref).max()), float(np.abs(tiled - got).max())
    print(f"\n[{name} {width}x{height}] 2DGS oracle vs JAX oracle {errs[0]:.3e}, tiled vs oracle {errs[1]:.3e}")
    assert max(errs) <= IMAGE_BAR
