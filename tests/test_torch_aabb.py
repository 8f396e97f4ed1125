"""PyTorch port, AABB bounds (``CloudSettings(aabb=True)``) on the CPU against
the JAX package, serving and training:

  - projection (conic, radius) and packing, and the integer binning of the
    AABB square, array-equal to the JAX package's Pallas-expansion binning;
  - the plain forward compositor against the Pallas forward kernel, and the
    plain backward compositor against the Pallas backward kernel, both run
    in interpret mode in their AABB branch;
  - ``render()`` and the port's oracle against the JAX serving path and the
    JAX oracle;
  - gradients of every cloud field through the port's hand-derived backward
    against ``jax.grad`` of the Pallas training path.

The JAX side is computed once per case and module.  Sizes are
test_pallas.py's: 400 gaussians at 64x64, and 128x120 for the padded grid.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops.pallas.tile_bwd import pallas_composite_backward
from bevy_gaussian_splatting_tpu.ops.pallas.tile_fwd import pallas_forward_raw
from bevy_gaussian_splatting_tpu.ops.rasterize_ref import render_oracle as j_oracle
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_bwd as tbwd
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tfwd
from bevy_gaussian_splatting_tpu_torch.ops.cuda.project import pack_raster_param_cols as tpack
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians as tproject
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_ref import render_oracle as t_oracle
from bevy_gaussian_splatting_tpu_torch.render import api
from bevy_gaussian_splatting_tpu_torch.train.losses import mse
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud
from torch_port_cases import cameras, cloud_arrays, jax_cloud, jax_splats, torch_cloud

J_AABB = bgs.CloudSettings(aabb=True)
T_AABB = TSettings(aabb=True)
FIELDS = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")
SIZES = [(64, 64), (128, 120)]
SIZE_IDS = [f"{w}x{h}" for w, h in SIZES]
BG = np.array([0.2, 0.1, 0.4, 1.0], np.float32)
BWD_BAR = 1e-4  # per gradient column, of its largest |JAX| (test_torch_backward.py)
GRAD_BAR = 3e-3  # per cloud field, of its largest |JAX| (test_pallas.py)


def _arrays(name: str = "wide400") -> dict:
    a = cloud_arrays("wide", 400, 1)
    if name == "pallas400":  # test_pallas.py TestPallasBackward._grad_parity
        a["scale_opacity"] = a["scale_opacity"] * np.array([1, 2, 0.5, 1], np.float32)
    elif name == "dead400":  # half the slots dead, as the convergence protocol's init
        a["scale_opacity"][::2] = 0.0
        a["position_visibility"][::2, 3] = 0.0
    return a


@functools.lru_cache(maxsize=None)
def _jax_case(width, height):
    """The JAX package's AABB serving inputs for the wide400 cloud, as numpy:
    (splats, p_max, (g_s, tile_s, total), start, count, pair-sorted params,
    chunk)."""
    jc, _ = cameras(width, height)
    cloud = jax_cloud(_arrays())
    js = jax_splats(cloud, jc, J_AABB)
    p_max = jrt.pairs_budget(400, int(jrt.pair_count(cloud, jc, J_AABB)))
    g_s, tile_s, _, total = jrt.bin_gaussians(js, J_AABB, width, height, p_max, expand="pallas", interpret=True)
    num_tiles = (width // 16) * (jrt.pad_to_tile(height) // 16)
    start, end = jrt.tile_ranges(tile_s, num_tiles)
    count = jnp.minimum(end - start, jrt.tile_budget(400))
    params = jrt.pack_raster_params(js, J_AABB, width, height)[g_s]
    splats = {k: np.asarray(v) for k, v in js.items()}
    chunk = tfwd.preferred_chunk(p_max, num_tiles)
    return (
        splats, p_max, (np.asarray(g_s), np.asarray(tile_s), int(total)),
        np.array(start), np.array(count, np.int32), np.array(params), chunk,
    )


@functools.lru_cache(maxsize=None)
def _jax_raw(width, height):
    """Pallas forward raw output [T, 8, 256] of the AABB case."""
    _, _, _, start, count, params, chunk = _jax_case(width, height)
    h_pad = jrt.pad_to_tile(height)
    raw = pallas_forward_raw(
        jnp.asarray(params), jnp.asarray(start), jnp.asarray(count), J_AABB, width, h_pad,
        interpret=True, chunk_size=chunk, full_height=height,
    )
    return np.asarray(raw).reshape(start.shape[0], 8, 256)


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_aabb_projection_and_packing_match_jax(size):
    width, height = size
    js = _jax_case(width, height)[0]
    _, tc = cameras(width, height)
    ts = tproject(torch_cloud(_arrays()), tc, T_AABB)
    assert "obb_axis" not in ts and "obb_bounds" not in ts
    m = js["mask"]
    assert m.sum() > 100
    np.testing.assert_array_equal(ts["mask"].numpy(), m)
    for k in ("conic", "radius_vp", "center_ndc"):
        np.testing.assert_allclose(ts[k].numpy()[m], js[k][m], rtol=1e-5, atol=1e-5, err_msg=k)
    jcols = jrt.pack_raster_param_cols(js, J_AABB, width, height)
    tcols = tpack(ts, T_AABB, width, height)
    assert len(tcols) == len(jcols) == 10
    for i, (t, j) in enumerate(zip(tcols, jcols)):
        np.testing.assert_allclose(t.numpy()[m], np.asarray(j)[m], rtol=1e-5, atol=1e-5, err_msg=f"col {i}")
    assert trt.kernel_mode(T_AABB) == tfwd.MODE_AABB and trt.kernel_mode(TSettings()) == tfwd.MODE_OBB


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_aabb_binning_matches_jax(size):
    width, height = size
    js, p_max, (g_s, tile_s, total), start, count, _, _ = _jax_case(width, height)
    shared = {k: torch.from_numpy(js[k].copy()) for k in ("center_ndc", "conic", "radius_vp", "mask")}
    shared["sort_key"] = torch.from_numpy(js["sort_key"].astype(np.int64))
    bins = trt.bin_gaussians(shared, width, height, p_max)
    assert int(bins[3]) == total and 0 < total < p_max
    np.testing.assert_array_equal(bins[0].numpy(), g_s)
    np.testing.assert_array_equal(bins[1].numpy(), tile_s)
    tb = trt.tile_bins(shared, width, height, p_max)
    np.testing.assert_array_equal(tb.start.numpy(), start)
    np.testing.assert_array_equal(tb.count.numpy(), count)
    # the AABB square covers more tiles than the OBB rectangle of the same splats
    jc, _ = cameras(width, height)
    assert total > int(jrt.pair_count(jax_cloud(_arrays()), jc, bgs.CloudSettings()))


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_aabb_plain_compositor_matches_pallas(size):
    width, height = size
    _, _, _, start, count, params, chunk = _jax_case(width, height)
    ref = _jax_raw(width, height)[:, :4]
    got = tfwd.composite_tiles_raw(
        torch.from_numpy(params), torch.from_numpy(start), torch.from_numpy(count),
        width // 16, width, height, chunk=chunk, mode=tfwd.MODE_AABB,
    ).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    assert (ref[:, 3] < 0.99).sum() > 1000  # the splats cover much of the frame
    obb = tfwd.composite_tiles_raw_plain(
        torch.from_numpy(params), torch.from_numpy(start), torch.from_numpy(count),
        width // 16, width, height, chunk=chunk,
    ).numpy()
    assert np.abs(obb - ref).max() > 1e-2  # the mode is not ignored


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_aabb_plain_backward_matches_pallas(size):
    width, height = size
    _, _, _, start, count, params, chunk = _jax_case(width, height)
    raw = _jax_raw(width, height)
    rng = np.random.default_rng(width + height)
    gbar = np.concatenate(
        [rng.normal(0.0, 1e-3, (start.shape[0], 4, 256)).astype(np.float32), raw[:, :4]], axis=1
    )
    ref = np.asarray(pallas_composite_backward(
        jnp.asarray(params), jnp.asarray(start), jnp.asarray(count), jnp.asarray(gbar), J_AABB,
        width, jrt.pad_to_tile(height), interpret=True, full_height=height, chunk_size=chunk,
    ))
    got = tbwd.composite_backward(
        torch.from_numpy(params), torch.from_numpy(start), torch.from_numpy(count),
        torch.from_numpy(gbar), width // 16, width, height, chunk=chunk, mode=tfwd.MODE_AABB,
    ).numpy()
    assert got.shape == ref.shape == (params.shape[0], 10)
    # the radius only masks: exactly zero on both sides
    assert not got[:, 5].any() and not ref[:, 5].any()
    live = [c for c in range(10) if c != 5]
    scale = np.abs(ref[:, live]).max(axis=0)
    assert (scale > 0).all(), "a gradient column is identically zero"
    err = np.abs(got[:, live] - ref[:, live]).max(axis=0)
    assert (err <= BWD_BAR * scale).all(), f"per-column error / max: {err / scale}"


def _jax_serving(arrays, width, height, bg):
    jc, _ = cameras(width, height)
    cloud = jax_cloud(arrays)
    bucket = jrt.pairs_budget(400, int(jrt.pair_count(cloud, jc, J_AABB)))
    return np.asarray(jrt.render_tiled(
        cloud, jc, J_AABB, background=jnp.asarray(bg), differentiable=False, compositor="pallas",
        pairs_max=bucket,
    ))


@pytest.mark.parametrize("size,with_bg", [((64, 64), False), ((128, 120), False), ((128, 120), True)],
                         ids=["64x64", "128x120", "128x120-bg"])
def test_aabb_render_matches_jax_serving_path(size, with_bg):
    width, height = size
    bg = BG if with_bg else np.zeros(4, np.float32)
    ref = _jax_serving(_arrays(), width, height, bg)
    _, tc = cameras(width, height)
    api._BUDGET_STATE.clear()
    got = api.render(torch_cloud(_arrays()), tc, T_AABB, background=torch.from_numpy(bg), device="cpu").numpy()
    assert got.shape == (height, width, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


def test_aabb_oracle_matches_jax_oracle_and_tiled():
    jc, tc = cameras(128, 120)
    bg = torch.from_numpy(BG)
    ref = np.asarray(j_oracle(jax_cloud(_arrays()), jc, J_AABB, background=jnp.asarray(BG)))
    cloud = torch_cloud(_arrays())
    got = t_oracle(cloud, tc, T_AABB, background=bg).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    tiled = api.render(cloud, tc, T_AABB, background=bg, device="cpu").numpy()
    # test_pallas.py's bar for the kernel path against the painter
    np.testing.assert_allclose(tiled, got, atol=3e-5, rtol=0)


# (cloud, width, height): test_pallas.py's gradient case, dead slots, the padded grid
GRAD_CASES = [("pallas400", 64, 64), ("dead400", 64, 64), ("wide400", 128, 120)]


@functools.lru_cache(maxsize=None)
def _target(width, height):
    jc, _ = cameras(width, height)
    img = jrt.render_tiled(jax_cloud(_arrays("pallas400")), jc, J_AABB, differentiable=False, compositor="pallas")
    return np.asarray(img) * np.float32(0.9)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[f"{c}-{w}x{h}" for c, w, h in GRAD_CASES])
def test_aabb_gradients_match_jax_pallas_training_path(case):
    name, width, height = case
    arrays = _arrays(name)
    jc, tc = cameras(width, height)
    target = _target(width, height)

    def j_loss(cloud):
        img = jrt.render_tiled(cloud, jc, J_AABB, differentiable=True, compositor="pallas")
        return jnp.mean((img - jnp.asarray(target)) ** 2)

    l_ref, g_ref = jax.value_and_grad(j_loss)(jax_cloud(arrays))
    model = TrainableCloud.from_numpy(arrays, "cpu")
    loss = mse(trt.render_tiled(model.cloud(), tc, T_AABB), torch.from_numpy(target))
    loss.backward()
    loss_rel = abs(float(loss.detach()) - float(l_ref)) / float(l_ref)
    assert loss_rel <= 1e-5
    errors = {}
    for f in FIELDS:
        ref = np.asarray(getattr(g_ref, f))
        got = getattr(model, f).grad.numpy()
        assert np.isfinite(got).all(), f
        scale = np.abs(ref).max()
        assert scale > 0, f
        errors[f] = float(np.abs(got - ref).max() / scale)
        assert errors[f] <= GRAD_BAR, (f, errors[f])
    # the measured errors, for ``pytest -s``
    print(f"\n[{name} {width}x{height}] loss rel {loss_rel:.2e}, max |port - jax| / max |jax|: "
          + ", ".join(f"{f} {e:.2e}" for f, e in errors.items()))


def test_compositors_reject_an_unknown_mode():
    p = torch.zeros(10, 10)
    s = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        tfwd.composite_tiles_raw(p, s, s, 2, 32, 32, mode=2)
    with pytest.raises(ValueError, match="mode"):
        tbwd.composite_backward(p, s, s, torch.zeros(4, 8, 256), 2, 32, 32, mode=-1)
