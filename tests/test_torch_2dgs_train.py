"""PyTorch port, 2DGS surfels (``CloudSettings(gaussian_mode=GAUSSIAN_2D)``) on
the CPU against the JAX package, training:

  - the plain backward compositor (csrc/tile_bwd.cu's twin) against the
    Pallas backward kernel run in interpret mode in its 2DGS branch, per
    gradient column, with the surfel radius column (2) exactly 0 in both;
  - gradients of every cloud field through the port's hand-derived backward
    against ``jax.grad`` of the Pallas 2DGS training path, with the gradient
    of scale z exactly 0 in both (the surfel is flat);
  - five Adam steps in both packages from the same numpy cloud.

(The segmented reduce at the 2DGS width, 16 columns, is a case of
tests/test_torch_backward.py's ``test_plain_reduce_matches_pallas``.)  The
JAX side is jitted once per case and module; ``pytest -s`` prints the
measured errors and the per-step drift.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.ops import rasterize_tile as jrt
from bevy_gaussian_splatting_tpu.ops.pallas.tile_bwd import pallas_composite_backward
from bevy_gaussian_splatting_tpu_torch.models.cloud import surfel_grid_arrays
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.models.settings import GaussianMode as TMode
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_bwd as tbwd
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tfwd
from bevy_gaussian_splatting_tpu_torch.train.losses import mse
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step
from torch_port_cases import SURFEL_EYE, cameras, cloud_arrays, jax_cloud, jax_splats

J_2D = bgs.CloudSettings(gaussian_mode=bgs.GaussianMode.GAUSSIAN_2D)
T_2D = TSettings(gaussian_mode=TMode.GAUSSIAN_2D)
FIELDS = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")
BWD_BAR = 1e-4  # per gradient column, of its largest |JAX| (test_torch_backward.py)
GRAD_BAR = 3e-3  # per cloud field, of its largest |JAX| (test_pallas.py)


def _arrays(name: str) -> dict:
    if name == "surfels":
        return surfel_grid_arrays()
    a = cloud_arrays("wide", 400, 1)
    if name == "pallas400":  # test_pallas.py TestPallasForward._grad_parity
        a["scale_opacity"] = a["scale_opacity"] * np.array([1, 2, 0.5, 1], np.float32)
    return a


def _cameras(name: str, width: int, height: int):
    return cameras(width, height, SURFEL_EYE) if name == "surfels" else cameras(width, height)


def _ids(cases):
    return [f"{c}-{w}x{h}" for c, w, h in cases]


# (cloud, width, height): test_pallas.py's gradient case, the padded grid
BWD_CASES = [("pallas400", 64, 64), ("wide400", 128, 120)]
# the gradient case: test_pallas.py's (a second one would jit the JAX
# training path again, 10-19 s of this file's 60 s; the surfel grid's
# gradients are held card against CPU by chip_smoke.py).  wide400 at 128x120 holds a
# surfel seen nearly edge-on whose position gradient JAX itself moves past
# GRAD_BAR under a two-ulp change of the positions: that case is held to the
# reference's own spread in tests/test_torch_2dgs_conditioning.py.
GRAD_CASES = [("pallas400", 64, 64)]


@pytest.mark.parametrize("case", BWD_CASES, ids=_ids(BWD_CASES))
def test_2dgs_plain_backward_matches_pallas(case):
    name, width, height = case
    jc, _ = _cameras(name, width, height)
    cloud = jax_cloud(_arrays(name))
    n = len(cloud)
    js = jax_splats(cloud, jc, J_2D)
    p_max = jrt.pairs_budget(n, int(jrt.pair_count(cloud, jc, J_2D)))
    # the XLA expansion: it compiles faster than the Pallas one in interpret
    # mode and places the same pairs in the same tiles (its unused tail
    # slots differ, which no tile walks)
    g_s, tile_s, _, _ = jrt.bin_gaussians(js, J_2D, width, height, p_max, expand="xla")
    num_tiles = (width // 16) * (jrt.pad_to_tile(height) // 16)
    start, end = jrt.tile_ranges(tile_s, num_tiles)
    count = jnp.minimum(end - start, jrt.tile_budget(n))
    params = jrt.pack_raster_params(js, J_2D, width, height)[g_s]
    chunk = tfwd.preferred_chunk(p_max, num_tiles)
    t_in = (torch.from_numpy(np.array(params)), torch.from_numpy(np.array(start)),
            torch.from_numpy(np.array(count, np.int32)))
    # the forward's totals (the plain forward agrees with the Pallas one,
    # tests/test_torch_2dgs.py) and a random cotangent
    raw = tfwd.composite_tiles_raw(*t_in, width // 16, width, height, chunk=chunk, mode=tfwd.MODE_2D).numpy()
    rng = np.random.default_rng(width + height)
    gbar = np.concatenate([rng.normal(0.0, 1e-3, (num_tiles, 4, 256)).astype(np.float32), raw], axis=1)
    ref = np.asarray(pallas_composite_backward(
        params, start, count, jnp.asarray(gbar), J_2D, width, jrt.pad_to_tile(height),
        interpret=True, full_height=height, chunk_size=chunk,
    ))
    got = tbwd.composite_backward(*t_in, torch.from_numpy(gbar), width // 16, width, height, chunk=chunk,
                                  mode=tfwd.MODE_2D).numpy()
    assert got.shape == ref.shape == (p_max, 16)
    # the surfel radius only masks: exactly zero on both sides
    assert not got[:, 2].any() and not ref[:, 2].any()
    live = [c for c in range(16) if c != 2]
    scale = np.abs(ref[:, live]).max(axis=0)
    assert (scale > 0).all(), "a gradient column is identically zero"
    rel = np.abs(got[:, live] - ref[:, live]).max(axis=0) / scale
    print(f"\n[{name} {width}x{height}] plain 2DGS backward vs Pallas, per column / max: {rel.max():.3e}")
    assert (rel <= BWD_BAR).all(), f"per-column error / max: {rel}"


@functools.lru_cache(maxsize=None)
def _target(name, width, height):
    jc, _ = _cameras(name, width, height)
    img = jrt.render_tiled(jax_cloud(_arrays(name)), jc, J_2D, differentiable=False, compositor="pallas")
    return np.asarray(img) * np.float32(0.9)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name, width, height):
    """jit(value_and_grad) of the bench objective through the JAX package's
    Pallas 2DGS training path, compiled once per case."""
    jc, _ = _cameras(name, width, height)
    target = jnp.asarray(_target(name, width, height))
    n = len(_arrays(name)["position_visibility"])

    def loss(cloud):
        img = jrt.render_tiled(cloud, jc, J_2D, width=width, height=height, differentiable=True,
                               compositor="pallas", pairs_max=jrt.pairs_budget(n))
        return jnp.mean((img - target) ** 2)

    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("case", GRAD_CASES, ids=_ids(GRAD_CASES))
def test_2dgs_gradients_match_jax_pallas_training_path(case):
    name, width, height = case
    arrays = _arrays(name)
    _, tc = _cameras(name, width, height)
    target = _target(name, width, height)
    l_ref, g_ref = _jax_value_and_grad(name, width, height)(jax_cloud(arrays))
    model = TrainableCloud.from_numpy(arrays, "cpu")
    loss = mse(trt.render_tiled(model.cloud(), tc, T_2D), torch.from_numpy(target))
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
    # the surfel is flat: scale z enters nowhere, its gradient is exactly 0
    assert not model.scale_opacity.grad[:, 2].any() and not np.asarray(g_ref.scale_opacity)[:, 2].any()
    print(f"\n[{name} {width}x{height}] loss rel {loss_rel:.2e}, max |port - jax| / max |jax|: "
          + ", ".join(f"{f} {e:.2e}" for f, e in errors.items()))


def test_2dgs_adam_steps_match_jax():
    name, width, height, lr, steps = "pallas400", 64, 64, 1e-2, 5
    loss_fn = _jax_value_and_grad(name, width, height)
    cloud = jax_cloud(_arrays(name))
    opt = optax.adam(lr)
    state = opt.init(cloud)
    j_losses = []
    for _ in range(steps):
        value, grads = loss_fn(cloud)
        updates, state = opt.update(grads, state)
        cloud = optax.apply_updates(cloud, updates)
        j_losses.append(float(value))

    _, tc = _cameras(name, width, height)
    model = TrainableCloud.from_numpy(_arrays(name), "cpu")
    optimizer = adam(model, lr)
    target = torch.from_numpy(_target(name, width, height))
    t_losses = [float(train_step(model, optimizer, tc, target, T_2D, mse, pairs_max=trt.pairs_budget(400)))
                for _ in range(steps)]
    drift = np.abs(np.array(t_losses) / np.array(j_losses) - 1.0)
    print(f"\n[2DGS Adam lr {lr}] losses {t_losses}, per-step relative drift {drift.tolist()}")
    assert (drift <= 1e-3).all()
    assert t_losses[-1] < t_losses[0]
