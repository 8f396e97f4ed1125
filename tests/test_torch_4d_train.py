"""PyTorch port, temporal 4DGS training on the CPU against the JAX package:

  - gradients of every ``Gaussian4dCloud`` field through the port's
    hand-derived backward (the plain versions of the backward compositor and
    the segmented reduce; 4DGS composites as OBB or AABB) against
    ``jax.grad`` of the JAX package's Pallas training path run in interpret
    mode and traced eagerly, within 1e-3 of each field's largest magnitude
    (the port's bar for gradients, ROADMAP.md), in OBB and AABB.  Eagerly:
    the 4D covariance is diagonal in world axes (see tests/test_torch_4d.py),
    and gaussian 44, a disk of scale z 1e-3, is ill-conditioned in OBB; its
    scale-z gradient moves 8.3e-2 of the field's largest under a two-ulp
    change of the positions in JAX itself and 6.8e-3 between JAX's jitted
    and eager traces, while the port is 2.4e-4 from the eager trace;
  - three Adam steps in both packages from the same numpy cloud;
  - densification: ``accumulate_stats`` takes a 4DGS gradient, and
    ``densify_and_prune`` fails on a ``Gaussian4dCloud`` with
    ``AttributeError`` in both packages (it reads ``spherical_harmonic``,
    which a 4DGS cloud does not have).

The target is a render of the same cloud at a later time, so the loss pulls
on the temporal fields.  The JAX side of the Adam steps is jitted once;
``pytest -s`` prints the measured errors.
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
from bevy_gaussian_splatting_tpu.train import densify as jdensify
from bevy_gaussian_splatting_tpu_torch.models import settings as tsettings
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian4dCloud, cloud_from_numpy, random_arrays_4d_seeded
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.train import densify as tdensify
from bevy_gaussian_splatting_tpu_torch.train.losses import mse
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step
from torch_port_cases import cameras, jax_cloud

FIELDS = ("position_visibility", "spherindrical_harmonic", "isotropic_rotations", "scale_opacity",
          "timestamp_timescale")
GRAD_BAR = 1e-3  # per field, of its largest |JAX| gradient
N, SEED, SIZE, TIME, TARGET_TIME = 80, 2, 64, 0.5, 0.6


def _arrays() -> dict:
    return random_arrays_4d_seeded(N, SEED)


def _settings(aabb: bool, time: float = TIME):
    return (bgs.CloudSettings(gaussian_mode=bgs.GaussianMode.GAUSSIAN_4D, time=time, aabb=aabb),
            tsettings.CloudSettings(gaussian_mode=tsettings.GaussianMode.GAUSSIAN_4D, time=time, aabb=aabb))


@functools.lru_cache(maxsize=None)
def _target(aabb: bool) -> np.ndarray:
    jc, _ = cameras(SIZE, SIZE)
    img = jrt.render_tiled(jax_cloud(_arrays()), jc, _settings(aabb, TARGET_TIME)[0], differentiable=False,
                           compositor="pallas")
    return np.array(img)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(aabb: bool, jit: bool = True):
    """value_and_grad of the bench objective through the JAX package's
    Pallas training path in 4DGS, jitted (compiled once per mode) or
    traced eagerly."""
    jc, _ = cameras(SIZE, SIZE)
    target = jnp.asarray(_target(aabb))
    settings = _settings(aabb)[0]

    def loss(cloud):
        img = jrt.render_tiled(cloud, jc, settings, width=SIZE, height=SIZE, differentiable=True,
                               compositor="pallas", pairs_max=jrt.pairs_budget(N))
        return jnp.mean((img - target) ** 2)

    fn = jax.value_and_grad(loss)
    return jax.jit(fn) if jit else fn


@pytest.mark.parametrize("aabb", [False, True], ids=["obb", "aabb"])
def test_4d_gradients_match_jax_pallas_training_path(aabb):
    arrays = _arrays()
    _, tc = cameras(SIZE, SIZE)
    l_ref, g_ref = _jax_value_and_grad(aabb, jit=False)(jax_cloud(arrays))
    model = TrainableCloud.from_numpy(arrays, "cpu")
    assert model.cloud_class is Gaussian4dCloud and model.fields == FIELDS
    loss = mse(trt.render_tiled(model.cloud(), tc, _settings(aabb)[1]), torch.from_numpy(_target(aabb)))
    loss.backward()
    loss_rel = abs(float(loss.detach()) - float(l_ref)) / float(l_ref)
    assert loss_rel <= 1e-5
    errors = {}
    grads = model.grads()
    assert isinstance(grads, Gaussian4dCloud)
    for f in FIELDS:
        ref = np.asarray(getattr(g_ref, f))
        got = getattr(grads, f).numpy()
        assert np.isfinite(got).all(), f
        scale = np.abs(ref).max()
        assert scale > 0, f
        errors[f] = float(np.abs(got - ref).max() / scale)
    print(f"\n[4d {'aabb' if aabb else 'obb'} {SIZE}x{SIZE}] loss rel {loss_rel:.2e}, max |port - jax| / max |jax|: "
          + ", ".join(f"{f} {e:.2e}" for f, e in errors.items()))
    assert max(errors.values()) <= GRAD_BAR, errors


def test_4d_adam_steps_match_jax():
    lr, steps = 1e-2, 3
    loss_fn = _jax_value_and_grad(False)
    cloud = jax_cloud(_arrays())
    opt = optax.adam(lr)
    state = opt.init(cloud)
    j_losses = []
    for _ in range(steps):
        value, grads = loss_fn(cloud)
        updates, state = opt.update(grads, state)
        cloud = optax.apply_updates(cloud, updates)
        j_losses.append(float(value))

    _, tc = cameras(SIZE, SIZE)
    model = TrainableCloud.from_numpy(_arrays(), "cpu")
    optimizer = adam(model, lr)
    target = torch.from_numpy(_target(False))
    t_losses = [float(train_step(model, optimizer, tc, target, _settings(False)[1], mse,
                                 pairs_max=trt.pairs_budget(N))) for _ in range(steps)]
    drift = np.abs(np.array(t_losses) / np.array(j_losses) - 1.0)
    print(f"\n[4DGS Adam lr {lr}] losses {t_losses}, per-step relative drift {drift.tolist()}")
    assert (drift <= 1e-3).all()
    assert t_losses[-1] < t_losses[0]
    # the step's time argument overrides settings.time
    img = trt.render_tiled(model.cloud(), tc, _settings(False, 0.1)[1], time=TIME, differentiable=False)
    ref = trt.render_tiled(model.cloud(), tc, _settings(False)[1], differentiable=False)
    np.testing.assert_array_equal(img.detach().numpy(), ref.detach().numpy())


def test_4d_densify_accepts_what_jax_accepts():
    arrays = _arrays()
    rng = np.random.default_rng(0)
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in arrays.items()}
    j_state = jdensify.accumulate_stats(jdensify.init_densify_state(N), jax_cloud(g))
    t_state = tdensify.accumulate_stats(tdensify.init_densify_state(N, device="cpu"), cloud_from_numpy(g, "cpu"))
    np.testing.assert_allclose(t_state.grad_accum.numpy(), np.asarray(j_state.grad_accum), rtol=1e-6)
    np.testing.assert_array_equal(t_state.count.numpy(), np.asarray(j_state.count))
    with pytest.raises(AttributeError, match="spherical_harmonic"):
        jdensify.densify_and_prune(jax_cloud(arrays), j_state, k_budget=8)
    with pytest.raises(AttributeError, match="spherical_harmonic"):
        tdensify.densify_and_prune(cloud_from_numpy(arrays, "cpu"), t_state, k_budget=8)
