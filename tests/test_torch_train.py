"""PyTorch port, the training step on the CPU against the JAX package:

  - gradients of every cloud field through ``render_tiled`` (the port's
    autograd Function, whose backward is the plain versions of the backward
    compositor and the segmented reduce) against ``jax.grad`` of the same
    loss through ``render_tiled(..., differentiable=True,
    compositor="pallas")``, the Pallas kernels run in interpret mode;
  - the losses (L1, SSIM, the 3DGS objective), values and gradients;
  - three SGD steps in both packages from the same numpy cloud.
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
from bevy_gaussian_splatting_tpu.train import losses as jlosses
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings as TSettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.train import losses as tlosses
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step
from torch_port_cases import cameras, cloud_arrays, jax_cloud

FIELDS = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")
# test_pallas.py's bar for the Pallas training path against XLA AD: per
# field, of its largest |JAX| gradient (the measured error is far below it)
GRAD_BAR = 3e-3


def _arrays(name):
    if name == "pallas400":  # test_pallas.py TestPallasBackward._grad_parity
        a = cloud_arrays("wide", 400, 1)
        a["scale_opacity"] = a["scale_opacity"] * np.array([1, 2, 0.5, 1], np.float32)
        return a
    if name == "bg100":  # test_pallas.py test_grads_with_background
        return cloud_arrays("wide", 100, 6)
    return cloud_arrays("wide", 400, 1)


# (cloud, width, height, background, target scale)
GRAD_CASES = [
    ("pallas400", 64, 64, None, 0.9),
    ("bg100", 64, 64, (0.3, 0.2, 0.1, 1.0), 0.8),
    ("wide400", 128, 120, None, 0.9),
]
GRAD_IDS = [f"{c}-{w}x{h}" + ("-bg" if bg else "") for c, w, h, bg, _ in GRAD_CASES]


def _jax_loss_fn(width, height, bg, target):
    jc, _ = cameras(width, height)
    bg = None if bg is None else jnp.asarray(bg, jnp.float32)

    def loss(cloud):
        img = jrt.render_tiled(
            cloud, jc, bgs.CloudSettings(), background=bg, differentiable=True, compositor="pallas"
        )
        return jnp.mean((img - target) ** 2)

    return loss


@functools.lru_cache(maxsize=None)
def _target(name, width, height, bg, scale):
    jc, _ = cameras(width, height)
    img = jrt.render_tiled(
        jax_cloud(_arrays(name)), jc, bgs.CloudSettings(),
        background=None if bg is None else jnp.asarray(bg, jnp.float32),
        differentiable=False, compositor="pallas",
    )
    return np.asarray(img) * np.float32(scale)


def _port_loss_and_grads(arrays, width, height, bg, target):
    _, tc = cameras(width, height)
    model = TrainableCloud.from_numpy(arrays, "cpu")
    img = trt.render_tiled(model.cloud(), tc, TSettings(), background=None if bg is None else torch.tensor(bg))
    loss = tlosses.mse(img, torch.from_numpy(target))
    loss.backward()
    return float(loss.detach()), {f: getattr(model, f).grad.numpy() for f in FIELDS}


@pytest.mark.parametrize("case", GRAD_CASES, ids=GRAD_IDS)
def test_gradients_match_jax_pallas_training_path(case):
    name, width, height, bg, scale = case
    target = _target(name, width, height, bg, scale)
    arrays = _arrays(name)
    j_loss, j_grads = jax.value_and_grad(_jax_loss_fn(width, height, bg, jnp.asarray(target)))(jax_cloud(arrays))
    t_loss, t_grads = _port_loss_and_grads(arrays, width, height, bg, target)
    assert abs(t_loss - float(j_loss)) <= 1e-5 * float(j_loss)
    for f in FIELDS:
        ref = np.asarray(getattr(j_grads, f))
        got = t_grads[f]
        assert np.isfinite(got).all(), f
        scale_f = np.abs(ref).max()
        assert np.abs(got - ref).max() <= GRAD_BAR * scale_f, (f, np.abs(got - ref).max() / scale_f)


@pytest.mark.parametrize("shape", [(24, 40, 4), (2, 20, 32, 3)], ids=["rgba", "batch-rgb"])
@pytest.mark.parametrize("name", ["l1", "ssim", "gaussian_splatting_loss"])
def test_losses_match_jax(name, shape):
    rng = np.random.default_rng(len(shape))
    img = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    target = np.clip(img + rng.normal(0.0, 0.1, shape), 0.0, 1.0).astype(np.float32)
    j_val, j_grad = jax.value_and_grad(getattr(jlosses, name))(jnp.asarray(img), jnp.asarray(target))
    t_img = torch.from_numpy(img).requires_grad_()
    t_val = getattr(tlosses, name)(t_img, torch.from_numpy(target))
    t_val.backward()
    assert abs(float(t_val.detach()) - float(j_val)) <= 1e-6
    # each package's gradient is within 8e-7 of the largest |gradient| of a
    # float64 evaluation; the two convolutions sum in different orders, so
    # they differ from each other by up to 1.4e-6 of it
    j_grad = np.asarray(j_grad)
    assert np.abs(t_img.grad.numpy() - j_grad).max() <= 2e-6 * np.abs(j_grad).max()


def test_ssim_window_matches_jax():
    np.testing.assert_array_equal(tlosses._gaussian_window(11, 1.5), jlosses._gaussian_window(11, 1.5))


def test_sgd_steps_match_jax():
    name, width, height, lr = "pallas400", 64, 64, 3.0
    target = _target(name, width, height, None, 0.9)
    arrays = _arrays(name)
    loss_fn = jax.value_and_grad(_jax_loss_fn(width, height, None, jnp.asarray(target)))
    cloud = jax_cloud(arrays)
    opt = optax.sgd(lr)
    state = opt.init(cloud)
    j_losses = []
    for _ in range(3):
        value, grads = loss_fn(cloud)
        updates, state = opt.update(grads, state)
        cloud = optax.apply_updates(cloud, updates)
        j_losses.append(float(value))

    _, tc = cameras(width, height)
    model = TrainableCloud.from_numpy(arrays, "cpu")
    sgd = torch.optim.SGD(model.parameters(), lr=lr)
    t_losses = [
        float(train_step(model, sgd, tc, torch.from_numpy(target), TSettings(), tlosses.mse)) for _ in range(3)
    ]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[-1] < t_losses[0]
    for f in FIELDS:
        ref = np.asarray(getattr(cloud, f))
        np.testing.assert_allclose(getattr(model, f).detach().numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_trainable_cloud_round_trip_and_adam(monkeypatch):
    arrays = cloud_arrays("wide", 50, 2)
    model = TrainableCloud.from_numpy(arrays, "cpu")
    assert len(list(model.parameters())) == 4
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(model, f).detach().numpy(), arrays[f])
        assert getattr(model.cloud(), f) is getattr(model, f)
    opt = adam(model, 1e-2)
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
    # the default device is the card, and without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainableCloud.from_numpy(arrays)


def test_obb_axis_gradient_finite_where_the_axis_degenerates():
    # sxy = 0 and lambda1 == sxx: the eigenvector (-sxy, lambda1 - sxx) is 0
    # and the axis falls back to (1, 0).  jax.grad gives NaN for the whole
    # row there (sqrt's infinite slope at 0 times a zero cotangent); the
    # port keeps the forward and gives the finite gradient of the fallback.
    from bevy_gaussian_splatting_tpu.ops import covariance as jcov
    from bevy_gaussian_splatting_tpu_torch.ops import covariance as tcov

    cov = np.array([[2.0, 0.0, 1.0], [3.0, 0.5, 1.0]], np.float32)
    cut = np.array([3.0, 2.5], np.float32)

    def j_total(c):
        major, minor, axis = jcov.obb_axes(c, jnp.asarray(cut))
        return jnp.sum(major) + jnp.sum(minor) + jnp.sum(axis)

    j_grad = np.asarray(jax.grad(j_total)(jnp.asarray(cov)))
    t_cov = torch.from_numpy(cov).requires_grad_()
    out = tcov.obb_axes(t_cov, torch.from_numpy(cut))
    sum(o.sum() for o in out).backward()
    for got, ref in zip(out, jcov.obb_axes(jnp.asarray(cov), jnp.asarray(cut))):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    assert np.isnan(j_grad[0]).all() and np.isfinite(t_cov.grad.numpy()).all()
    np.testing.assert_allclose(t_cov.grad.numpy()[1], j_grad[1], rtol=1e-6)
