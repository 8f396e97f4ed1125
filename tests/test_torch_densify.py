"""PyTorch port, the training loop on the CPU against the JAX package:

  - the deterministic test model and its AABB;
  - ``accumulate_stats`` and ``densify_and_prune`` on fixed inputs, with the
    JAX package's split noise handed to the port, every field and every stat
    equal (ties among dead slots, fewer dead slots than the budget, a mix of
    splits and clones);
  - ``convergence_psnr`` at the JAX package's CPU test protocol, held to the
    same floor, and a short protocol run step by step in both packages.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.train import densify as jdens
from bevy_gaussian_splatting_tpu.train import losses as jlosses
from bevy_gaussian_splatting_tpu.train import quality as jquality
from bevy_gaussian_splatting_tpu_torch.models import cloud as tcloud
from bevy_gaussian_splatting_tpu_torch.train import densify as tdens
from bevy_gaussian_splatting_tpu_torch.train import quality as tquality
from bevy_gaussian_splatting_tpu_torch.train.step import FIELDS, TrainableCloud

PSNR_FLOOR_DB = 17.28  # tests/test_train.py's floor for this protocol (17.78 - 0.5)


def _jax_noise(seed: int, k: int) -> torch.Tensor:
    """The JAX package's first split draw from ``init_densify_state(n,
    seed)`` (densify.py:113-115)."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.array(jax.random.normal(sub, (k, 3))))


@pytest.mark.parametrize("seed", [42, 11])
def test_test_model_and_aabb_match_jax(seed):
    got = tcloud.test_model_3d(seed, device="cpu")
    ref = bgs.test_model_3d(seed)
    assert len(got) == 9
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for g, r in zip(got.compute_aabb(), ref.compute_aabb()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# (name, n, dead slots, k_budget, scale range): the scales against the
# clone/split threshold percent_dense * scene_extent = 0.1
DENSIFY_CASES = [
    ("ties", 96, 48, 16, (0.2, 0.3)),  # many dead slots tie at opacity 0: all split
    ("few-dead", 64, 5, 16, (0.0, 0.05)),  # fewer dead slots than K: all clone
    ("mix", 64, 20, 16, (0.0, 0.3)),  # splits and clones
]


def _densify_inputs(n, n_dead, scale_range, seed=5):
    rng = np.random.default_rng(seed)
    a = tcloud.random_arrays_3d_seeded(n, seed=seed)
    a["scale_opacity"][:, :3] = rng.uniform(*scale_range, (n, 3)).astype(np.float32)
    dead = rng.choice(n, n_dead, replace=False)
    a["scale_opacity"][dead] = 0.0
    a["position_visibility"][dead, 3] = 0.0
    a["scale_opacity"][dead[:2], 3] = -1e-3  # dead slots Adam pushed below 0
    a["scale_opacity"][dead[2], 3] = -0.0  # total order: -0 ranks below +0
    alive = np.setdiff1d(np.arange(n), dead)
    a["scale_opacity"][rng.choice(alive, 3, replace=False), 3] = 0.002  # below prune_opacity
    grads = []
    for _ in range(3):
        g = np.zeros((n, 4), np.float32)
        g[:, :3] = rng.normal(0.0, 1e-3, (n, 3))
        g[dead] = 0.0
        g[rng.choice(n, n // 8, replace=False)] = 0.0  # unseen this step
        grads.append(g)
    return a, grads


@pytest.mark.parametrize("case", DENSIFY_CASES, ids=[c[0] for c in DENSIFY_CASES])
def test_densify_and_prune_match_jax(case, monkeypatch):
    name, n, n_dead, k, scale_range = case
    arrays, grads = _densify_inputs(n, n_dead, scale_range)
    kw = dict(k_budget=k, scene_extent=10.0)

    j_state = jdens.init_densify_state(n)
    for g in grads:
        j_state = jdens.accumulate_stats(j_state, types.SimpleNamespace(position_visibility=jnp.asarray(g)))
    j_cloud, _, j_stats = jdens.densify_and_prune(
        bgs.Gaussian3dCloud(**{f: jnp.asarray(v) for f, v in arrays.items()}), j_state, **kw
    )

    t_state = tdens.init_densify_state(n, device="cpu")
    for g in grads:
        t_state = tdens.accumulate_stats(t_state, types.SimpleNamespace(position_visibility=torch.from_numpy(g)))
    np.testing.assert_array_equal(t_state.grad_accum.numpy(), np.asarray(j_state.grad_accum))
    np.testing.assert_array_equal(t_state.count.numpy(), np.asarray(j_state.count))
    monkeypatch.setattr(tdens, "_split_noise", lambda gen, kk, dev: _jax_noise(0, kk))
    t_cloud, t_state, t_stats = tdens.densify_and_prune(tcloud.cloud_from_numpy(arrays, "cpu"), t_state, **kw)

    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t_cloud, f).numpy(), np.asarray(getattr(j_cloud, f)), err_msg=f)
    stats = {s: int(v) for s, v in t_stats.items()}
    assert stats == {s: int(v) for s, v in j_stats.items()}
    assert not t_state.grad_accum.any() and not t_state.count.any()
    assert stats["added"] > 0 and stats["pruned"] > 0
    if name == "ties":
        assert stats["added"] == k and stats["split"] == k
    elif name == "few-dead":
        assert stats["added"] == n_dead and stats["cloned"] == n_dead
    else:
        assert stats["split"] > 0 and stats["cloned"] > 0


def test_accumulate_stats_reads_the_step_gradients():
    model = TrainableCloud.from_numpy(tcloud.random_arrays_3d_seeded(8, seed=1), "cpu")
    with pytest.raises(ValueError, match="training step"):
        model.grads()
    loss = (model.cloud().position * torch.arange(8.0)[:, None]).sum()
    (loss + sum(0.0 * getattr(model, f).sum() for f in FIELDS)).backward()
    state = tdens.accumulate_stats(tdens.init_densify_state(8, device="cpu"), model.grads())
    # d/dpos of sum(i * pos_i) is i in each of x, y, z: norm sqrt(3) i
    np.testing.assert_allclose(state.grad_accum.numpy(), np.sqrt(3.0) * np.arange(8), rtol=1e-6)
    np.testing.assert_array_equal(state.count.numpy(), (np.arange(8) > 0).astype(np.int32))


def test_top_k_orders_like_jax():
    x = np.array([0.0, -0.0, 0.5, 0.0, -1.0, 0.5, -0.0, 2.0], np.float32)
    vals, idx = tdens._top_k(torch.from_numpy(x), 6)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(np.signbit(vals.numpy()), np.signbit(np.asarray(j_vals)))


def test_convergence_psnr_floor():
    out = tquality.convergence_psnr(steps=60, size=48, n=192, device="cpu")
    # the JAX package measures 17.78 dB on this protocol (test_train.py)
    assert out["psnr_db"] >= PSNR_FLOOR_DB, out
    assert out["densify"]["added"] > 0
    assert len(out["losses"]) == 60 and np.isfinite(out["losses"]).all()
    print(f"\nconvergence_psnr(60, 48, 192) on the CPU: {out['psnr_db']:.4f} dB, densify {out['densify']}")


def test_short_protocol_matches_jax_step_by_step(monkeypatch):
    """10 steps, 64 gaussians, 32x32, densify after step 5, in both packages
    (the JAX side on its XLA compositor, the port on its plain kernels), with
    the JAX split noise handed to the port.  Measured drift: see PERF.md."""
    kw = dict(steps=10, n=64, size=32, densify_at=5)
    j_losses = []
    real_loss = jlosses.gaussian_splatting_loss

    def recording_loss(img, target):
        value = real_loss(img, target)
        jax.debug.callback(lambda v: j_losses.append(float(v)), value, ordered=True)
        return value

    monkeypatch.setattr(jlosses, "gaussian_splatting_loss", recording_loss)
    ref = jquality.convergence_psnr(compositor="xla", **kw)
    monkeypatch.setattr(tdens, "_split_noise", lambda gen, k, dev: _jax_noise(0, k))
    got = tquality.convergence_psnr(device="cpu", **kw)
    assert len(j_losses) == len(got["losses"]) == 10
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-3)
    assert abs(got["psnr_db"] - ref["psnr_db"]) <= 0.05, (got["psnr_db"], ref["psnr_db"])
    drift = np.abs(np.array(got["losses"]) - j_losses) / np.abs(j_losses)
    # the measured drift, for ``pytest -s``
    print(f"\nper-step loss drift (rel) {' '.join(f'{d:.1e}' for d in drift)}; "
          f"psnr {got['psnr_db']:.4f} vs {ref['psnr_db']:.4f} dB")
