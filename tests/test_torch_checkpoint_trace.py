"""PyTorch port, training checkpoints (``utils/checkpoint.py``) and tracing
(``utils/trace.py``) on the CPU.

Checkpoints move both ways between the packages: a JAX run's ``optax.adam``
checkpoint after one update resumes in ``torch.optim.Adam`` with its moments
and count bit-equal, and the next step lands within 1e-6 (relative to each
field's largest magnitude) of optax's next step; a checkpoint of the port
loads in JAX's ``load_checkpoint`` with an ``optax.adam(...).init(cloud)``
template, and JAX's next step from it lands as close to the port's.  The
gradients are fixed numpy draws, so no render runs.  ``FrameDiagnostics``
and ``StageTimer`` as tests/test_aux.py:121-151 holds JAX's, and ``trace()``
writes a Chrome trace on the CPU."""

import dataclasses
import glob
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bevy_gaussian_splatting_tpu as bgs
from bevy_gaussian_splatting_tpu.utils import checkpoint as jckpt
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    Gaussian3dCloud,
    Gaussian4dCloud,
    precompute_covariance_3d,
    random_arrays_3d_seeded,
    random_arrays_4d_seeded,
)
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam
from bevy_gaussian_splatting_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from bevy_gaussian_splatting_tpu_torch.utils.trace import FrameDiagnostics, StageTimer, trace
from torch_port_cases import jax_cloud, torch_cloud

LR = 1e-2
STEP_BAR = 1e-6  # relative to each field's largest magnitude


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grads(arrays: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=v.shape).astype(np.float32) for k, v in arrays.items()}


def _fields(cloud) -> list:
    return [f.name for f in dataclasses.fields(cloud)]


def _jax_step(opt, jc, state, g: dict):
    updates, state = opt.update(type(jc)(**{k: jnp.asarray(v) for k, v in g.items()}), state, jc)
    return optax.apply_updates(jc, updates), state


def _torch_step(model, optimizer, g: dict) -> None:
    optimizer.zero_grad(set_to_none=True)
    for name in model.fields:
        getattr(model, name).grad = torch.from_numpy(g[name].copy())
    optimizer.step()


def _assert_close(got: dict, want: dict) -> None:
    for name, w in want.items():
        err = float(np.abs(got[name] - w).max() / max(np.abs(w).max(), 1e-30))
        assert err <= STEP_BAR, (name, err)


@pytest.mark.parametrize("four_d", [False, True])
def test_jax_adam_checkpoint_resumes_in_the_port(four_d, tmp_path):
    a = random_arrays_4d_seeded(24, seed=5) if four_d else random_arrays_3d_seeded(32, seed=5)
    g1, g2 = _grads(a, 1), _grads(a, 2)
    jc = jax_cloud(a)
    opt = optax.adam(LR)
    jc1, state1 = _jax_step(opt, jc, opt.init(jc), g1)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jc1, state1, step=1, extra={"loss": 0.25})

    cloud, none, step, extra = load_checkpoint(path, device="cpu")
    assert none is None and step == 1 and float(extra["loss"]) == 0.25
    assert type(cloud) is (Gaussian4dCloud if four_d else Gaussian3dCloud)
    model = TrainableCloud(cloud)
    optimizer = adam(model, LR)
    assert load_checkpoint(path, model, optimizer)[1] is optimizer
    mu, nu = state1[0].mu, state1[0].nu
    for name in model.fields:
        p = getattr(model, name)
        np.testing.assert_array_equal(_np(p), np.asarray(getattr(jc1, name)))
        s = optimizer.state[p]
        assert float(s["step"]) == float(state1[0].count) == 1.0
        np.testing.assert_array_equal(_np(s["exp_avg"]), np.asarray(getattr(mu, name)))
        np.testing.assert_array_equal(_np(s["exp_avg_sq"]), np.asarray(getattr(nu, name)))
    jc2, state2 = _jax_step(opt, jc1, state1, g2)
    _torch_step(model, optimizer, g2)
    _assert_close({n: _np(getattr(model, n)) for n in model.fields}, {n: np.asarray(getattr(jc2, n)) for n in model.fields})
    assert float(optimizer.state[model.position_visibility]["step"]) == int(state2[0].count) == 2


def test_port_checkpoint_loads_in_jax(tmp_path):
    a = random_arrays_3d_seeded(32, seed=6)
    g1, g2 = _grads(a, 3), _grads(a, 4)
    model = TrainableCloud(torch_cloud(a))
    optimizer = adam(model, LR)
    _torch_step(model, optimizer, g1)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, model, optimizer, step=9, extra={"psnr": np.float32(17.5), "views": np.arange(3)})

    opt = optax.adam(LR)
    template = opt.init(jax_cloud(a))
    jc, state, step, extra = jckpt.load_checkpoint(path, template)
    assert step == 9 and float(extra["psnr"]) == 17.5
    np.testing.assert_array_equal(extra["views"], np.arange(3))
    assert jax.tree.structure(state) == jax.tree.structure(template)
    assert np.asarray(state[0].count).dtype == np.int32 and int(state[0].count) == 1
    for name in model.fields:
        p = getattr(model, name)
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)), _np(p))
        np.testing.assert_array_equal(np.asarray(getattr(state[0].mu, name)), _np(optimizer.state[p]["exp_avg"]))
        np.testing.assert_array_equal(np.asarray(getattr(state[0].nu, name)), _np(optimizer.state[p]["exp_avg_sq"]))
    jc2, _ = _jax_step(opt, jc, state, g2)
    _torch_step(model, optimizer, g2)
    _assert_close({n: _np(getattr(model, n)) for n in model.fields}, {n: np.asarray(getattr(jc2, n)) for n in model.fields})


def test_fresh_optimizer_writes_optax_init(tmp_path):
    """Before its first step Adam holds no state: the checkpoint carries
    optax's init (count 0, zero moments), and a resumed run then steps as a
    fresh one does."""
    a = random_arrays_3d_seeded(16, seed=7)
    model = TrainableCloud(torch_cloud(a))
    optimizer = adam(model, LR)
    path = str(tmp_path / "fresh.npz")
    save_checkpoint(path, model, optimizer)
    template = optax.adam(LR).init(jax_cloud(a))
    _, state, step, _ = jckpt.load_checkpoint(path, template)
    assert step == 0
    for want, got in zip(jax.tree.leaves(template), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype
    resumed = TrainableCloud(torch_cloud(a))
    resumed_opt = adam(resumed, LR)
    load_checkpoint(path, resumed, resumed_opt)
    g = _grads(a, 8)
    _torch_step(model, optimizer, g)
    _torch_step(resumed, resumed_opt, g)
    for name in model.fields:
        assert torch.equal(getattr(model, name), getattr(resumed, name))


def test_cloud_only_round_trips(tmp_path):
    """tests/test_aux.py's cloud-only case (a 4D cloud) both ways, and the
    precomputed-covariance cloud in the port."""
    a4 = random_arrays_4d_seeded(16, seed=5)
    jc4 = bgs.random_gaussians_4d_seeded(16, seed=5)
    port_path, jax_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    save_checkpoint(port_path, torch_cloud(a4))
    jckpt.save_checkpoint(jax_path, jc4)
    for path in (port_path, jax_path):
        cloud, state, step, extra = load_checkpoint(path, device="cpu")
        assert state is None and step == 0 and extra == {}
        assert type(cloud) is Gaussian4dCloud
        for name in _fields(cloud):
            np.testing.assert_array_equal(_np(getattr(cloud, name)), np.asarray(getattr(jc4, name)))
        jcloud, jstate, jstep, _ = jckpt.load_checkpoint(path)
        assert jstate is None and jstep == 0 and type(jcloud) is bgs.Gaussian4dCloud
        np.testing.assert_array_equal(np.asarray(jcloud.spherindrical_harmonic), _np(cloud.spherindrical_harmonic))
    cov = precompute_covariance_3d(torch_cloud(random_arrays_3d_seeded(8, seed=2)))
    save_checkpoint(port_path, cov, step=3)
    back, _, step, _ = load_checkpoint(port_path, device="cpu")
    assert step == 3 and type(back) is type(cov)
    assert all(torch.equal(getattr(back, n), getattr(cov, n)) for n in _fields(cov))


def test_only_adam_state_is_written(tmp_path):
    a = random_arrays_3d_seeded(8, seed=1)
    model = TrainableCloud(torch_cloud(a))
    path = str(tmp_path / "x.npz")
    with pytest.raises(TypeError):
        save_checkpoint(path, model, torch.optim.SGD(model.parameters(), lr=0.1))
    with pytest.raises(TypeError):
        save_checkpoint(path, model, torch.optim.Adam(model.parameters(), lr=0.1, amsgrad=True))
    with pytest.raises(ValueError):
        save_checkpoint(path, model.cloud(), adam(model, LR))  # state without its model
    other = TrainableCloud(torch_cloud(a))
    with pytest.raises(ValueError):
        save_checkpoint(path, model, adam(other, LR))  # an optimizer over other parameters
    save_checkpoint(path, model)
    with pytest.raises(ValueError):
        load_checkpoint(path, model, adam(model, LR))  # no optimizer leaves in the file
    with pytest.raises(ValueError):
        load_checkpoint(path, TrainableCloud(torch_cloud(random_arrays_3d_seeded(9, seed=1))))


def test_frame_diagnostics_ema():
    d = FrameDiagnostics(smoothing=5)
    assert d.tick() is None and d.fps is None
    for _ in range(6):
        time.sleep(0.002)
        ema = d.tick()
    assert ema is not None and 0.5 < ema < 100.0
    assert d.fps and d.fps > 5.0
    assert d.frames == 7
    assert d.alpha == pytest.approx(2.0 / 6.0)


def test_stage_timer_spans():
    t = StageTimer()
    for _ in range(2):
        with t.span("a"):
            time.sleep(0.001)
    with t.span("b"):
        pass
    with pytest.raises(KeyError):
        with t.span("c"):
            raise KeyError("the span still counts")
    assert t.counts == {"a": 2, "b": 1, "c": 1}
    assert t.totals_ms["a"] >= 2.0 * 0.9
    report = t.report()
    assert "a=" in report and "b=" in report and "c=" in report


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.render.api import render

    cloud = torch_cloud(random_arrays_3d_seeded(200, seed=0))
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=32, height=32, device="cpu")
    log_dir = tmp_path / "trace"
    with trace(str(log_dir), device="cpu") as prof:
        render(cloud, cam, device="cpu")
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert files == [prof.trace_path]
    events = json.loads(open(files[0]).read())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert sum(e.count for e in prof.key_averages()) > 0
    if not torch.cuda.is_available():
        # the default device is the card: no silent host-only trace without one
        with pytest.raises(RuntimeError):
            with trace(str(tmp_path / "none")):
                pass
        assert not os.path.exists(tmp_path / "none")
