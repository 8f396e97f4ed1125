"""PyTorch port, 2DGS surfels on the CPU against the JAX package: the one
gradient case held to the reference's own float32 spread instead of a fixed
bar.

In the ``wide400`` cloud at 128x120 surfel #379 is seen nearly edge-on.  Its
position gradient is ill-conditioned in float32: JAX's own gradient moves past
test_torch_2dgs_train.py's 3e-3 bar when the input positions move by two ulps
of 1.0, so that file's ``GRAD_CASES`` leave the case out.  This test holds it
here: every field other than the position within the bar, the position within
the bar on every other surfel, and on the whole within the distance JAX's
gradient moves by itself.  ``pytest -s`` prints the numbers.  Its own file
keeps each 2DGS test file under a minute alone (one more jit of the JAX
training path, about 25 s).
"""

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as trt
from bevy_gaussian_splatting_tpu_torch.train.losses import mse
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud
from test_torch_2dgs_train import FIELDS, GRAD_BAR, T_2D, _arrays, _cameras, _jax_value_and_grad, _target
from torch_port_cases import jax_cloud

EDGE_ON = 379  # the surfel seen nearly edge-on
NUDGE = np.float32(1.0) + 2 * np.finfo(np.float32).eps  # positions x (1 + 2.4e-7)


def test_2dgs_edge_on_surfel_gradient_within_the_reference_spread():
    name, width, height = "wide400", 128, 120
    arrays = _arrays(name)
    value_and_grad = _jax_value_and_grad(name, width, height)
    _, g_ref = value_and_grad(jax_cloud(arrays))
    nudged = dict(arrays)
    nudged["position_visibility"] = arrays["position_visibility"] * np.array([NUDGE] * 3 + [1], np.float32)
    _, g_nudged = value_and_grad(jax_cloud(nudged))

    _, tc = _cameras(name, width, height)
    model = TrainableCloud.from_numpy(arrays, "cpu")
    mse(trt.render_tiled(model.cloud(), tc, T_2D), torch.from_numpy(_target(name, width, height))).backward()

    report = []
    for f in FIELDS:
        ref = np.asarray(getattr(g_ref, f))
        scale = np.abs(ref).max()
        err = np.abs(getattr(model, f).grad.numpy() - ref)
        spread = np.abs(np.asarray(getattr(g_nudged, f)) - ref)
        report.append(f"{f} port {err.max() / scale:.2e} jax spread {spread.max() / scale:.2e}")
        if f != "position_visibility":
            assert err.max() <= GRAD_BAR * scale, (f, err.max() / scale)
            continue
        # the reference alone moves past the bar, most at the edge-on surfel
        assert spread.max() > GRAD_BAR * scale
        assert int(spread.max(axis=1).argmax()) == EDGE_ON
        # the port: within the bar on every other surfel, within the
        # reference's own spread on the edge-on one
        assert int(err.max(axis=1).argmax()) == EDGE_ON
        assert np.delete(err, EDGE_ON, axis=0).max() <= GRAD_BAR * scale
        assert err.max() <= spread.max()
    print(f"\n[{name} {width}x{height}] max |diff| / max |jax| per field: " + "; ".join(report))
