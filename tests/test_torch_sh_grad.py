"""The projection's SH colour stage as one autograd function
(``ops/cuda/sh.py`` ``sh_colour``), on the CPU, where it runs its plain
versions: the forward the eager chain (``ops/sh.py``) bit for bit and the
JAX package's ``ops/sh.py`` within 1e-5; the hand-derived backward's
``d_sh`` autograd's bit for bit through the eager chain, ``d_dir`` and
``d_dir_t`` within 1e-5 (norm of the difference over norm) of float64
autograd; 3D at SH degree 0-3 (and a degree-4 row, evaluated through 3) and
4D, on two seeded direction sets with axis-aligned and near-pole rows and
zero rows in the cotangent (whose products are signed zeros).  Then a 4D
``render_tiled`` through the function: one node of it in the graph, no
slice of ``spherindrical_harmonic``, and the counters ``sh.calls`` /
``sh.fused``.  The kernels (``csrc/sh.cu``) are held to the same bars on
the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_gaussian_splatting_tpu.ops import sh as jsh
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_4d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import sh as sh_fn
from bevy_gaussian_splatting_tpu_torch.train.losses import mse
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud
from bevy_gaussian_splatting_tpu_torch.utils import trace
from torch_port_cases import SH_GRAD_REL, SH_KINDS, rel_gap, sh_stage_grads, sh_stage_inputs, sh_stage_tensors

N = 1000


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", SH_KINDS)
def test_sh_colour_plain_matches_the_eager_chain_and_float64(kind, seed):
    inp = sh_stage_inputs(kind, N, seed)
    fused = sh_stage_tensors(inp)
    rgb = sh_fn.sh_colour(*fused)
    eager = sh_stage_tensors(inp)
    rgb_eager = sh_fn.sh_colour_plain(*eager)
    assert torch.equal(rgb.detach().view(torch.int32), rgb_eager.detach().view(torch.int32))

    got = sh_stage_grads(rgb, fused, inp["g"])
    want = sh_stage_grads(rgb_eager, eager, inp["g"])
    # d_sh: autograd's bits, signed zeros included
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))

    wide = sh_stage_tensors(inp, dtype=torch.float64)
    exact = sh_stage_grads(sh_fn.sh_colour_plain(*wide), wide, inp["g"])
    if kind == "deg0":  # the constant basis reads no direction
        assert got[0] is None and exact[0] is None
    else:
        assert rel_gap(got[0], exact[0]) <= SH_GRAD_REL
    if kind == "4d":
        assert rel_gap(got[2], exact[2]) <= SH_GRAD_REL


@pytest.mark.parametrize("kind", SH_KINDS)
def test_sh_colour_matches_the_jax_package(kind):
    inp = sh_stage_inputs(kind, N, 0)
    d = torch.tensor(inp["d"])
    sh = torch.tensor(inp["sh"])
    if kind == "4d":
        got = sh_fn.sh_colour(d, sh, torch.tensor(inp["dir_t"]), torch.tensor(inp["duration"]))
        want = jsh.spherindrical_harmonics_lookup(jnp.asarray(inp["d"]), jnp.asarray(inp["dir_t"]),
                                                  jnp.asarray(inp["sh"]), jnp.float32(inp["duration"]))
    else:
        got = sh_fn.sh_colour(d, sh)
        want = jsh.spherical_harmonics_lookup(jnp.asarray(inp["d"]), jnp.asarray(inp["sh"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_sh_colour_refuses_a_width_of_no_sh_layout():
    with pytest.raises(ValueError):
        sh_fn.sh_colour(torch.zeros(4, 3), torch.zeros(4, 20))


def _graph_nodes(root):
    seen, stack, nodes = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        nodes.append(node)
        stack.extend(fn for fn, _ in node.next_functions)
    return nodes


def test_4d_render_backward_runs_one_colour_node():
    cloud = TrainableCloud.from_numpy(random_arrays_4d_seeded(64, seed=3), "cpu")
    settings = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D, time=0.4)
    camera = Camera.create(eye=(0.0, 0.0, 60.0), width=48, height=48, device="cpu")
    before = trace.counters()
    image = rt.render_tiled(cloud.cloud(), camera, settings)
    after = trace.counters()
    assert after.get("sh.calls", 0) == before.get("sh.calls", 0) + 1
    assert after.get("sh.fused", 0) == before.get("sh.fused", 0)  # no card: the plain versions
    loss = mse(image, torch.zeros_like(image))
    nodes = _graph_nodes(loss.grad_fn)
    assert [type(n).__name__ for n in nodes].count("ShColourBackward") == 1
    sh_leaf = cloud.spherindrical_harmonic
    for node in nodes:
        if type(node).__name__ == "SliceBackward0":
            leaves = [getattr(fn, "variable", None) for fn, _ in node.next_functions if fn is not None]
            assert not any(v is sh_leaf for v in leaves)
    loss.backward()
    assert bool(torch.isfinite(sh_leaf.grad).all()) and float(sh_leaf.grad.abs().max()) > 0
    assert bool(torch.isfinite(cloud.timestamp_timescale.grad).all())
