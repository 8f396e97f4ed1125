"""PyTorch port on the card: each CUDA kernel against its plain version,
and ``render()`` on the card against the same call on the CPU.

These skip without an NVIDIA card.  On one, run them without the JAX-side
conftest: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
They import neither JAX nor the JAX package."""

import numpy as np
import pytest
import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, random_arrays_3d_seeded
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops.cuda import expand as ex
from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf
from bevy_gaussian_splatting_tpu_torch.render.api import render

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _scene(kind, n, seed):
    a = random_arrays_3d_seeded(n, seed=seed)
    if kind == "bench":
        a["position_visibility"] *= np.array([1, 1, 0.25, 1], np.float32)
        a["scale_opacity"] *= np.array([0.05, 0.05, 0.05, 1], np.float32)
    else:  # heavy occlusion: whole tiles saturate, the early exit binds
        a["position_visibility"] *= np.array([0.05, 0.05, 0.2, 1], np.float32)
        a["scale_opacity"] = a["scale_opacity"] * np.array([3, 3, 3, 1], np.float32) + np.array(
            [0, 0, 0, 0.6], np.float32
        )
    return a


def _inputs(arrays, width, height, device):
    cloud = cloud_from_numpy(arrays, device)
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=width, height=height, device=device)
    s = CloudSettings()
    p_max = rt.pairs_budget(len(cloud), int(rt.pair_count(cloud, cam, s)))
    return rt.project_for_binning(cloud, cam, s), p_max


@pytest.mark.parametrize("kind,n,height", [("bench", 20000, 256), ("occluded", 1000, 120)])
def test_expand_kernel_equals_plain(card, kind, n, height):
    splats, p_max = _inputs(_scene(kind, n, 3), 256, height, card)
    table, _ = rt.expansion_inputs(splats, 256, height, p_max)
    for budget in (p_max, 777):  # the second one caps the pairs
        args = (*table, budget, 16, 16 * (rt.pad_to_tile(height) // 16))
        before = ex.expand_pairs.launches
        got = ex.expand_pairs(*args)
        assert ex.expand_pairs.launches == before + 1
        for g, r in zip(got, ex.expand_pairs_plain(*args)):
            assert torch.equal(g, r)


@pytest.mark.parametrize("kind,n,height,chunk", [
    ("bench", 20000, 256, None), ("occluded", 1000, 120, None), ("occluded", 1000, 120, 128),
])
def test_composite_kernel_matches_plain(card, kind, n, height, chunk):
    splats, p_max = _inputs(_scene(kind, n, 4), 256, height, card)
    params, start, count = rt.composite_inputs(splats, 256, height, p_max)
    if chunk is None:
        chunk = tf.preferred_chunk(p_max, start.shape[0])
    args = (params, start, count, 16, 256, height)
    before = tf.composite_tiles_raw.launches
    got = tf.composite_tiles_raw(*args, chunk=chunk)
    assert tf.composite_tiles_raw.launches == before + 1
    ref = tf.composite_tiles_raw_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 2e-5


@pytest.mark.parametrize("height", [128, 120])
def test_render_card_matches_cpu(card, height):
    a = _scene("bench", 5000, 7)
    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=128, height=height, device="cpu")
    cpu = render(cloud_from_numpy(a, "cpu"), cam, background=bg, device="cpu")
    gpu = render(cloud_from_numpy(a, card), cam.to(card), background=bg.to(card))
    assert gpu.device.type == "cuda"
    assert float((gpu.cpu() - cpu).abs().max()) <= 2e-5
