"""The functional render API: ``render(cloud, camera, settings) -> image``.

The counterpart of the JAX package's ``render/api.py`` ``render()`` with the
same adaptive pair budget: an exact N-sized pair count sizes the pair
buffers to the scene, is re-measured every ``_RECOUNT_PERIOD`` frames per
pipeline key, grows at once and shrinks never.  PyTorch runs eagerly, so
there is no compiled pipeline to cache; the key still separates budgets.

Implementations:
  - "auto":   the tiled renderer (ops/rasterize_tile.py): the CUDA kernels
              for tensors on the card, their plain versions on the CPU
  - "oracle": the exact painter (ops/rasterize_ref.py), O(N * H * W)
"""

from __future__ import annotations

from typing import Optional

import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, check_supported
from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_ref import render_oracle

_BUDGET_STATE: dict = {}
_RECOUNT_PERIOD = 16  # frames between pair-count refreshes per pipeline key


def _current_bucket(key, settings, cloud, camera, model_transform) -> int:
    """Adaptive pair-budget bucket (render/api.py:43-73 of the JAX package),
    counted at the frame's ``settings.time``."""
    state = _BUDGET_STATE.get(key)
    if state is not None:
        bucket, frame = state
        if (frame + 1) % _RECOUNT_PERIOD:
            _BUDGET_STATE[key] = (bucket, frame + 1)
            return bucket
    total = int(rt.pair_count(cloud, camera, settings, model_transform))
    bucket = rt.pairs_budget(len(cloud), total)
    if state is not None and bucket < state[0]:
        bucket = state[0]  # shrink lazily
    _BUDGET_STATE[key] = (bucket, (state[1] + 1) if state else 0)
    return bucket


def budget_key(impl: str, settings: CloudSettings, width: int, height: int, cloud, device) -> tuple:
    """The adaptive budget's key: what the JAX package keys its pipelines by
    (render/api.py:675-678), with the device in place of the compositor."""
    return (impl, settings.static_key(), width, height, len(cloud), type(cloud).__name__, str(device))


def render(
    cloud,
    camera: Camera,
    settings: Optional[CloudSettings] = None,
    model_transform: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
    impl: str = "auto",
    adaptive_budget: bool = True,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Render one cloud -> [H, W, 4] linear premultiplied RGBA, a 4DGS cloud
    at ``settings.time`` (as the JAX package's ``render()`` passes
    ``jnp.float32(settings.time)``, render/api.py:699).

    ``device`` defaults to ``cuda`` and raises when there is no card; pass
    ``device="cpu"`` for the plain PyTorch versions.  Cloud and camera are
    moved there if they lie elsewhere."""
    dev = resolve_device(device)
    if settings is None:
        settings = CloudSettings()
    check_supported(settings)
    if cloud.device != dev:
        cloud = cloud.to(dev)
    if camera.device != dev:
        camera = camera.to(dev)
    if model_transform is None:
        model_transform = torch.eye(4, dtype=torch.float32, device=dev)
    if background is None:
        background = torch.zeros((4,), dtype=torch.float32, device=dev)
    width, height = camera.width, camera.height

    if impl == "oracle":
        return render_oracle(cloud, camera, settings, model_transform, background, time=settings.time)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r} (expected 'auto' or 'oracle')")

    bucket = None
    if adaptive_budget:
        # the cloud's class too (render/api.py:675-678): a 3D and a 4D cloud
        # of one size never share a bucket
        key = budget_key(impl, settings, width, height, cloud, dev)
        bucket = _current_bucket(key, settings, cloud, camera, model_transform)
    # a serving call, as the JAX package's render() builds its pipeline
    # (make_tiled_pipeline's differentiable=False): the overlay runs the kernel
    return rt.render_tiled(
        cloud, camera, settings, model_transform, background, pairs_max=bucket, differentiable=False,
        time=settings.time,
    )
