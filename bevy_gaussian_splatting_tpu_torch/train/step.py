"""One training step: render, loss, backward, optimizer update.

The JAX package keeps its step inline (``train/quality.py:113-124``,
``bench.py:158-169``, ``examples/training.py:41-53``):
``value_and_grad(loss o render_tiled(..., differentiable=True,
compositor="pallas"))`` then an optax update.  Here the cloud's fields (of
any cloud class: 3DGS, 4DGS, precomputed covariance) are ``nn.Parameter``s
of a :class:`TrainableCloud`, the render is
``ops/rasterize_tile.render_tiled`` (differentiable through the hand-derived
backward kernels) and the update is a ``torch.optim`` optimizer;
:func:`adam` is ``optax.adam(lr)``'s update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud, cloud_from_numpy
from bevy_gaussian_splatting_tpu_torch.ops.project import as_float32
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
from bevy_gaussian_splatting_tpu_torch.train.losses import SurfaceLoss, mse
from bevy_gaussian_splatting_tpu_torch.utils import trace

FIELDS = tuple(f.name for f in dataclasses.fields(Gaussian3dCloud))  # a 3DGS cloud's


class TrainableCloud(torch.nn.Module):
    """A cloud whose fields are trainable float32 parameters; ``fields``
    names them, in the cloud class's order."""

    def __init__(self, cloud):
        super().__init__()
        cloud = as_float32(cloud)
        self.cloud_class = type(cloud)
        self.fields = tuple(f.name for f in dataclasses.fields(cloud))
        for name in self.fields:
            setattr(self, name, torch.nn.Parameter(getattr(cloud, name).detach().clone()))

    @classmethod
    def from_numpy(cls, arrays: dict, device: DeviceLike = None) -> "TrainableCloud":
        """From numpy arrays keyed by the cloud's field names (for example a
        JAX cloud's, carried across as in ``cloud_from_numpy``); on the card
        unless ``device`` says otherwise."""
        return cls(cloud_from_numpy(arrays, device))

    def cloud(self):
        """A view of the parameters as the cloud class (no copy)."""
        return self.cloud_class(**{name: getattr(self, name) for name in self.fields})

    def grads(self):
        """The last step's gradients as the cloud class (no copy), the
        counterpart of the cloud-shaped gradient of ``jax.grad``."""
        missing = [name for name in self.fields if getattr(self, name).grad is None]
        if missing:
            raise ValueError(f"no gradient for {missing}: run a training step first")
        return self.cloud_class(**{name: getattr(self, name).grad for name in self.fields})


def adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax.adam's defaults: betas (0.9, 0.999), eps 1e-8 added
    to the bias-corrected root."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(
    model: TrainableCloud,
    optimizer: torch.optim.Optimizer,
    camera: Camera,
    target: torch.Tensor,
    settings: Optional[CloudSettings] = None,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = mse,
    background: Optional[torch.Tensor] = None,
    pairs_max: Optional[int] = None,
    time=None,
    surface_loss: Optional[SurfaceLoss] = None,
) -> torch.Tensor:
    """Render ``model`` through ``camera`` (a 4DGS cloud at ``time``,
    default ``settings.time``), take ``loss_fn(image, target)``,
    back-propagate and step ``optimizer``.  Returns the loss (a detached
    scalar tensor; reading it waits for the card).  The gradients stay in
    the parameters' ``.grad`` until the next step.

    ``surface_loss`` (2DGS) adds 2DGS's geometric terms: the render also
    composites the surface maps (``render_tiled(..., aux_near=...)``) and
    the loss is ``loss_fn(image, target) + surface_loss(maps, camera)``
    (``train/losses.py``).

    A step is the span ``gs.step`` (``utils/trace.py``), and counts in the
    counters ``train.budget`` (the pair budget) and ``train.pairs`` (the
    frame's uncapped pairs, read only with the counters); a step with
    ``surface_loss`` counts in ``geometry.steps``."""
    with trace.span("gs.step"):
        with trace.span("gs.adam"):
            optimizer.zero_grad(set_to_none=True)
        image = render_tiled(
            model.cloud(), camera, settings or CloudSettings(),
            background=background, pairs_max=pairs_max, time=time, counter="train",
            aux_near=None if surface_loss is None else surface_loss.near,
        )
        if surface_loss is not None:
            image, maps = image
            trace.count("geometry.steps")
        with trace.span("gs.loss"):
            loss = loss_fn(image, target)
            if surface_loss is not None:
                loss = loss + surface_loss(maps, camera)
        with trace.span("gs.backward"):
            loss.backward()
        with trace.span("gs.adam"):
            optimizer.step()
        return loss.detach()


def shifted_arrays(arrays: dict, offset=(0.25, -0.15, 0.1)) -> dict:
    """A copy of ``arrays`` with every position moved by ``offset``
    (examples/training.py perturbs its cloud this way)."""
    out = dict(arrays)
    out["position_visibility"] = arrays["position_visibility"] + np.array([*offset, 0.0], np.float32)
    return out
