"""The differentiable compositing core of the training step.

The counterpart of the JAX package's ``ops/pallas/core.py``
``get_train_core_windowed`` (a ``jax.custom_vjp``) as a
``torch.autograd.Function``:

  forward:  params_sorted = params[g_s]; the forward compositor kernel
            (``composite_tiles_raw``) -> raw [T, 4, 256]
  backward: gbar from the cotangent and the saved raw output
            -> the backward kernel (``composite_backward``), per-pair
               gradients in pair-sorted order
            -> slot order: ``dslot[order] = dsorted``, the inverse of the
               binning's stable tile sort (the JAX package re-sorts by depth
               rank instead, a TPU cost choice; both give slot order exactly)
            -> the segmented reduce kernel (``segment_reduce``), per depth rank
            -> cloud order: ``dparams[perm] = drank`` (the JAX package's
               "perm"/"rank" formulations are one permutation, chosen there
               by a TPU cost model)

With ``aux_near`` (2DGS training with the surface regularisers) the forward
also returns the surface maps [T, 6, 256] (``tile_fwd.py``) and keeps their
totals; the backward takes the maps' cotangent beside the image's
(``pack_surface_gbar``) and its per-pair rows are 23 columns wide.

Like the custom VJP it is not twice differentiable.  The integer binning
artifacts get no gradient.  On CPU tensors both passes run the kernels' plain
versions, so the hand-derived backward is what the CPU tests check.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from bevy_gaussian_splatting_tpu_torch.ops.cuda.reduce import segment_reduce
from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_bwd import composite_backward, pack_gbar, pack_surface_gbar
from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MAX_CHUNK, MODE_OBB, composite_tiles_raw
from bevy_gaussian_splatting_tpu_torch.utils.trace import span


class CompositeCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, g_s, start, count, order, cum, perm, geometry, aux_near=None):
        with span("gs.pack"):
            params_sorted = params[g_s].contiguous()
        out = composite_tiles_raw(params_sorted, start, count, *geometry, aux_near=aux_near)
        ctx.geometry = geometry
        ctx.aux_near = aux_near
        if aux_near is None:
            ctx.save_for_backward(params_sorted, start, count, order, cum, perm, out)
            return out
        out_raw, maps, totals = out
        ctx.save_for_backward(params_sorted, start, count, order, cum, perm, out_raw, maps, totals)
        return out_raw, maps

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_raw, grad_maps=None):
        *geometry, bbox = ctx.geometry
        if bbox:
            # the JAX package trains the overlay through XLA autodiff of its
            # plain compositor, not this core (rasterize_tile.py:1178-1181)
            raise NotImplementedError(
                "the bounding-box overlay has no backward kernel: render it with "
                "render_tiled(..., differentiable=True) to train through it"
            )
        params_sorted, start, count, order, cum, perm, out_raw, *surface = ctx.saved_tensors
        with span("gs.composite_bwd"):
            gbar = pack_gbar(grad_raw, out_raw)
            gaux = None
            if surface:
                gaux = pack_surface_gbar(grad_maps, *surface)
            dsorted = composite_backward(params_sorted, start, count, gbar, *geometry, gaux=gaux,
                                         aux_near=ctx.aux_near)
        with span("gs.unpermute"):
            dslot = torch.empty_like(dsorted)
            dslot[order] = dsorted
        with span("gs.reduce"):
            drank = segment_reduce(dslot, cum, perm.shape[0])
        with span("gs.unpermute"):
            dparams = torch.empty_like(drank)
            dparams[perm.to(torch.int64)] = drank
        return dparams, None, None, None, None, None, None, None, None


def composite_core(
    params: torch.Tensor,
    g_s: torch.Tensor,
    start: torch.Tensor,
    count: torch.Tensor,
    order: torch.Tensor,
    cum: torch.Tensor,
    perm: torch.Tensor,
    tx_count: int,
    width: int,
    full_height: int,
    y0: int = 0,
    chunk: int = MAX_CHUNK,
    mode: int = MODE_OBB,
    bbox: bool = False,
    aux_near: Optional[float] = None,
):
    """Raw compositor output [T, 4, 256], differentiable in ``params``
    [N, param_width(mode)] (cloud order, ``mode``'s row layout: 10 columns,
    16 for 2DGS) through the hand-derived backward.  ``bbox`` draws the
    bounding-box overlay, for serving only: its backward raises.
    ``aux_near`` (2DGS rows of 23 columns) -> ``(raw, maps)``, both
    differentiable, with the surface maps [T, 6, 256] of
    ``composite_tiles_raw``.

    ``g_s`` [P]: cloud index of each tile-sorted pair; ``start``/``count``
    [T]: tile ranges; ``order`` [P]: expansion slot of each tile-sorted pair;
    ``cum`` [N]: clamped inclusive pair counts in depth order; ``perm`` [N]:
    cloud index of each depth rank (``rasterize_tile.tile_bins``)."""
    return CompositeCore.apply(
        params, g_s, start, count, order, cum, perm, (tx_count, width, full_height, y0, chunk, mode, bbox), aux_near
    )
