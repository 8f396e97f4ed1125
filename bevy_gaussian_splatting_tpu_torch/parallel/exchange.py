"""Bounded band exchange: each projected splat goes only to the ranks whose
band of tile rows its screen rectangle meets.

The counterpart of the JAX package's ``parallel/exchange.py``.  In place of
an all-gather of every projected row (each rank receives all N), an
all-to-all of per-destination slices: rank d receives ``n_bands * budget``
rows, the rows whose rectangle meets band d (exactly the rows its band's
binning window keeps), so the volume follows the band's coverage, not N.

  1. span expansion: (splat, band) pairs born in local index order (a
     splat spanning k bands appears k times), slot owners by a scatter-max
     and a cumulative max;
  2. one stable sort by destination band; within a destination the pairs
     stay in index order, so the all-to-all's concatenation (sources in
     rank order) leaves each receiver's rows in global cloud order, the
     order of the same rows in an all-gather;
  3. ``budget`` rows per destination, out-of-segment rows selected to zero
     (a budget too small drops the highest-index pairs; size it from
     :func:`band_pair_count` or :func:`auto_exchange_plan`);
  4. ``all_to_all_single`` with equal splits over the band group.

:func:`band_exchange` is differentiable in the payload: the backward runs
the same all-to-all in reverse, gathers the per-pair gradients back to
sorted order, unpermutes them to born order and sums each splat's (at most
``n_bands``) copies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def band_interval(ty0: torch.Tensor, ty1: torch.Tensor, rows_per_band: int):
    """First and last band that each splat's tile rows [ty0, ty1] meet."""
    return ty0 // rows_per_band, ty1 // rows_per_band


def band_pairs_budget(n_local: int, hint: Optional[int] = None, headroom: float = 1.25) -> int:
    """Static (splat, band) pair capacity per rank.  Without a hint, an
    average span of 2 bands."""
    if hint is None:
        return max(2 * n_local, 256)
    return min(max(int(hint * headroom) + 1, 256), 8 * n_local)


def exchange_bytes_per_device(n_total: int, n_bands: int, cols: int, budget: Optional[int] = None) -> dict:
    """Bytes each rank receives per frame: the all-gather's and, with a
    ``budget``, the bounded exchange's."""
    out = {"allgather": n_total * cols * 4}
    if budget is not None:
        out["bounded"] = n_bands * budget * cols * 4
    return out


def slot_owners(starts: torch.Tensor, p_max: int) -> torch.Tensor:
    """Owner of every slot of segments laid back to back (``starts`` [N]
    non-decreasing; ``p_max`` or more for an empty or dropped segment) ->
    [p_max]: the last owner whose segment starts at or before the slot, by a
    scatter-max and a cumulative max (the JAX package's ``slot_owner_scan``;
    slots past the last segment keep its owner, 0 where there is none)."""
    n = starts.shape[0]
    marks = torch.zeros(p_max + 1, dtype=torch.int64, device=starts.device)
    ids = torch.arange(1, n + 1, dtype=torch.int64, device=starts.device)
    marks.scatter_reduce_(0, torch.clamp(starts, max=p_max), ids, reduce="amax")
    return torch.clamp(torch.cummax(marks[:p_max], dim=0).values - 1, min=0)


def _plan(b0, b1, active, n_local: int, p_band: int, n_bands: int):
    """The exchange's integer plan -> ``(gidx, gidx_s, dest_s, inv_pair,
    seg_starts, seg_ends, offsets, span)``: each slot's owner in born order,
    the owners and destinations in destination order, the inverse of that
    sort, each destination's [start, end) in it, and each splat's first
    slot and span.  Int64 tensors."""
    dev = b0.device
    span = torch.where(active, b1 - b0 + 1, torch.zeros_like(b0)).to(torch.int64)
    cum = torch.cumsum(span, dim=0)
    total = cum[-1] if n_local else cum.new_zeros(())
    offsets = cum - span
    slots = torch.arange(p_band, dtype=torch.int64, device=dev)
    valid = slots < torch.clamp(total, max=p_band)
    gidx = slot_owners(torch.where(span > 0, offsets, torch.full_like(offsets, p_band)), p_band)
    k = slots - offsets[gidx]
    dest = torch.clamp(b0.to(torch.int64)[gidx] + k, 0, n_bands - 1)
    dest = torch.where(valid, dest, torch.full_like(dest, n_bands))  # the sentinel sorts last
    # pairs born in index order stay in index order within a destination
    dest_s, order = torch.sort(dest, stable=True)
    inv_pair = torch.empty_like(order)
    inv_pair[order] = slots
    bounds = torch.searchsorted(dest_s, torch.arange(n_bands + 1, dtype=torch.int64, device=dev))
    return gidx, gidx[order], dest_s, inv_pair, bounds[:n_bands], bounds[1:], offsets, span


def _send_buffer(pair_payload_s, seg_starts, seg_ends, n_bands: int, budget: int):
    """[n_bands, budget, C] per-destination slices by one row gather; rows
    past a segment's end select zero (``torch.where``, never a multiply: a
    bitcast sort key whose bits are a NaN must pass unchanged)."""
    p_band, cols = pair_payload_s.shape
    idx = seg_starts[:, None] + torch.arange(budget, dtype=torch.int64, device=seg_starts.device)[None, :]
    ok = idx < seg_ends[:, None]
    rows = pair_payload_s[torch.clamp(idx.reshape(-1), 0, p_band - 1)]
    rows = torch.where(ok.reshape(-1)[:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return rows.reshape(n_bands, budget, cols)


def _all_to_all(rows: torch.Tensor, group) -> torch.Tensor:
    """Equal-split all-to-all of [world * k, C] rows over ``group``."""
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows.contiguous(), group=group)
    return out


class BandExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, payload, b0, b1, active, n_bands, budget, group):
        n_local, cols = payload.shape
        p_band = band_pairs_budget(n_local)
        gidx, gidx_s, dest_s, inv_pair, seg_starts, seg_ends, offsets, span = _plan(
            b0, b1, active, n_local, p_band, n_bands
        )
        send = _send_buffer(payload[gidx_s], seg_starts, seg_ends, n_bands, budget)
        received = _all_to_all(send.reshape(n_bands * budget, cols), group)
        ctx.save_for_backward(dest_s, inv_pair, seg_starts, offsets, span)
        ctx.shape = (n_local, cols, n_bands, budget, p_band)
        ctx.group = group
        return received

    @staticmethod
    def backward(ctx, d_received):
        dest_s, inv_pair, seg_starts, offsets, span = ctx.saved_tensors
        n_local, cols, n_bands, budget, p_band = ctx.shape
        # the transpose of the all-to-all is the same all-to-all
        d_send = _all_to_all(d_received, ctx.group)
        # sorted position p belongs to segment dest_s[p] at offset
        # p - seg_starts[dest]; sentinel pairs and rows the forward dropped
        # read the trailing zero row
        d_flat = torch.cat([d_send, d_send.new_zeros((1, cols))])
        pos = torch.arange(p_band, dtype=torch.int64, device=dest_s.device)
        safe_dest = torch.clamp(dest_s, max=n_bands - 1)
        off = pos - seg_starts[safe_dest]
        ok = (dest_s < n_bands) & (off < budget)
        flat_idx = torch.where(ok, safe_dest * budget + off, torch.full_like(off, n_bands * budget))
        d_born = d_flat[flat_idx][inv_pair]
        # each splat's copies are contiguous in born order: sum them in order
        d_payload = d_born.new_zeros((n_local, cols))
        for k in range(n_bands):
            slot = offsets + k
            take = (k < span) & (slot < p_band)
            d_payload = d_payload + torch.where(
                take[:, None], d_born[torch.clamp(slot, max=p_band - 1)], torch.zeros((), dtype=d_born.dtype,
                                                                                      device=d_born.device)
            )
        return d_payload, None, None, None, None, None, None


def band_exchange(payload: torch.Tensor, b0, b1, active, n_bands: int, budget: int, group=None) -> torch.Tensor:
    """payload [N_local, C] -> received [n_bands * budget, C] on every rank
    of ``group`` (the band group; default the whole world).

    Rank d's output stacks, source rank by source rank, the source's rows
    whose band interval [b0, b1] holds d (``active`` rows only), in index
    order, zero past each source's segment, truncated at ``budget`` rows
    per source.  Differentiable in ``payload``."""
    return BandExchange.apply(payload, b0, b1, active, n_bands, budget, group)


def band_pair_count(b0, b1, active) -> torch.Tensor:
    """Exact (splat, band) pair count, for sizing a budget."""
    return torch.sum(torch.where(active, b1 - b0 + 1, torch.zeros_like(b0)))


def auto_exchange_plan(b0, b1, active, n_bands: int, n_local: int, headroom: float = 1.25, quantum: int = 256):
    """Host prepass -> ``(mode, budget)``: the per-(source, destination)
    budget from the actual band coverage of the whole padded cloud (rows
    ``[s * n_local, (s + 1) * n_local)`` are source ``s``'s) with
    ``headroom``, rounded up to ``quantum`` and at most the pair capacity,
    and ``"bounded"`` only where a rank receives fewer rows that way
    (``n_bands * budget``) than the all-gather's N.  Numpy, as the JAX
    package's."""
    b0, b1 = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in (b0, b1))
    act = np.asarray(active.cpu() if isinstance(active, torch.Tensor) else active).astype(bool)
    n_total = b0.shape[0]
    if n_total % n_local:
        raise ValueError(f"n_total {n_total} not a multiple of n_local {n_local}")
    n_src = n_total // n_local
    d = np.arange(n_bands)
    cover = act[:, None] & (b0[:, None] <= d) & (d <= b1[:, None])  # [N, bands]
    counts = cover.reshape(n_src, n_local, n_bands).sum(axis=1)  # [source, destination]
    maxcount = int(counts.max()) if counts.size else 0
    budget = -(-max(int(maxcount * headroom), 1) // quantum) * quantum
    budget = min(budget, band_pairs_budget(n_local))
    mode = "bounded" if n_bands * budget < n_total else "allgather"
    return mode, budget
