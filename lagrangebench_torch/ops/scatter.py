"""Aggregation over the dense ``(N, K)`` and sparse ``(2, E)`` edge layouts.

Counterpart of ``lagrangebench_tpu/ops/scatter.py``:

* ``segment_sum``: rows into buckets by an id array, ids outside [0,
  num_segments) dropped, as ``jax.ops.segment_sum`` drops them; (N, K) ids
  are flattened (EGNN's sender-directed scatter). A ``float32``
  ``index_add_`` (16-bit data accumulates in float32 and is rounded once);
  on CUDA its atomics sum in an order that changes from run to run;
* ``segment_mean``: that sum over the count of ids in each bucket (at
  least 1);
* ``aggregate_to_receivers``: dense, row i of an (N, K) sender matrix IS
  receiver i, so the sum is a masked sum over K (slots whose sender is the
  fill value N drop out); sparse, a ``segment_sum`` over the receivers (a
  padded edge's receiver N drops);
* ``aggregate_mean_to_receivers``: that sum over the count of valid slots
  or edges (at least 1, so a particle without neighbors gives zeros).
"""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets by
    ``segment_ids``; ids outside [0, num_segments) drop. (N, K) ids take
    (N, K, ...) data."""
    if segment_ids.dim() == 2:
        data = data.reshape((-1,) + tuple(data.shape[2:]))
        segment_ids = segment_ids.reshape(-1)
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, num_segments).long()
    acc = torch.promote_types(data.dtype, torch.float32)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]), dtype=acc)
    return out.index_add(0, ids, data.to(acc))[:num_segments].to(data.dtype)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
                 ) -> torch.Tensor:
    """``segment_sum`` over the number of ids in each bucket (zero-safe)."""
    totals = segment_sum(data, segment_ids, num_segments)
    ones = data.new_ones((segment_ids.numel(),) + (1,) * (data.dim() - segment_ids.dim()))
    counts = segment_sum(ones, segment_ids.reshape(-1), num_segments)
    return totals / torch.clamp(counts, min=1)


def dense_mask(senders: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Valid slots of an (N, K) sender matrix: the fill value is N."""
    return senders < num_segments


def aggregate_to_receivers(data: torch.Tensor, receivers: torch.Tensor, senders: torch.Tensor,
                           num_segments: int, mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Sum per-edge ``data`` into its receivers: dense (N, K, ...) data, a
    masked sum over K (``mask`` (N, K) overrides the fill-value
    convention); sparse (E, ...) data, a sum by receiver id."""
    if receivers.dim() == 1:
        return segment_sum(data, receivers, num_segments)
    if mask is None:
        mask = dense_mask(senders, num_segments)
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - mask.dim()))
    return torch.where(mask, data, torch.zeros((), dtype=data.dtype, device=data.device)).sum(1)


def aggregate_mean_to_receivers(data: torch.Tensor, receivers: torch.Tensor,
                                senders: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean of per-edge ``data`` over each receiver's valid slots or edges
    (zero-safe)."""
    if receivers.dim() == 1:
        return segment_mean(data, receivers, num_segments)
    mask = dense_mask(senders, num_segments)
    total = aggregate_to_receivers(data, receivers, senders, num_segments, mask=mask)
    counts = mask.sum(1).to(data.dtype)
    counts = counts.reshape(tuple(counts.shape) + (1,) * (total.dim() - counts.dim()))
    return total / torch.clamp(counts, min=1)
