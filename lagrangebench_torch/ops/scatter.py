"""Aggregation over the dense ``(N, K)`` edge layout.

Counterpart of ``lagrangebench_tpu/ops/scatter.py``, dense branches only:

* ``aggregate_to_receivers``: row i of an (N, K) sender matrix IS receiver
  i, so the sum over receivers is a masked sum over K; slots whose sender is
  the fill value N drop out;
* ``aggregate_mean_to_receivers``: that sum over the count of valid slots
  (at least 1, so a row without neighbors gives zeros);
* ``segment_sum``: rows into buckets by an arbitrary id array (EGNN's
  sender-directed scatter), with (N, K) ids flattened and out-of-range ids
  dropped, as ``jax.ops.segment_sum`` drops them. On CUDA it is a float32
  ``index_add_``, whose atomics sum in an order that changes from run to
  run.

The sparse ``(2, E)`` layout is not ported (ROADMAP.md §1 item 6).
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
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, ids, data)[:num_segments]


def dense_mask(senders: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Valid slots of an (N, K) sender matrix: the fill value is N."""
    return senders < num_segments


def aggregate_to_receivers(data: torch.Tensor, receivers: torch.Tensor, senders: torch.Tensor,
                           num_segments: int, mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Sum per-edge ``data`` (N, K, ...) into its receivers: a masked sum
    over K (``mask`` (N, K) overrides the fill-value convention)."""
    if receivers.dim() != 2:
        raise NotImplementedError(
            "the sparse (2, E) edge layout is not ported to lagrangebench_torch "
            "(ROADMAP.md §1 item 6)")
    if mask is None:
        mask = dense_mask(senders, num_segments)
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - mask.dim()))
    return torch.where(mask, data, torch.zeros((), dtype=data.dtype, device=data.device)).sum(1)


def aggregate_mean_to_receivers(data: torch.Tensor, receivers: torch.Tensor,
                                senders: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean of per-edge ``data`` (N, K, ...) over each receiver's valid
    slots (zero-safe)."""
    if receivers.dim() != 2:
        raise NotImplementedError(
            "the sparse (2, E) edge layout is not ported to lagrangebench_torch "
            "(ROADMAP.md §1 item 6)")
    mask = dense_mask(senders, num_segments)
    total = aggregate_to_receivers(data, receivers, senders, num_segments, mask=mask)
    counts = mask.sum(1).to(data.dtype)
    counts = counts.reshape(tuple(counts.shape) + (1,) * (total.dim() - counts.dim()))
    return total / torch.clamp(counts, min=1)
