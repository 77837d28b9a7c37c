"""A batch of graphs as one disjoint super-graph.

Counterpart of ``lagrangebench_tpu/ops/batching.py``. Message passing never
crosses graph boundaries, so B independent N-particle graphs are one
(B*N)-particle graph whose edge ids are offset per sample: sample b's ids
by b*N, and a padded id (fill N) maps to the flat fill B*N.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def flatten_graph_batch(features: Dict[str, torch.Tensor], particle_type: torch.Tensor
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(B, ...) batched features -> the flat super-graph's features.

    Either edge layout: dense ids are (B, N, K) and edge features
    (B, N, K, ...); sparse ids are (B, E) and edge features (B, E, ...).
    """
    b, n = particle_type.shape

    def flat(x):
        return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

    out = {}
    for key, v in features.items():
        if key in ("senders", "receivers"):
            off = (torch.arange(b, dtype=v.dtype, device=v.device) * n).view(
                (b,) + (1,) * (v.dim() - 1))
            out[key] = flat(torch.where(v < n, v + off, b * n))
        else:
            out[key] = flat(v)
    return out, particle_type.reshape(b * n)


def unflatten_nodes(x: torch.Tensor, b: int, n: int) -> torch.Tensor:
    """Flat per-node outputs (B*N, ...) back to (B, N, ...)."""
    return x.reshape((b, n) + tuple(x.shape[1:]))
