"""Physical feature engineering: raw position windows -> model inputs.

The FeatureDict contract of the JAX package, dense layout:

    - "abs_pos"   (N, T, dim)   raw position window
    - "vel_hist"  (N, (T-1)*dim) normalized velocity history
    - "vel_mag"   (N, T-1)      velocity magnitudes (optional)
    - "bound"     (N, 2*dim)    clipped distance to walls (only without PBC)
    - "force"     (N, dim)      external force field (optional)
    - "senders"   (N, K)        sender per receiver slot (fill N)
    - "receivers" (N, K)        row index of each slot
    - "rel_disp"  (N, K, dim)   receiver - sender displacement / radius
    - "rel_dist"  (N, K, 1)     norm of rel_disp
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..ops import space

FeatureDict = Dict[str, torch.Tensor]


def physical_feature_builder(
    bounds: list,
    normalization_stats: dict,
    connectivity_radius: float,
    displacement_fn: Callable,
    pbc: List[bool],
    magnitude_features: bool = False,
    external_force_fn: Optional[Callable] = None,
) -> Callable:
    """Build the feature transform closure.

    Args:
        bounds: per-dimension [lower, upper] bounds of the domain.
        normalization_stats: velocity/acceleration mean/std tensors.
        connectivity_radius: radius of the interaction graph.
        displacement_fn: boundary-aware displacement.
        pbc: per-dimension periodicity flags.
        magnitude_features: append velocity magnitudes.
        external_force_fn: per-position external force (optional).
    """
    vel_stats = normalization_stats["velocity"]
    has_pbc = any(pbc)

    def feature_transform(pos_input: torch.Tensor, nbrs) -> FeatureDict:
        """pos_input: (N, T, dim) position window; nbrs: dense NeighborList."""
        features = {}
        n = pos_input.shape[0]
        most_recent = pos_input[:, -1]

        vel_seq = displacement_fn(pos_input[:, 1:], pos_input[:, :-1])
        vel_seq_norm = (vel_seq - vel_stats["mean"]) / vel_stats["std"]
        features["abs_pos"] = pos_input
        features["vel_hist"] = vel_seq_norm.reshape(n, -1)
        if magnitude_features:
            features["vel_mag"] = torch.linalg.vector_norm(vel_seq_norm, dim=-1)

        if not has_pbc:
            b = torch.as_tensor(bounds, dtype=pos_input.dtype, device=pos_input.device)
            dist = torch.cat([most_recent - b[:, 0], b[:, 1] - most_recent], dim=1)
            features["bound"] = torch.clamp(dist / connectivity_radius, -1.0, 1.0)

        if external_force_fn is not None:
            features["force"] = external_force_fn(most_recent)

        # dense (N, K): row i is receiver i. Senders fill with N; the
        # gather clamps them to N-1 (what an out-of-range JAX gather does)
        # and their slots are zeroed below.
        senders = nbrs.idx
        receivers = torch.arange(n, dtype=senders.dtype, device=senders.device)
        receivers = receivers[:, None].expand(senders.shape)
        send_pos = most_recent[torch.clamp(senders, max=n - 1).long()]
        edge_disp = displacement_fn(most_recent[:, None, :], send_pos)
        valid = (senders < n)[..., None]
        rel_disp = torch.where(
            valid, edge_disp / connectivity_radius, torch.zeros_like(edge_disp)
        )
        features["receivers"] = receivers
        features["senders"] = senders
        features["rel_disp"] = rel_disp
        features["rel_dist"] = space.distance(rel_disp)[..., None]
        return features

    return feature_transform
