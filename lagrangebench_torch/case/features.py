"""Physical feature engineering: raw position windows -> model inputs.

The FeatureDict contract of the JAX package, dense layout (sparse: see
below):

    - "abs_pos"   (N, T, dim)   raw position window
    - "vel_hist"  (N, (T-1)*dim) normalized velocity history
    - "vel_mag"   (N, T-1)      velocity magnitudes (optional)
    - "bound"     (N, 2*dim)    clipped distance to walls (only without PBC)
    - "force"     (N, dim)      external force field (optional)
    - "senders"   (N, K)        sender per receiver slot (fill N)
    - "receivers" (N, K)        row index of each slot
    - "rel_disp"  (N, K, dim)   receiver - sender displacement / radius
    - "rel_dist"  (N, K, 1)     norm of rel_disp

A sparse list gives "senders" and "receivers" (E,) (fill N) and "rel_disp"
(E, dim), "rel_dist" (E, 1); a padded edge gathers row N-1 at both ends
(what an out-of-range JAX gather does), so its displacement is zero.
A dense list with in-kernel geometry (``aux``) supplies rel_disp/rel_dist
itself: the sender-position gather and min-image are skipped. In the slot
layout (a slot-format list) the node features (not "abs_pos") are gathered
into column-slot order, (n_ext, ...), "senders" is the (n_ext, K)
stencil-candidate matrix, the geometry comes from the list, and
"slot_bases", "slot_to_particle" and "particle_to_slot" are added for the
model.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..data.force import apply_force
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
        external_force_fn: per-particle external force ``(dim,) -> (dim,)``
            (optional), applied to every particle by ``apply_force``.
    """
    vel_stats = normalization_stats["velocity"]
    has_pbc = any(pbc)

    def feature_transform(pos_input: torch.Tensor, nbrs) -> FeatureDict:
        """pos_input: (N, T, dim) position window; nbrs: a NeighborList."""
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
            # per particle, as the JAX package's jax.vmap(external_force_fn)
            features["force"] = apply_force(external_force_fn, most_recent)

        if nbrs.format == "sparse":
            receivers, senders = nbrs.idx
            features["receivers"], features["senders"] = receivers, senders
            edge_disp = displacement_fn(most_recent[torch.clamp(receivers, max=n - 1).long()],
                                        most_recent[torch.clamp(senders, max=n - 1).long()])
            features["rel_disp"] = edge_disp / connectivity_radius
            features["rel_dist"] = space.distance(features["rel_disp"])[:, None]
            return features

        senders = nbrs.idx
        receivers = torch.arange(senders.shape[0], dtype=senders.dtype, device=senders.device)
        features["receivers"] = receivers[:, None].expand(senders.shape)
        features["senders"] = senders
        if nbrs.format == "slot":
            # column-slot order: the geometry comes from the scan kernel
            # (K7); node features are gathered into slot order, and the
            # model maps its output back with "particle_to_slot"
            aux = nbrs.aux
            s2p = torch.clamp(aux["slot_to_particle"], max=n - 1).long()
            for key in ("vel_hist", "vel_mag", "bound", "force"):
                if key in features:
                    features[key] = features[key][s2p]
            features["rel_disp"] = aux["rel_disp"]
            features["rel_dist"] = aux["rel_dist"]
            features["slot_bases"] = aux["bases"]
            features["slot_to_particle"] = aux["slot_to_particle"]
            features["particle_to_slot"] = aux["particle_to_slot"]
            return features
        if nbrs.aux is not None:
            # in-kernel geometry (K9): min-imaged and cutoff-normalized by
            # the scan, no sender-position gather here
            features["rel_disp"] = nbrs.aux["rel_disp"]
            features["rel_dist"] = nbrs.aux["rel_dist"]
            return features

        # dense (N, K): row i is receiver i. Senders fill with N; the
        # gather clamps them to N-1 (what an out-of-range JAX gather does)
        # and their slots are zeroed below.
        send_pos = most_recent[torch.clamp(senders, max=n - 1).long()]
        edge_disp = displacement_fn(most_recent[:, None, :], send_pos)
        valid = (senders < n)[..., None]
        rel_disp = torch.where(
            valid, edge_disp / connectivity_radius, torch.zeros_like(edge_disp)
        )
        features["rel_disp"] = rel_disp
        features["rel_dist"] = space.distance(rel_disp)[..., None]
        return features

    return feature_transform
