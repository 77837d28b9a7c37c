"""Case setup for evaluation: neighbor search, features and integration.

Counterpart of the eval half of ``lagrangebench_tpu/case/case.py``: the
case captures box, metadata and normalization once and returns functions.

    * ``allocate_eval`` sizes the neighbor buffers on the host from one
      sample, then runs ``preprocess_eval``;
    * ``preprocess_eval`` updates the neighbor list and builds features;
    * ``preprocess_eval_batched`` does the same for a batch of B samples as
      ONE flat (B*N)-row super-graph (per-sample sender offsets; padded
      slots map to B*N), with one launch of each neighbor kernel;
    * ``integrate`` is semi-implicit Euler with dt = 1 folded into the
      normalization.

The train preprocess and its random-walk noise are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import Config, merge
from ..data.stats import get_dataset_stats
from ..defaults import defaults, resolve_backend
from ..ops import neighbors as nb
from ..ops import space
from ..utils import resolve_device
from .features import physical_feature_builder


class CaseSetupFn(NamedTuple):
    """Bundle of case functions (eval half).

    Attributes:
        allocate_eval: host-side sizing + eval preprocess of one sample.
        preprocess_eval: eval preprocess of one sample.
        preprocess_eval_batched: eval preprocess of a batch, flat features.
        integrate: semi-implicit Euler step inverting output normalization.
        displacement: boundary-aware displacement function.
        shift: boundary-aware shift function.
        normalization_stats: velocity/acceleration stats (tensors).
        device: the device the case's tensors live on.
    """

    allocate_eval: Callable
    preprocess_eval: Callable
    preprocess_eval_batched: Callable
    integrate: Callable
    displacement: Callable
    shift: Callable
    normalization_stats: Dict
    device: torch.device


def case_builder(
    box,
    metadata: Dict,
    input_seq_length: int,
    cfg_neighbors: Union[Dict, Config, None] = None,
    cfg_model: Union[Dict, Config, None] = None,
    noise_std: float = defaults.train.noise_std,
    external_force_fn: Optional[Callable] = None,
    dtype=torch.float32,
    device="cuda",
) -> CaseSetupFn:
    """Set up the simulation case.

    Args:
        box: box side lengths (dim,).
        metadata: dataset metadata dict.
        input_seq_length: number of input positions (velocity history + 1).
        cfg_neighbors: neighbor-search config subset (backend, multiplier).
        cfg_model: model config subset (isotropic_norm, magnitude_features).
        noise_std: GNS noise std folded into normalization stats.
        external_force_fn: per-position external force.
        dtype: preprocessing dtype.
        device: "cuda" (default) or "cpu"; raises without CUDA unless "cpu".
    """
    device = resolve_device(device)
    cfg_neighbors = merge(defaults.neighbors, cfg_neighbors or {})
    cfg_model = merge(defaults.model, cfg_model or {})
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)

    stats_np = get_dataset_stats(metadata, cfg_model.isotropic_norm, noise_std)
    normalization_stats = {
        k: {s: torch.as_tensor(v, dtype=dtype, device=device) for s, v in d.items()}
        for k, d in stats_np.items()
    }

    pbc = list(metadata["periodic_boundary_conditions"])
    if any(pbc):
        side = torch.as_tensor(np.asarray(box), dtype=dtype, device=device)
        displacement_fn, shift_fn = space.periodic(side)
    else:
        displacement_fn, shift_fn = space.free()

    neighbor_fn = nb.neighbor_list(
        displacement_fn,
        box,
        r_cutoff=metadata["default_connectivity_radius"],
        backend=resolve_backend(cfg_neighbors.backend),
        capacity_multiplier=float(cfg_neighbors.multiplier),
        num_particles_max=metadata["num_particles_max"],
        pbc=pbc,
        format=cfg_neighbors.get("format", "dense"),
    )

    feature_transform = physical_feature_builder(
        bounds=metadata["bounds"],
        normalization_stats=normalization_stats,
        connectivity_radius=metadata["default_connectivity_radius"],
        displacement_fn=displacement_fn,
        pbc=pbc,
        magnitude_features=cfg_model.magnitude_features,
        external_force_fn=external_force_fn,
    )

    def _as(x, dt=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dt, device=device)

    def preprocess_eval_fn(sample, neighbors: nb.NeighborList):
        """sample = ((N, T, dim) positions, (N,) types) -> features, nbrs."""
        pos_input = _as(sample[0], dtype)
        particle_type = _as(sample[1])
        most_recent = pos_input[:, input_seq_length - 1]
        num_particles = (particle_type != -1).sum()
        neighbors = neighbors.update(most_recent, num_particles=num_particles)
        features = feature_transform(pos_input[:, :input_seq_length], neighbors)
        return features, neighbors

    def preprocess_eval_batched_fn(sample, neighbors: nb.NeighborList):
        """sample = ((B, N, T, dim), (B, N)) -> flat features, batched nbrs.

        The neighbor update is per sample (one batched launch); the feature
        transform runs once on the (B*N)-row disjoint super-graph. The
        returned NeighborList stays batched for capacity/overflow.
        """
        pos_input = _as(sample[0], dtype)
        particle_type = _as(sample[1])
        b, n = particle_type.shape
        most_recent = pos_input[:, :, input_seq_length - 1]
        num_particles = (particle_type != -1).sum(dim=1)
        neighbors = neighbors.update(most_recent, num_particles=num_particles)

        idx = neighbors.idx
        off = (torch.arange(b, dtype=idx.dtype, device=device) * n).view(b, 1, 1)
        idx_flat = torch.where(idx < n, idx + off, b * n).reshape(b * n, idx.shape[-1])
        flat_nbrs = nb.NeighborList(
            idx=idx_flat,
            did_buffer_overflow=neighbors.did_buffer_overflow.any(),
            update_fn=neighbors.update_fn,
        )
        pos_flat = pos_input.reshape((b * n,) + pos_input.shape[2:])
        features = feature_transform(pos_flat[:, :input_seq_length], flat_nbrs)
        return features, neighbors

    def allocate_eval_fn(sample, capacity_boost: float = 1.0):
        """Size the neighbor buffers on the host from the raw sample, then
        preprocess it (no noise, no targets)."""
        pos_np = np.asarray(
            sample[0].cpu() if isinstance(sample[0], torch.Tensor) else sample[0]
        )
        ptype_np = np.asarray(
            sample[1].cpu() if isinstance(sample[1], torch.Tensor) else sample[1]
        )
        npart = int((ptype_np != -1).sum())
        shell = neighbor_fn.allocate_shell(
            pos_np[:, input_seq_length - 1], num_particles=npart,
            capacity_boost=capacity_boost, device=device,
        )
        return preprocess_eval_fn(sample, shell)

    def integrate_fn(normalized_in: Dict[str, torch.Tensor], position_sequence):
        """Next position from a model output dict (dt = 1: the stats absorb
        the timestep). ``position_sequence`` is (..., N, T, dim)."""
        if "pos" in normalized_in:
            return normalized_in["pos"]
        most_recent = position_sequence[..., -1, :]
        if "vel" in normalized_in:
            stats = normalization_stats["velocity"]
            new_velocity = stats["mean"] + normalized_in["vel"] * stats["std"]
        elif "acc" in normalized_in:
            stats = normalization_stats["acceleration"]
            acc = stats["mean"] + normalized_in["acc"] * stats["std"]
            last_velocity = displacement_fn(most_recent, position_sequence[..., -2, :])
            new_velocity = last_velocity + acc
        else:
            raise KeyError("model output needs one of 'pos', 'vel', 'acc'")
        return shift_fn(most_recent, new_velocity)

    return CaseSetupFn(
        allocate_eval=allocate_eval_fn,
        preprocess_eval=preprocess_eval_fn,
        preprocess_eval_batched=preprocess_eval_batched_fn,
        integrate=integrate_fn,
        displacement=displacement_fn,
        shift=shift_fn,
        normalization_stats=normalization_stats,
        device=device,
    )
