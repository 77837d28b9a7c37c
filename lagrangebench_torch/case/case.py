"""Case setup: neighbor search, features, targets, noise and integration.

Counterpart of ``lagrangebench_tpu/case/case.py``: the case captures box,
metadata and normalization once and returns functions.

    * ``allocate`` / ``allocate_eval`` size the neighbor buffers on the host
      from one sample, then run ``preprocess`` / ``preprocess_eval``;
    * ``preprocess`` (train) applies random-walk noise, updates the neighbor
      list, builds features and the targets of the frame
      ``input_seq_length - 1 + unroll_steps``; ``preprocess_eval`` does the
      same without noise and targets;
    * ``preprocess_batched`` and ``preprocess_eval_batched`` do the same for
      a batch of B samples as ONE flat (B*N)-row super-graph (per-sample
      sender offsets; padded slots map to B*N), with one neighbor search for
      the batch. The dense layout builds the features on the flat graph;
      the sparse layout builds each sample's, then offsets its edge ids
      (``ops.batching.flatten_graph_batch``). The slot neighbor layout is
      single-sample: it takes batch 1 (the sample's own slot features) and
      raises above;
    * ``integrate`` is semi-implicit Euler with dt = 1 folded into the
      normalization.

The train functions take a ``torch.Generator`` where the JAX package takes
a key (the generator advances; nothing is returned for it), and an optional
standard-normal ``draw`` that replaces the generator's numbers.
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
from ..ops.batching import flatten_graph_batch
from ..train.strats import add_gns_noise
from ..utils import resolve_device
from .features import physical_feature_builder


class CaseSetupFn(NamedTuple):
    """Bundle of case functions.

    Attributes:
        allocate: host-side sizing + train preprocess of one sample.
        preprocess: train preprocess (noise, neighbor update, features,
            targets) of one sample.
        allocate_eval: host-side sizing + eval preprocess of one sample.
        preprocess_eval: eval preprocess of one sample.
        preprocess_batched: train preprocess of a batch, flat features and
            targets.
        preprocess_eval_batched: eval preprocess of a batch, flat features.
        integrate: semi-implicit Euler step inverting output normalization.
        displacement: boundary-aware displacement function.
        shift: boundary-aware shift function.
        normalization_stats: velocity/acceleration stats (tensors).
        device: the device the case's tensors live on.
        dtype: the preprocessing dtype (positions, noise, features).
    """

    allocate: Callable
    preprocess: Callable
    allocate_eval: Callable
    preprocess_eval: Callable
    preprocess_batched: Callable
    preprocess_eval_batched: Callable
    integrate: Callable
    displacement: Callable
    shift: Callable
    normalization_stats: Dict
    device: torch.device
    dtype: torch.dtype


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
        cfg_neighbors: neighbor-search config subset (backend, multiplier,
            format, emit_geometry).
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

    fmt = cfg_neighbors.get("format", "dense")
    neighbor_fn = nb.neighbor_list(
        displacement_fn,
        box,
        r_cutoff=metadata["default_connectivity_radius"],
        backend=resolve_backend(cfg_neighbors.backend, fmt),
        capacity_multiplier=float(cfg_neighbors.multiplier),
        num_particles_max=metadata["num_particles_max"],
        pbc=pbc,
        format=fmt,
        emit_geometry=bool(cfg_neighbors.get("emit_geometry", False)),
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

    def _compute_target(pos_triplet: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Normalized targets from three consecutive frames (N, 3, dim)."""
        current_vel = displacement_fn(pos_triplet[:, 1], pos_triplet[:, 0])
        next_vel = displacement_fn(pos_triplet[:, 2], pos_triplet[:, 1])
        acc = next_vel - current_vel
        acc_stats = normalization_stats["acceleration"]
        vel_stats = normalization_stats["velocity"]
        return {
            "acc": (acc - acc_stats["mean"]) / acc_stats["std"],
            "vel": (next_vel - vel_stats["mean"]) / vel_stats["std"],
            "pos": pos_triplet[:, -1],
        }

    def _noised(generator, pos_input, particle_type, noise_std_, draw):
        if pos_input.shape[-2] <= 1:
            return pos_input
        return add_gns_noise(pos_input, particle_type, input_seq_length, noise_std_,
                             shift_fn, generator=generator, draw=draw)

    def _targets(pos, unroll_steps: int):
        # the 2nd finite difference around frame isl - 1 + unroll_steps
        begin = input_seq_length - 2 + unroll_steps
        return _compute_target(pos[:, begin : begin + 3])

    def _preprocess(pos_input, particle_type, neighbors: nb.NeighborList):
        most_recent = pos_input[:, input_seq_length - 1]
        num_particles = (particle_type != -1).sum()
        neighbors = neighbors.update(most_recent, num_particles=num_particles)
        return feature_transform(pos_input[:, :input_seq_length], neighbors), neighbors

    def preprocess_fn(generator, sample, noise_std_, neighbors: nb.NeighborList,
                      unroll_steps: int = 0, draw=None):
        """Train preprocess of one sample ((N, T, dim), (N,)): noise, then
        the neighbor update, features and targets. Returns (features,
        targets, neighbors)."""
        particle_type = _as(sample[1])
        pos_input = _noised(generator, _as(sample[0], dtype), particle_type, noise_std_, draw)
        features, neighbors = _preprocess(pos_input, particle_type, neighbors)
        return features, _targets(pos_input, unroll_steps), neighbors

    def preprocess_eval_fn(sample, neighbors: nb.NeighborList):
        """sample = ((N, T, dim) positions, (N,) types) -> features, nbrs."""
        return _preprocess(_as(sample[0], dtype), _as(sample[1]), neighbors)

    def _preprocess_batched(pos_input, particle_type, neighbors: nb.NeighborList):
        b, n = particle_type.shape
        if neighbors.format == "slot" and b != 1:
            raise ValueError(
                f"the slot neighbor layout runs one sample at a time (batch {b} asked): "
                "the JAX package's slot layout is single-sample, and its batched "
                "preprocess fails above batch 1; use batch size 1"
            )
        most_recent = pos_input[:, :, input_seq_length - 1]
        num_particles = (particle_type != -1).sum(dim=1)
        neighbors = neighbors.update(most_recent, num_particles=num_particles)
        pos_flat = pos_input.reshape((b * n,) + pos_input.shape[2:])
        if neighbors.format == "slot":
            # batch 1: the sample's own slot graph, unchanged (its candidate
            # ids are not particle ids and take no offset)
            features = feature_transform(pos_input[0, :, :input_seq_length],
                                         neighbors.select(0))
            return features, neighbors, pos_flat

        if neighbors.format == "sparse":
            # each sample's transform, then its edge ids offset into the
            # flat graph (the JAX package's vmapped transform and
            # flatten_graph_batch)
            per_sample = [feature_transform(pos_input[i, :, :input_seq_length],
                                            neighbors.select(i)) for i in range(b)]
            features, _ = flatten_graph_batch(
                {k: torch.stack([f[k] for f in per_sample]) for k in per_sample[0]},
                particle_type)
            return features, neighbors, pos_flat

        idx = neighbors.idx
        off = (torch.arange(b, dtype=idx.dtype, device=device) * n).view(b, 1, 1)
        idx_flat = torch.where(idx < n, idx + off, b * n).reshape(b * n, idx.shape[-1])
        # in-kernel geometry is per-sample rows: flatten it beside the index
        aux = neighbors.aux
        flat_nbrs = nb.NeighborList(
            idx=idx_flat,
            did_buffer_overflow=neighbors.did_buffer_overflow.any(),
            update_fn=neighbors.update_fn,
            aux=None if aux is None else {k: v.reshape((b * n,) + v.shape[2:])
                                          for k, v in aux.items()},
            backend=neighbors.backend,
        )
        features = feature_transform(pos_flat[:, :input_seq_length], flat_nbrs)
        return features, neighbors, pos_flat

    def preprocess_batched_fn(generator, sample, noise_std_, neighbors: nb.NeighborList,
                              unroll_steps: int = 0, draw=None):
        """Train preprocess of a batch ((B, N, T, dim), (B, N)): per-sample
        noise (``draw``: (B, N, input_seq_length - 1, dim)) and neighbor
        update, then features and targets on the flat (B*N)-row
        super-graph. Returns (flat features, flat targets, batched nbrs)."""
        particle_type = _as(sample[1])
        pos_input = _noised(generator, _as(sample[0], dtype), particle_type, noise_std_, draw)
        features, neighbors, pos_flat = _preprocess_batched(pos_input, particle_type,
                                                            neighbors)
        return features, _targets(pos_flat, unroll_steps), neighbors

    def preprocess_eval_batched_fn(sample, neighbors: nb.NeighborList):
        """sample = ((B, N, T, dim), (B, N)) -> flat features, batched nbrs.

        The neighbor update is per sample (one batched launch); the feature
        transform runs once on the (B*N)-row disjoint super-graph. The
        returned NeighborList stays batched for capacity/overflow.
        """
        features, neighbors, _ = _preprocess_batched(_as(sample[0], dtype),
                                                     _as(sample[1]), neighbors)
        return features, neighbors

    def _allocate_shell(sample, capacity_boost: float = 1.0) -> nb.NeighborList:
        """Neighbor buffers sized on the host from the un-noised most recent
        position of the raw sample (the capacity multiplier absorbs the
        training noise)."""
        pos_np = np.asarray(
            sample[0].cpu() if isinstance(sample[0], torch.Tensor) else sample[0]
        )
        ptype_np = np.asarray(
            sample[1].cpu() if isinstance(sample[1], torch.Tensor) else sample[1]
        )
        npart = int((ptype_np != -1).sum())
        return neighbor_fn.allocate_shell(
            pos_np[:, input_seq_length - 1], num_particles=npart,
            capacity_boost=capacity_boost, device=device,
        )

    def allocate_fn(generator, sample, noise_std_=noise_std, unroll_steps: int = 0,
                    capacity_boost: float = 1.0, draw=None):
        """Size the neighbor buffers from the raw sample, then run the train
        preprocess on it."""
        shell = _allocate_shell(sample, capacity_boost)
        return preprocess_fn(generator, sample, noise_std_, shell, unroll_steps, draw)

    def allocate_eval_fn(sample, capacity_boost: float = 1.0):
        """Size the neighbor buffers on the host from the raw sample, then
        preprocess it (no noise, no targets)."""
        return preprocess_eval_fn(sample, _allocate_shell(sample, capacity_boost))

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
        allocate=allocate_fn,
        preprocess=preprocess_fn,
        allocate_eval=allocate_eval_fn,
        preprocess_eval=preprocess_eval_fn,
        preprocess_batched=preprocess_batched_fn,
        preprocess_eval_batched=preprocess_eval_batched_fn,
        integrate=integrate_fn,
        displacement=displacement_fn,
        shift=shift_fn,
        normalization_stats=normalization_stats,
        device=device,
        dtype=dtype,
    )
