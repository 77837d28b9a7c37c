"""Synthetic LagrangeBench-format datasets (tests, demos, smoke runs).

Smooth quasi-harmonic trajectories wrapped in a periodic box, with metadata
statistics computed from the generated data. ``_trajectory`` and ``_stats``
draw the same numbers as the JAX package's generator from the same seed, so
both packages see bit-equal data. ``make_synthetic_arrays`` keeps the
trajectories in memory (no h5py); ``make_synthetic_dataset`` writes the
on-disk layout.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# (split, seed offset); each split's trajectory i uses seed offset + i
_SPLITS = (("train", 0), ("valid", 100), ("test", 200))


def _trajectory(
    seq_len: int, n_particles: int, dim: int, box: float, seed: int
) -> np.ndarray:
    """Smooth periodic trajectories, shape (seq_len, N, dim)."""
    rng = np.random.default_rng(seed)
    t = np.arange(seq_len)[:, None, None]
    base = rng.uniform(0, box, size=(1, n_particles, dim))
    amp = rng.uniform(0.01, 0.06, size=(1, n_particles, dim)) * box
    omega = rng.uniform(0.02, 0.08, size=(1, n_particles, dim))
    phase = rng.uniform(0, 2 * np.pi, size=(1, n_particles, dim))
    drift = rng.uniform(-0.002, 0.002, size=(1, n_particles, dim)) * box
    pos = base + amp * np.sin(omega * t + phase) + drift * t
    return np.mod(pos, box).astype(np.float64)


def _stats(trajs, box: float, dim: int) -> dict:
    """Per-dimension vel/acc stats with PBC-aware finite differences."""
    vels, accs = [], []
    for pos in trajs:
        disp = pos[1:] - pos[:-1]
        vel = np.mod(disp + box / 2, box) - box / 2
        acc = vel[1:] - vel[:-1]
        vels.append(vel.reshape(-1, dim))
        accs.append(acc.reshape(-1, dim))
    vels = np.concatenate(vels)
    accs = np.concatenate(accs)
    return {
        "vel_mean": vels.mean(0).tolist(),
        "vel_std": vels.std(0).tolist(),
        "acc_mean": accs.mean(0).tolist(),
        "acc_std": accs.std(0).tolist(),
    }


def make_synthetic_arrays(
    n_particles: int = 3,
    dim: int = 3,
    box: float = 5.0,
    radius: Optional[float] = None,
    seq_len_train: int = 60,
    seq_len_eval: int = 30,
    n_trajs: int = 2,
    dx: Optional[float] = None,
    name: str = "SYN",
) -> Tuple[Dict[str, List[np.ndarray]], dict]:
    """Synthetic trajectories per split and their metadata, in memory."""
    if dx is None:
        dx = box / max(round(n_particles ** (1.0 / dim)), 1)
    if radius is None:
        radius = 1.45 * dx
    splits = {
        split: [
            _trajectory(
                seq_len_train if split == "train" else seq_len_eval,
                n_particles, dim, box, seed=offset + i,
            )
            for i in range(n_trajs)
        ]
        for split, offset in _SPLITS
    }
    metadata = {
        "case": name,
        "solver": "synthetic",
        "dim": dim,
        "dx": dx,
        "dt": 0.005,
        "write_every": 1,
        "sequence_length_train": seq_len_train,
        "num_trajs_train": n_trajs,
        "sequence_length_test": seq_len_eval,
        "num_trajs_test": n_trajs,
        "num_particles_max": n_particles,
        "periodic_boundary_conditions": [True] * dim,
        "bounds": [[0.0, box]] * dim,
        "default_connectivity_radius": radius,
        **_stats(splits["train"], box, dim),
    }
    return splits, metadata


def make_synthetic_dataset(root: str, name: str = "SYN", **kwargs) -> str:
    """Write a synthetic dataset directory (HDF5 + metadata); returns its path.

    Takes the keyword arguments of :func:`make_synthetic_arrays`.
    """
    import h5py

    splits, metadata = make_synthetic_arrays(name=name, **kwargs)
    n, dim = metadata["num_particles_max"], metadata["dim"]
    path = os.path.join(root, f"{dim}D_{name}_{n}_synthetic")
    os.makedirs(path, exist_ok=True)
    for split, trajs in splits.items():
        with h5py.File(os.path.join(path, f"{split}.h5"), "w") as f:
            for i, pos in enumerate(trajs):
                g = f.create_group(f"{i:05d}")
                g.create_dataset("position", data=pos)
                g.create_dataset("particle_type", data=np.zeros(n, dtype=np.int64))
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    return path
