"""Synthetic inputs of the experiments: near-grid positions and the
bench-style metadata of an 8,000-particle periodic case.

The port's own copies of ``__graft_entry__.py::_grid_positions`` and of the
metadata that ``__graft_entry__.py::_make_case_and_model`` builds, in numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def grid_positions(n_particles: int, dim: int, box: float, isl: int,
                   seed: int = 0) -> np.ndarray:
    """Near-uniform particle positions with a small smooth motion history,
    (N, isl + 1, dim)."""
    rng = np.random.default_rng(seed)
    per_side = max(int(np.ceil(n_particles ** (1.0 / dim))), 2)
    axes = [np.linspace(0, box, per_side, endpoint=False) for _ in range(dim)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, dim)
    grid = grid[:n_particles]
    jitter = rng.normal(0, 0.05 * box / per_side, size=grid.shape)
    base = np.mod(grid + jitter, box)
    # slow per-particle velocities: positions change every frame while the
    # neighbor-count statistics stay stationary
    vel = rng.normal(0, 2e-5 * box, size=grid.shape)
    frames = [np.mod(base + t * vel, box) for t in range(isl + 1)]
    return np.stack(frames, axis=1)


def synthetic_metadata(n_particles: int, dim: int = 3) -> Dict:
    """Metadata of a periodic unit box of ``n_particles`` at grid spacing,
    with the connectivity radius 1.45 dx."""
    box = 1.0
    per_side = max(round(n_particles ** (1.0 / dim)), 2)
    dx = box / per_side
    return {
        "dim": dim,
        "dx": dx,
        "dt": 0.005,
        "write_every": 1,
        "num_particles_max": n_particles,
        "periodic_boundary_conditions": [True] * dim,
        "bounds": [[0.0, box]] * dim,
        "default_connectivity_radius": 1.45 * dx,
        "vel_mean": [0.0] * dim,
        "vel_std": [1e-3] * dim,
        "acc_mean": [0.0] * dim,
        "acc_std": [1e-8] * dim,
    }


def real_neighbor_indices(n_particles: int = 8000, dim: int = 3, isl: int = 6,
                          device="cuda"):
    """The (N, K) int32 sender indices of the dense neighbor list of
    ``grid_positions`` in a unit box, fill clamped to N - 1 (every index in
    range), as the JAX probe's variant 6 takes them: ``case_builder`` with
    the kernel backend (K1 and K2 on the card), multiplier 1.25."""
    import torch

    from ..case import case_builder

    case = case_builder(
        [1.0] * dim, synthetic_metadata(n_particles, dim), isl,
        cfg_neighbors={"backend": "auto", "multiplier": 1.25, "format": "dense"},
        noise_std=3e-4, device=device,
    )
    pos = grid_positions(n_particles, dim, 1.0, isl)
    ptype = np.zeros(n_particles, dtype=np.int64)
    _, neighbors = case.allocate_eval((pos[:, :isl], ptype))
    idx = torch.clamp(neighbors.idx, max=n_particles - 1)
    return idx.to(torch.int32).contiguous()
