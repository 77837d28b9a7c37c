"""Dataset statistics and consolidation for LagrangeBench-format HDF5 files.

Counterpart of ``lagrangebench_tpu/data_gen/h5_tools.py``: PBC-aware
two-pass mean/std of velocities and accelerations over fluid particles
(:func:`compute_statistics` on trajectories in memory, which the ``.h5``
reader :func:`compute_statistics_h5` feeds), and consolidation of
trajectories into train/valid/test splits with ``metadata.json``. h5py is
imported only where files are read or written.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from ..utils import NodeType


def _pbc_diff(x: np.ndarray, box: np.ndarray, pbc: Sequence[bool]) -> np.ndarray:
    """Minimum-image finite difference along axis 0 (frames)."""
    d = x[1:] - x[:-1]
    if any(pbc):
        d = np.mod(d + box * 0.5, box) - box * 0.5
    return d


def compute_statistics(
    trajectories: Iterable[Tuple[np.ndarray, np.ndarray]],
    box: Sequence[float],
    pbc: Sequence[bool],
    fluid_type: int = NodeType.FLUID,
) -> Dict[str, List[float]]:
    """Two-pass per-dimension velocity/acceleration statistics.

    ``trajectories``: (positions (T, N, dim), particle_type (N,)) pairs, in
    the order the statistics accumulate them (re-iterable: a list, or an
    object whose ``__iter__`` reads them anew). Velocities are PBC-aware
    finite differences of positions; accelerations their finite
    differences. Only fluid particles contribute (walls are kinematic).
    Pass 1 accumulates means, pass 2 variances.
    """
    box = np.asarray(box, dtype=np.float64)
    dim = box.shape[0]

    def fluid():
        for pos, ptype in trajectories:
            yield pos[:, ptype == fluid_type]

    sums = {"vel": np.zeros(dim), "acc": np.zeros(dim)}
    counts = {"vel": 0, "acc": 0}
    for pos in fluid():
        vel = _pbc_diff(pos, box, pbc)
        acc = vel[1:] - vel[:-1]
        sums["vel"] += vel.sum(axis=(0, 1))
        sums["acc"] += acc.sum(axis=(0, 1))
        counts["vel"] += vel.shape[0] * vel.shape[1]
        counts["acc"] += acc.shape[0] * acc.shape[1]

    means = {k: sums[k] / max(counts[k], 1) for k in sums}

    sq = {"vel": np.zeros(dim), "acc": np.zeros(dim)}
    for pos in fluid():
        vel = _pbc_diff(pos, box, pbc)
        acc = vel[1:] - vel[:-1]
        sq["vel"] += ((vel - means["vel"]) ** 2).sum(axis=(0, 1))
        sq["acc"] += ((acc - means["acc"]) ** 2).sum(axis=(0, 1))

    stds = {k: np.sqrt(sq[k] / max(counts[k], 1)) for k in sq}
    return {
        "vel_mean": means["vel"].tolist(),
        "vel_std": stds["vel"].tolist(),
        "acc_mean": means["acc"].tolist(),
        "acc_std": stds["acc"].tolist(),
    }


class _H5Trajectories:
    """The (position, particle_type) pairs of ``.h5`` files, read anew on
    each iteration (trajectories in sorted key order, file by file)."""

    def __init__(self, file_paths: List[str]):
        self.file_paths = file_paths

    def __iter__(self):
        import h5py

        for path in self.file_paths:
            with h5py.File(path, "r") as f:
                for key in sorted(f.keys()):
                    yield f[f"{key}/position"][:], f[f"{key}/particle_type"][:]


def compute_statistics_h5(
    file_paths: List[str],
    box: Sequence[float],
    pbc: Sequence[bool],
    fluid_type: int = NodeType.FLUID,
) -> Dict[str, List[float]]:
    """:func:`compute_statistics` over every trajectory of ``file_paths``."""
    return compute_statistics(_H5Trajectories(file_paths), box, pbc, fluid_type)


def write_split(path: str, trajectories: List[Tuple[np.ndarray, np.ndarray]],
                **position_kw) -> None:
    """One split file: group ``{j:05d}`` per (positions, particle_type)."""
    import h5py

    with h5py.File(path, "w") as f:
        for j, (pos, ptype) in enumerate(trajectories):
            g = f.create_group(f"{j:05d}")
            g.create_dataset("particle_type", data=ptype)
            g.create_dataset("position", data=pos, **position_kw)


def consolidate_frames(
    trajectories: List[np.ndarray],
    particle_types: List[np.ndarray],
    out_dir: str,
    metadata: Dict,
    splits: Dict[str, float] = None,
) -> str:
    """Write trajectories into train/valid/test.h5 + metadata.json.

    Args:
        trajectories: list of (num_steps, N, dim) position arrays.
        particle_types: matching (N,) int arrays.
        out_dir: destination dataset directory.
        metadata: base metadata (bounds, dt, dx, radius...); statistics and
            bookkeeping fields are filled in here.
        splits: fraction per split, default {train: .8, valid: .1, test: .1}.
    """
    if len(trajectories) != len(particle_types) or not trajectories:
        raise ValueError("consolidate_frames needs trajectories, each with its types")
    splits = splits or {"train": 0.8, "valid": 0.1, "test": 0.1}
    os.makedirs(out_dir, exist_ok=True)

    n = len(trajectories)
    n_train = max(int(round(n * splits["train"])), 1)
    n_valid = max(int(round(n * splits["valid"])), 1) if n > 1 else 0
    assignment = (
        ["train"] * n_train
        + ["valid"] * n_valid
        + ["test"] * (n - n_train - n_valid)
    )[:n]
    # every split needs at least one trajectory when possible
    for want in ("valid", "test"):
        if n >= 3 and want not in assignment:
            assignment[-1 if want == "test" else -2] = want

    per_split: Dict[str, List[int]] = {"train": [], "valid": [], "test": []}
    for i, split in enumerate(assignment):
        per_split[split].append(i)
    # mirror train into empty eval splits for tiny datasets
    for want in ("valid", "test"):
        if not per_split[want]:
            per_split[want] = per_split["train"][:1]

    for split, idxs in per_split.items():
        write_split(os.path.join(out_dir, f"{split}.h5"),
                    [(trajectories[i], particle_types[i]) for i in idxs])

    bounds = np.asarray(metadata["bounds"], dtype=np.float64)
    box = bounds[:, 1] - bounds[:, 0]
    stats = compute_statistics_h5(
        [os.path.join(out_dir, "train.h5")],
        box,
        metadata["periodic_boundary_conditions"],
    )

    meta = dict(metadata)
    meta.update(stats)
    meta.setdefault("num_particles_max", max(t.shape[1] for t in trajectories))
    meta.setdefault("dim", int(bounds.shape[0]))
    meta["sequence_length_train"] = int(trajectories[per_split["train"][0]].shape[0])
    meta["num_trajs_train"] = len(per_split["train"])
    meta["sequence_length_test"] = int(trajectories[per_split["test"][0]].shape[0])
    meta["num_trajs_test"] = len(per_split["test"])

    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return out_dir
