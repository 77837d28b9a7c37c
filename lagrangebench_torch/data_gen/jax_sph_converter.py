"""Per-frame jax-sph h5 directories -> LagrangeBench dataset splits.

Counterpart of ``lagrangebench_tpu/data_gen/jax_sph_converter.py`` (the
reference's ``data_gen/lagrangebench_data/gen_dataset.py``). A source
directory holds one sub-directory per trajectory (ordered by the seed field
of its name), each containing per-frame ``*_NNN.h5`` files with ``r``
(positions) and ``tag`` (particle types) datasets plus a ``config.yaml``.
The converter

* subsamples frames (``--skip_first_n_frames``, ``--slice_every_nth_frame``);
* trims the outer wall layers of lid-driven-cavity ("ldc" in the source
  path) and dam-break ("db") cases, which jax-sph pads beyond the domain;
* splits trajectories into train/valid/test by a ratio string like
  "80_10_10", or time-splits a single long trajectory;
* writes ``{split}.h5`` + ``metadata.json`` with the ``1.45 * dx``-rounded
  connectivity radius and two-pass PBC-aware velocity / acceleration
  statistics over fluid particles.

The split and metadata logic is :func:`split_trajectories`, a function on
trajectories in memory and the trajectory's ``config`` dict, so that a
dataset generated in memory (no h5py) is built by the same code;
:func:`convert_jax_sph_dir` reads the frames and writes the files around it.

Usage:
    python -m lagrangebench_torch.data_gen.jax_sph_converter \\
        --src_dir sims/2D_LDC --dst_dir datasets/ldc2d --split 80_10_10
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .h5_tools import compute_statistics, write_split

# domain extents used by the reference's wall-trimming masks
_TRIM_DOMAINS = {"ldc": (1.0, 1.0), "db": (5.366, 2.0)}
WALL_TAG = 1  # SOLID_WALL
SPLITS = ("train", "valid", "test")


def trim_outer_walls(
    r: np.ndarray, tag: np.ndarray, dx: float, domain: Tuple[float, float]
) -> np.ndarray:
    """Boolean keep-mask dropping jax-sph's outer wall padding layers.

    Keeps everything except: particles below ``2 dx`` (bottom pad), above
    ``H + 4 dx`` (lid pad), and WALL particles left of ``2 dx`` or right of
    ``L + 4 dx``.
    """
    length, height = domain
    keep = r[:, 1] >= 2 * dx
    keep &= r[:, 1] <= height + 4 * dx
    keep &= ~((r[:, 0] < 2 * dx) & (tag == WALL_TAG))
    keep &= ~((r[:, 0] > length + 4 * dx) & (tag == WALL_TAG))
    return keep


def _read_frame(path: str) -> Tuple[np.ndarray, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f["r"]), np.asarray(f["tag"])


def _frame_files(traj_dir: str, skip: int, every: int) -> List[str]:
    files = [f for f in os.listdir(traj_dir) if f.endswith(".h5")]
    files = sorted(files, key=lambda x: int(x.rsplit("_", 1)[1][:-3]))
    return [os.path.join(traj_dir, f) for f in files[skip::every]]


def _load_config(traj_dir: str) -> Dict:
    path = os.path.join(traj_dir, "config.yaml")
    if not os.path.exists(path):
        return {}
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def _read_trajectory(
    traj_dir: str, skip: int, every: int, trim_key: Optional[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack a trajectory's frames; apply wall trimming if requested."""
    cfg = _load_config(traj_dir)
    frames = []
    tag = None
    keep = None
    for path in _frame_files(traj_dir, skip, every):
        r, t = _read_frame(path)
        if trim_key is not None:
            if keep is None:  # walls are static: mask from the first frame
                dx = float(cfg.get("case", {}).get("dx", 0.02))
                keep = trim_outer_walls(r, t, dx, _TRIM_DOMAINS[trim_key])
            r, t = r[keep], t[keep]
        frames.append(r)
        tag = t
    if not frames:
        raise ValueError(f"no .h5 frames under {traj_dir}")
    return np.stack(frames).astype(np.float32), np.asarray(tag)


def connectivity_radius(dx: float) -> float:
    """The reference's radius heuristic: 1.45 dx rounded to 2 significant
    digits."""
    return float(
        np.format_float_positional(
            1.45 * dx, precision=2, unique=False, fractional=False, trim="k"
        )
    )


def split_trajectories(
    trajectories: List[Tuple[np.ndarray, np.ndarray]],
    config: Dict,
    split: str = "80_10_10",
    name: str = "SPH",
) -> Tuple[Dict[str, List[Tuple[np.ndarray, np.ndarray]]], Dict]:
    """Splits and metadata of trajectories held in memory.

    Args:
        trajectories: (positions (T, N, dim), tag (N,)) per trajectory, in
            seed order; positions are stored as float32.
        config: the jax-sph ``config.yaml`` dict of the last trajectory
            (``case``: name, dx, dim, bounds, pbc, viscosity; ``solver``:
            name, dt; ``io``: write_every); missing fields take the JAX
            package's defaults.
        split: ratio string ``"train_valid_test"``. One trajectory is
            time-split into three contiguous chunks; several are assigned
            whole, the last ``ceil(valid/total * n)`` to test and as many
            before them to valid.
        name: the case name when ``config`` has none.

    Returns ``(per_split, metadata)``: ``per_split[s]`` the (positions,
    tag) pairs of split ``s``; ``metadata`` the dict of ``metadata.json``,
    with the statistics over all three splits (a degenerate std of an axis,
    below 1e-7, becomes 1).
    """
    if not trajectories:
        raise ValueError("no trajectories to split")
    trajectories = [(np.asarray(p, np.float32), np.asarray(t)) for p, t in trajectories]
    ratios = np.array([int(s) for s in split.split("_")], dtype=np.float64)

    if len(trajectories) == 1:
        # time-split one long trajectory into three contiguous chunks
        pos, tag = trajectories[0]
        n_frames = pos.shape[0]
        num_eval = int(np.ceil(ratios[1] / ratios.sum() * n_frames))
        cuts = np.cumsum([0, n_frames - 2 * num_eval, num_eval, num_eval])
        per_split = {s: [(pos[cuts[i]: cuts[i + 1]], tag)] for i, s in enumerate(SPLITS)}
        seq_train, seq_test = int(cuts[1] - 1), int(num_eval - 1)
        n_train = n_test = 1
    else:
        n = len(trajectories)
        num_eval = int(np.ceil(ratios[1] / ratios.sum() * n))
        cuts = np.cumsum([0, n - 2 * num_eval, num_eval, num_eval])
        per_split = {s: trajectories[cuts[i]: cuts[i + 1]] for i, s in enumerate(SPLITS)}
        # per-split sequence lengths (test trajectories may be longer,
        # e.g. for long-horizon rollout evaluation)
        seq_train = min(p.shape[0] for p, _ in per_split["train"]) - 1
        seq_test = min(p.shape[0] for p, _ in per_split["test"]) - 1
        n_train, n_test = n - 2 * num_eval, num_eval

    case = config.get("case", {})
    solver = config.get("solver", {})
    dx = float(case.get("dx", 0.02))
    bounds = case.get("bounds")
    if bounds is None:
        all_pos = np.concatenate([p.reshape(-1, p.shape[-1]) for p, _ in per_split["train"]])
        bounds = np.stack([all_pos.min(0), all_pos.max(0)], axis=1).tolist()
    pbc = list(case.get("pbc", [False] * len(bounds)))

    metadata = {
        "case": str(case.get("name", name)).upper(),
        "solver": solver.get("name", "SPH"),
        "dim": int(case.get("dim", len(bounds))),
        "dx": dx,
        "dt": float(solver.get("dt", 1e-3)),
        "t_end": solver.get("t_end"),
        "viscosity": case.get("viscosity"),
        "write_every": int(config.get("io", {}).get("write_every", 1)),
        "sequence_length_train": int(seq_train),
        "num_trajs_train": int(n_train),
        "sequence_length_test": int(seq_test),
        "num_trajs_test": int(n_test),
        "num_particles_max": int(
            max(p.shape[1] for trajs in per_split.values() for p, _ in trajs)
        ),
        "periodic_boundary_conditions": [bool(p) for p in pbc],
        "bounds": np.asarray(bounds, dtype=np.float64).tolist(),
        "default_connectivity_radius": connectivity_radius(dx),
    }

    box = np.asarray(metadata["bounds"], np.float64)
    stats = compute_statistics(
        [traj for s in SPLITS for traj in per_split[s]],
        box[:, 1] - box[:, 0],
        metadata["periodic_boundary_conditions"],
    )
    # guard against degenerate axes (reference gen_dataset.py:255-257)
    for key in ("vel_std", "acc_std"):
        stats[key] = [v if v >= 1e-7 else 1.0 for v in stats[key]]
    metadata.update(stats)
    return per_split, metadata


def convert_jax_sph_dir(
    src_dir: str,
    dst_dir: str,
    split: str = "80_10_10",
    skip_first_n_frames: int = 0,
    slice_every_nth_frame: int = 1,
    trim: Optional[bool] = None,
) -> str:
    """Convert a jax-sph output directory into a LagrangeBench dataset.

    ``trim`` controls the jax-sph outer-wall-padding trim: None (default)
    auto-detects "ldc"/"db" in the source path like the reference;
    False disables it (the WCSPH generator places no padding outside the
    domain, so its LDC/DAM output must NOT be trimmed).
    """
    os.makedirs(dst_dir, exist_ok=True)
    trim_key = None
    if trim is not False:
        trim_key = next(
            (k for k in _TRIM_DOMAINS if k in os.path.basename(src_dir).lower()
             or k in src_dir.lower()),
            None,
        )

    dirs = [d for d in os.listdir(src_dir) if os.path.isdir(os.path.join(src_dir, d))]

    def seed_of(name: str) -> int:
        parts = name.split("_")
        try:
            return int(parts[3])
        except (IndexError, ValueError):
            return 0

    dirs = sorted(dirs, key=seed_of)
    if not dirs:
        raise ValueError(f"no trajectory directories under {src_dir}")

    trajectories = [
        _read_trajectory(os.path.join(src_dir, d), skip_first_n_frames,
                         slice_every_nth_frame, trim_key)
        for d in dirs
    ]
    config = _load_config(os.path.join(src_dir, dirs[-1]))
    per_split, metadata = split_trajectories(trajectories, config, split,
                                             name=os.path.basename(src_dir))

    for s, trajs in per_split.items():
        write_split(os.path.join(dst_dir, f"{s}.h5"), trajs, dtype=np.float32,
                    compression="gzip")
        print(f"wrote {s}.h5 with {len(trajs)} trajectories")

    with open(os.path.join(dst_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    return dst_dir


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src_dir", type=str, required=True)
    parser.add_argument("--dst_dir", type=str, required=True)
    parser.add_argument("--split", type=str, default="80_10_10")
    parser.add_argument("--skip_first_n_frames", type=int, default=0)
    parser.add_argument("--slice_every_nth_frame", type=int, default=1)
    parser.add_argument("--no_trim", action="store_true",
                        help="disable the jax-sph outer-wall trim heuristic")
    args = parser.parse_args()
    convert_jax_sph_dir(
        args.src_dir, args.dst_dir, args.split,
        args.skip_first_n_frames, args.slice_every_nth_frame,
        trim=False if args.no_trim else None,
    )


if __name__ == "__main__":
    main()
