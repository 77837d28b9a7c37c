"""Trajectory datasets: the LagrangeBench HDF5 format, and in-memory arrays.

The on-disk format is the JAX package's: a directory with ``train.h5``,
``valid.h5`` and ``test.h5`` (groups ``"00000"``.. each holding
``position`` of shape (num_steps, num_particles, dim) and
``particle_type``), ``metadata.json``, and optionally ``force.py``.

Train mode yields sliding windows of shape
``(num_particles, input_seq_length + 1 + extra_seq_length, dim)``; eval
mode splits each trajectory into ``seq_len // subseq_length`` chunks.
Particles pad to ``num_particles_max`` with ``NodeType.PAD_VALUE`` types.

``ArrayDataset`` applies the same windowing to trajectories held in memory,
so a program can roll out synthetic or generated data without h5py, which
is imported only where HDF5 is read.

``H5Dataset`` downloads a published dataset from Zenodo (``URLS``) when its
directory is missing and its name is known; ``TGV2D`` .. ``DAM2D`` are
``H5Dataset`` bound to the seven datasets' short names and the JAX
package's default directories. A ``force.py`` runs without JAX
(:mod:`.force`).
"""

from __future__ import annotations

import bisect
import json
import os
import os.path as osp
import re
import warnings
import zipfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils import NodeType
from .force import load_force_fn

ZENODO_PREFIX = "https://zenodo.org/records/10491868/files/"
URLS = {
    "tgv2d": f"{ZENODO_PREFIX}2D_TGV_2500_10kevery100.zip",
    "rpf2d": f"{ZENODO_PREFIX}2D_RPF_3200_20kevery100.zip",
    "ldc2d": f"{ZENODO_PREFIX}2D_LDC_2708_10kevery100.zip",
    "dam2d": f"{ZENODO_PREFIX}2D_DAM_5740_20kevery100.zip",
    "tgv3d": f"{ZENODO_PREFIX}3D_TGV_8000_10kevery100.zip",
    "rpf3d": f"{ZENODO_PREFIX}3D_RPF_8000_10kevery100.zip",
    "ldc3d": f"{ZENODO_PREFIX}3D_LDC_8160_10kevery100.zip",
}


def get_dataset_name_from_path(path: str) -> str:
    """The dataset's short name from a directory named by the LagrangeBench
    convention (``3D_RPF_8000_10kevery100`` -> ``rpf3d``); the directory
    name, with a warning, for any other name."""
    dirname = osp.basename(osp.normpath(path))
    m = re.search(r"(?:2D|3D)_[A-Z]{3}", dirname)
    if m is not None:
        dims, case = m.group(0).split("_")
        return f"{case}{dims}".lower()
    warnings.warn(
        f"Dataset directory {dirname} does not follow the lagrangebench "
        "convention {2D|3D}_{TGV|RPF|LDC|DAM}; using the directory name."
    )
    return dirname


class TrajectoryDataset:
    """Windowing and padding over a set of equally long trajectories.

    Subclasses provide ``_read(traj_idx, start, stop)`` returning
    ``(positions (stop - start, N, dim), particle_type (N,))``.
    """

    def _setup(
        self,
        split: str,
        metadata: dict,
        num_trajs: int,
        sequence_length: int,
        input_seq_length: int,
        extra_seq_length: int,
        pad_to_max: bool,
    ) -> None:
        if split not in ("train", "valid", "test"):
            raise ValueError(f"unknown split {split!r}")
        if input_seq_length < 2:
            raise ValueError("input_seq_length must be >= 2 (one past velocity)")
        self.split = split
        self.metadata = metadata
        self.input_seq_length = input_seq_length
        self.pad_to_max = pad_to_max
        self.sequence_length = sequence_length
        self.num_trajs = num_trajs

        if split == "train":
            self.subseq_length = input_seq_length + 1 + extra_seq_length
            samples_per_traj = sequence_length - self.subseq_length + 1
            self._keylen_cumulative = list(
                np.cumsum([samples_per_traj] * num_trajs)
            )
            self.num_samples = int(samples_per_traj * num_trajs)
            self.getter = self.get_window
        else:
            if extra_seq_length <= 0:
                raise ValueError(
                    "extra_seq_length must be > 0 for validation and testing."
                )
            self.subseq_length = input_seq_length + extra_seq_length
            self._split_valid_traj_into_n = sequence_length // self.subseq_length
            self.num_samples = self._split_valid_traj_into_n * num_trajs
            self.getter = self.get_trajectory
        if sequence_length < self.subseq_length:
            raise ValueError(
                f"trajectory length ({sequence_length}) must be >= subsequence "
                f"length ({self.subseq_length})"
            )

    def _read(self, traj_idx: int, start: int, stop: int):
        raise NotImplementedError

    def _pad(self, pos: np.ndarray, ptype: np.ndarray):
        n_max = self.metadata["num_particles_max"]
        padding = n_max - pos.shape[0]
        if padding <= 0:
            return pos, ptype
        pos = np.pad(pos, ((0, padding), (0, 0), (0, 0)), constant_values=0.0)
        ptype = np.pad(ptype, (0, padding), constant_values=NodeType.PAD_VALUE)
        return pos, ptype

    def get_trajectory(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Eval sample: one subsequence chunk, shape (N, subseq_length, dim)."""
        if self._split_valid_traj_into_n > 1:
            traj_idx = idx // self._split_valid_traj_into_n
            start = (idx % self._split_valid_traj_into_n) * self.subseq_length
            stop = start + self.subseq_length
        else:
            traj_idx, start, stop = idx, 0, self.sequence_length
        pos, ptype = self._read(traj_idx, start, stop)
        pos = pos.transpose((1, 0, 2))
        if self.pad_to_max:
            pos, ptype = self._pad(pos, ptype)
        return pos, ptype

    def get_window(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Train sample: window of positions, shape (N, subseq_length, dim)."""
        traj_idx = bisect.bisect(self._keylen_cumulative, idx)
        el_idx = idx - (self._keylen_cumulative[traj_idx - 1] if traj_idx else 0)
        pos, ptype = self._read(traj_idx, el_idx, el_idx + self.subseq_length)
        pos = pos.transpose((1, 0, 2))
        if self.pad_to_max:
            pos, ptype = self._pad(pos, ptype)
        return pos, ptype

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.getter(idx)

    def __len__(self) -> int:
        return self.num_samples


class H5Dataset(TrajectoryDataset):
    """Lazily-windowed HDF5 trajectory dataset (LagrangeBench layout).

    Args:
        split: "train", "valid" or "test".
        dataset_path: directory holding ``<split>.h5`` + ``metadata.json``.
            Downloaded from Zenodo if missing and the name is in ``URLS``.
        name: dataset short name; inferred from the directory name if None
            (:func:`get_dataset_name_from_path`).
        input_seq_length: number of past positions the model sees.
        extra_seq_length: max pushforward unrolls (train) or eval horizon.
        pad_to_max: pad particles to metadata["num_particles_max"].
        nl_backend: accepted for the reference's API; unused.
    """

    def __init__(
        self,
        split: str,
        dataset_path: str,
        name: Optional[str] = None,
        input_seq_length: int = 6,
        extra_seq_length: int = 0,
        pad_to_max: bool = True,
        nl_backend: str = "celllist",
    ):
        import h5py

        self.dataset_path = osp.normpath(dataset_path)
        self.name = name if name is not None else get_dataset_name_from_path(self.dataset_path)
        if not osp.exists(self.dataset_path):
            self.dataset_path = self.download(self.name, self.dataset_path)
        self.nl_backend = nl_backend
        self.file_path = osp.join(self.dataset_path, split + ".h5")
        self.external_force_fn = _load_force_fn(self.dataset_path)
        with open(osp.join(self.dataset_path, "metadata.json"), "r") as f:
            metadata = json.loads(f.read())
        with h5py.File(self.file_path, "r") as f:
            self.traj_keys = sorted(f.keys())
            sequence_length = f[f"{self.traj_keys[0]}/position"].shape[0]
        self._file = None
        self._setup(
            split, metadata, len(self.traj_keys), sequence_length,
            input_seq_length, extra_seq_length, pad_to_max,
        )

    def download(self, name: str, path: str) -> str:
        """Download and unzip a published dataset from Zenodo into the
        parent of ``path``; returns ``path``."""
        if name not in URLS:
            raise ValueError(f"Dataset {name} not available for download.")
        import urllib.request

        url = URLS[name]
        path = path.rstrip("/")
        path_root = osp.split(path)[0] or "."
        os.makedirs(path_root, exist_ok=True)
        filename = osp.join(path_root, osp.basename(url))
        print(f"Downloading {url} -> {filename}")
        urllib.request.urlretrieve(url, filename)
        with zipfile.ZipFile(filename, "r") as z:
            z.extractall(path_root)
        os.remove(filename)
        return path

    def _read(self, traj_idx: int, start: int, stop: int):
        import h5py

        if self._file is None:
            self._file = h5py.File(self.file_path, "r")
        traj = self._file[self.traj_keys[traj_idx]]
        return traj["position"][start:stop], traj["particle_type"][:]

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class ArrayDataset(TrajectoryDataset):
    """The same windowing over trajectories held in memory.

    Args:
        split: "train", "valid" or "test".
        trajectories: list of (num_steps, N, dim) position arrays.
        particle_types: list of (N,) type arrays, one per trajectory.
        metadata: the dataset's metadata dict (as in ``metadata.json``).
        external_force_fn: the per-particle force of a forced case (a
            dataset's ``force_fn``), or None.
    """

    def __init__(
        self,
        split: str,
        trajectories: List[np.ndarray],
        particle_types: List[np.ndarray],
        metadata: Dict,
        input_seq_length: int = 6,
        extra_seq_length: int = 0,
        pad_to_max: bool = True,
        external_force_fn: Optional[Callable] = None,
    ):
        lengths = {t.shape[0] for t in trajectories}
        if len(lengths) != 1 or len(trajectories) != len(particle_types):
            raise ValueError("trajectories must share one length and have types")
        self.name = str(metadata.get("case", "arrays"))
        self.external_force_fn = external_force_fn
        self._trajs = trajectories
        self._types = particle_types
        self._setup(
            split, metadata, len(trajectories), lengths.pop(),
            input_seq_length, extra_seq_length, pad_to_max,
        )

    def _read(self, traj_idx: int, start: int, stop: int):
        return self._trajs[traj_idx][start:stop], self._types[traj_idx]


def _load_force_fn(dataset_path: str):
    """The dataset's external force function from ``force.py``, if any, run
    without JAX (:func:`.force.load_force_fn`)."""
    path = osp.join(dataset_path, "force.py")
    return load_force_fn(path) if osp.exists(path) else None


def _named(name: str, default_dir: str):
    """An ``H5Dataset`` subclass bound to a dataset's short name and default
    directory."""

    class _Named(H5Dataset):
        def __init__(
            self,
            split: str,
            dataset_path: str = default_dir,
            input_seq_length: int = 6,
            extra_seq_length: int = 0,
            pad_to_max: bool = True,
            nl_backend: str = "celllist",
        ):
            super().__init__(split, dataset_path, name=name, input_seq_length=input_seq_length,
                             extra_seq_length=extra_seq_length, pad_to_max=pad_to_max,
                             nl_backend=nl_backend)

    _Named.__name__ = _Named.__qualname__ = name.upper()
    return _Named


# the JAX package's default directories, as written there: LDC2D's and
# DAM2D's differ from the directories their archives unpack to
TGV2D = _named("tgv2d", "datasets/2D_TGV_2500_10kevery100")
TGV3D = _named("tgv3d", "datasets/3D_TGV_8000_10kevery100")
RPF2D = _named("rpf2d", "datasets/2D_RPF_3200_20kevery100")
RPF3D = _named("rpf3d", "datasets/3D_RPF_8000_10kevery100")
LDC2D = _named("ldc2d", "datasets/2D_LDC_2500_10kevery100")
LDC3D = _named("ldc3d", "datasets/3D_LDC_8160_10kevery100")
DAM2D = _named("dam2d", "datasets/2D_DB_5740_20kevery100")

TGV2D.__doc__ = "Taylor-Green Vortex 2D dataset (2.5K particles)."
TGV3D.__doc__ = "Taylor-Green Vortex 3D dataset (8K particles)."
RPF2D.__doc__ = "Reverse Poiseuille Flow 2D dataset (3.2K particles)."
RPF3D.__doc__ = "Reverse Poiseuille Flow 3D dataset (8K particles)."
LDC2D.__doc__ = "Lid-Driven Cavity 2D dataset (2.5K particles)."
LDC3D.__doc__ = "Lid-Driven Cavity 3D dataset (8.2K particles)."
DAM2D.__doc__ = "Dam break 2D dataset (5.7K particles)."
