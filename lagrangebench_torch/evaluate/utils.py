"""Rollout export: legacy-VTK point clouds, numpy only.

Counterpart of ``lagrangebench_tpu/evaluate/utils.py``: a legacy-VTK ASCII
writer (a point cloud with vertex cells and point data such as the integer
"tag"), readable by ParaView and meshio, and a converter of pickled rollouts
to per-frame files. 2D data is zero-padded to 3D.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def write_vtk(data_dict: dict, path: str) -> None:
    """Write one frame to a legacy VTK PolyData file.

    Args:
        data_dict: {"r": (N, dim) positions, "tag": (N,) ints, plus optional
            extra (N,) or (N, dim) point-data arrays}.
        path: output file path (.vtk).
    """
    r = np.asarray(data_dict["r"], dtype=np.float64)
    n, dim = r.shape
    if dim == 2:
        r = np.concatenate([r, np.zeros((n, 1))], axis=1)

    lines = [
        "# vtk DataFile Version 3.0",
        "lagrangebench rollout frame",
        "ASCII",
        "DATASET POLYDATA",
        f"POINTS {n} float",
    ]
    lines += [" ".join(f"{x:.8g}" for x in row) for row in r]
    lines.append(f"VERTICES {n} {2 * n}")
    lines += [f"1 {i}" for i in range(n)]
    lines.append(f"POINT_DATA {n}")

    for key, val in data_dict.items():
        if key == "r":
            continue
        arr = np.asarray(val)
        if arr.ndim == 1:
            if np.issubdtype(arr.dtype, np.integer):
                lines.append(f"SCALARS {key} int 1")
            else:
                lines.append(f"SCALARS {key} float 1")
            lines.append("LOOKUP_TABLE default")
            lines += [str(x) for x in arr.tolist()]
        elif arr.ndim == 2:
            if arr.shape[1] == 2:
                arr = np.concatenate([arr, np.zeros((arr.shape[0], 1))], axis=1)
            lines.append(f"VECTORS {key} float")
            lines += [" ".join(f"{x:.8g}" for x in row) for row in arr]

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def pkl2vtk(src_path: str, dst_path: str = None) -> None:
    """Convert a pickled rollout dict into per-frame .vtk files.

    Produces ``<dst>_<i>.vtk`` (predictions) and ``<dst>_ref_<i>.vtk``
    (ground truth), matching the reference converter's layout.
    """
    if dst_path is None:
        dst_path = os.path.splitext(src_path)[0] + "_vtk"
    os.makedirs(dst_path, exist_ok=True)

    with open(src_path, "rb") as f:
        rollout = pickle.load(f)

    file_prefix = os.path.join(dst_path, os.path.basename(src_path).split(".")[0])
    tag = np.asarray(rollout["particle_type"])
    for k, frame in enumerate(np.asarray(rollout["predicted_rollout"])):
        write_vtk({"r": frame, "tag": tag}, f"{file_prefix}_{k}.vtk")
    for k, frame in enumerate(np.asarray(rollout["ground_truth_rollout"])):
        write_vtk({"r": frame, "tag": tag}, f"{file_prefix}_ref_{k}.vtk")
