"""Datasets, statistics and loading."""

from .dataset import (
    DAM2D,
    LDC2D,
    LDC3D,
    RPF2D,
    RPF3D,
    TGV2D,
    TGV3D,
    ArrayDataset,
    H5Dataset,
    TrajectoryDataset,
    get_dataset_name_from_path,
)
from .loader import DataLoader, cycle
from .stats import get_dataset_stats, numpy_collate

__all__ = [
    "ArrayDataset",
    "H5Dataset",
    "TrajectoryDataset",
    "TGV2D",
    "TGV3D",
    "RPF2D",
    "RPF3D",
    "LDC2D",
    "LDC3D",
    "DAM2D",
    "DataLoader",
    "cycle",
    "get_dataset_name_from_path",
    "get_dataset_stats",
    "numpy_collate",
]
