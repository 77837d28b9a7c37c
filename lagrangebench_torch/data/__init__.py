"""Datasets, statistics and loading."""

from .dataset import ArrayDataset, H5Dataset, TrajectoryDataset, get_dataset_name_from_path
from .loader import DataLoader, cycle
from .stats import get_dataset_stats, numpy_collate

__all__ = [
    "ArrayDataset",
    "H5Dataset",
    "TrajectoryDataset",
    "DataLoader",
    "cycle",
    "get_dataset_name_from_path",
    "get_dataset_stats",
    "numpy_collate",
]
