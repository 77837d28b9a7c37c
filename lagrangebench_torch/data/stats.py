"""Dataset normalization statistics.

The GNS training-noise std is folded into the normalization stds as
``std' = sqrt(std^2 + noise_std^2)``; isotropic normalization averages the
means and RMS-averages the stds across dimensions.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def get_dataset_stats(
    metadata: Dict[str, List[float]],
    is_isotropic_norm: bool,
    noise_std: float,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Velocity/acceleration normalization stats (float64 numpy arrays)."""
    acc_mean = np.asarray(metadata["acc_mean"], dtype=np.float64)
    acc_std = np.asarray(metadata["acc_std"], dtype=np.float64)
    vel_mean = np.asarray(metadata["vel_mean"], dtype=np.float64)
    vel_std = np.asarray(metadata["vel_std"], dtype=np.float64)

    if is_isotropic_norm:
        acc_mean = np.full_like(acc_mean, np.mean(acc_mean))
        acc_std = np.full_like(acc_std, np.sqrt(np.mean(acc_std**2)))
        vel_mean = np.full_like(vel_mean, np.mean(vel_mean))
        vel_std = np.full_like(vel_std, np.sqrt(np.mean(vel_std**2)))

    return {
        "acceleration": {
            "mean": acc_mean,
            "std": np.sqrt(acc_std**2 + noise_std**2),
        },
        "velocity": {
            "mean": vel_mean,
            "std": np.sqrt(vel_std**2 + noise_std**2),
        },
    }


def numpy_collate(batch):
    """Stack a list of samples (possibly nested tuples) into numpy arrays."""
    if isinstance(batch[0], np.ndarray):
        return np.stack(batch)
    if isinstance(batch[0], (tuple, list)):
        return type(batch[0])(numpy_collate(samples) for samples in zip(*batch))
    return np.asarray(batch)
