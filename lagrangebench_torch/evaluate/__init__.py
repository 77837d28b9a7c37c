"""Evaluation: rollouts, metrics and VTK export."""

from .metrics import MetricsComputer, MetricsDict, averaged_metrics
from .rollout import RolloutOverflowError, eval_rollout, infer, rollout_batch
from .utils import pkl2vtk, write_vtk

__all__ = [
    "MetricsComputer",
    "MetricsDict",
    "RolloutOverflowError",
    "averaged_metrics",
    "eval_rollout",
    "infer",
    "rollout_batch",
    "pkl2vtk",
    "write_vtk",
]
