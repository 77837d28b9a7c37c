"""Evaluation: rollouts and metrics."""

from .metrics import MetricsComputer, MetricsDict, averaged_metrics
from .rollout import eval_rollout, infer, rollout_batch

__all__ = [
    "MetricsComputer",
    "MetricsDict",
    "averaged_metrics",
    "eval_rollout",
    "infer",
    "rollout_batch",
]
