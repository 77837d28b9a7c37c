"""Rollout metrics: MSE / MAE / kinetic energy / Sinkhorn divergence.

The JAX package's metric semantics: per-step MSE/MAE under the
boundary-aware displacement (with ``mse{h}`` prefixes for short
horizons), a kinetic-energy proxy, and the debiased Sinkhorn divergence
S(a,b) = OT(a,b) - (OT(a,a) + OT(b,b)) / 2, each OT term from log-domain
Sinkhorn potentials with epsilon 5% of the mean XY cost, run until the
row-marginal error is below the threshold (checked every 10 iterations,
at most 500).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

MetricsDict = Dict[str, torch.Tensor]


def _sinkhorn_potentials(cost, log_a, log_b, epsilon, threshold: float = 1e-4,
                         max_iterations: int = 500, inner_iterations: int = 10):
    """Log-domain Sinkhorn; returns the dual potentials (f, g)."""
    f = torch.zeros(cost.shape[0], dtype=cost.dtype, device=cost.device)
    g = torch.zeros(cost.shape[1], dtype=cost.dtype, device=cost.device)
    it = 0
    while it < max_iterations:
        for _ in range(inner_iterations):
            f = -epsilon * torch.logsumexp((g[None, :] - cost) / epsilon + log_b[None, :], dim=1)
            g = -epsilon * torch.logsumexp((f[:, None] - cost) / epsilon + log_a[:, None], dim=0)
        it += inner_iterations
        log_p_row = torch.logsumexp(
            (f[:, None] + g[None, :] - cost) / epsilon + log_b[None, :], dim=1
        )
        err = torch.max(torch.abs(torch.exp(log_p_row + log_a) - torch.exp(log_a)))
        if not bool(err > threshold):
            break
    return f, g


def _reg_ot_cost(cost, a, b, epsilon, threshold: float = 1e-4):
    """Entropy-regularized OT cost from the dual objective <f,a> + <g,b>."""
    f, g = _sinkhorn_potentials(cost, torch.log(a), torch.log(b), epsilon, threshold)
    return torch.sum(f * a) + torch.sum(g * b)


class MetricsComputer:
    """Metrics between a predicted and a target rollout, both (T, N, dim).

    Args:
        active_metrics: subset of ["mse", "mae", "sinkhorn", "e_kin"].
        dist_fn: boundary-aware displacement function.
        metadata: dataset metadata (dt, dx, dim, write_every).
        input_seq_length: model input window length.
        stride: temporal subsampling for e_kin and sinkhorn.
        loss_ranges: horizons for short-range losses.
    """

    METRICS = ["mse", "mae", "sinkhorn", "e_kin"]

    def __init__(
        self,
        active_metrics: List[str],
        dist_fn: Callable,
        metadata: Dict,
        input_seq_length: int = 6,
        stride: int = 10,
        loss_ranges: Optional[List[int]] = None,
        sinkhorn_epsilon: Optional[float] = None,
        sinkhorn_threshold: float = 1e-4,
    ):
        active_metrics = list(active_metrics or [])
        unknown = set(active_metrics) - set(self.METRICS)
        if unknown:
            raise ValueError(f"unknown metrics {sorted(unknown)}")
        self._active = active_metrics
        self._dist_fn = dist_fn
        self._loss_ranges = loss_ranges or [1, 5, 10, 20, 50, 100]
        self._input_seq_length = input_seq_length
        self._stride = stride
        self._metadata = metadata
        self._sinkhorn_epsilon = sinkhorn_epsilon
        self._sinkhorn_threshold = sinkhorn_threshold

    def _per_step(self, pred, target, name):
        d = self._dist_fn(pred, target)
        v = d**2 if name == "mse" else torch.abs(d)
        return v.mean(dim=(1, 2))

    def _cost_matrix(self, x, y):
        """Pairwise squared distances under the boundary-aware metric."""
        return torch.sum(self._dist_fn(x[:, None, :], y[None, :, :]) ** 2, dim=-1)

    def sinkhorn(self, pred, target):
        """Debiased Sinkhorn divergence between two particle distributions."""
        cost_xy = self._cost_matrix(pred, target)
        cost_xx = self._cost_matrix(pred, pred)
        cost_yy = self._cost_matrix(target, target)
        if self._sinkhorn_epsilon is None:
            epsilon = 0.05 * torch.mean(cost_xy)
        else:
            epsilon = torch.as_tensor(self._sinkhorn_epsilon, dtype=cost_xy.dtype)
        a = torch.full((pred.shape[0],), 1.0 / pred.shape[0], dtype=pred.dtype,
                       device=pred.device)
        b = torch.full((target.shape[0],), 1.0 / target.shape[0], dtype=target.dtype,
                       device=target.device)
        thr = self._sinkhorn_threshold
        ot_xy = _reg_ot_cost(cost_xy, a, b, epsilon, thr)
        ot_xx = _reg_ot_cost(cost_xx, a, a, epsilon, thr)
        ot_yy = _reg_ot_cost(cost_yy, b, b, epsilon, thr)
        return ot_xy - 0.5 * (ot_xx + ot_yy)

    def __call__(self, pred_rollout: torch.Tensor, target_rollout: torch.Tensor) -> MetricsDict:
        target_rollout = torch.as_tensor(target_rollout).to(pred_rollout)
        metrics: MetricsDict = {}
        for name in self._active:
            if name in ("mse", "mae"):
                per_step = self._per_step(pred_rollout, target_rollout, name)
                metrics[name] = per_step
                for h in self._loss_ranges:
                    if h < per_step.shape[0]:
                        metrics[f"{name}{h}"] = per_step[:h]
            elif name == "e_kin":
                dt = self._metadata["dt"] * self._metadata["write_every"]
                dx = self._metadata["dx"]
                dim = self._metadata["dim"]
                s = self._stride

                def ekin_of(rollout):
                    vel = self._dist_fn(rollout[1::s], rollout[0:-1:s])
                    return torch.sum((vel / dt) ** 2, dim=(1, 2)) * dx**dim

                e_pred, e_target = ekin_of(pred_rollout), ekin_of(target_rollout)
                metrics[name] = {
                    "predicted": e_pred,
                    "target": e_target,
                    "mse": ((e_pred - e_target) ** 2).mean(),
                }
            elif name == "sinkhorn":
                s = self._stride
                metrics[name] = torch.stack(
                    [
                        self.sinkhorn(p, t)
                        for p, t in zip(pred_rollout[0::s], target_rollout[0::s])
                    ]
                )
        return metrics


def averaged_metrics(eval_metrics: Dict[str, Dict]) -> Dict[str, float]:
    """Average metrics across rollouts into val/<metric> and val/std<metric>
    (mse/mae report as "loss"; e_kin contributes its mse)."""
    per_traj = defaultdict(list)
    for rollout in eval_metrics.values():
        for k, v in rollout.items():
            if k == "e_kin":
                v = v["mse"]
            if k in ("mse", "mae"):
                k = "loss"
            per_traj[k].append(float(np.mean(np.asarray(v))))
    small = {f"val/{k}": float(np.mean(v)) for k, v in per_traj.items()}
    small.update({f"val/std{k}": float(np.std(v)) for k, v in per_traj.items()})
    return small
