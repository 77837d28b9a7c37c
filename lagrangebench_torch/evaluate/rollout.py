"""Autoregressive rollouts and inference.

Counterpart of ``lagrangebench_tpu/evaluate/rollout.py`` (single device).
A trajectory batch of B samples rolls out as one flat (B*N)-particle
super-graph per step, in a Python loop: neighbor update (K1, then K2, or K9
with ``emit_geometry``), features, the model (ten K3 launches for GNS-10),
integration, then kinematic particles are reset to the ground truth and the
input window shifts. The slot layout rolls out one sample at a time (B = 1:
K1, K7, then ten K8 launches); its list, with the geometry and maps in
``aux``, goes through ``broadcast``/``select`` like a dense one.

The neighbor-overflow flag stays on the device through the loop and is
read once per batch; on overflow the batch is rerun with the capacities of
a fresh allocation escalated by x1.5, at most 5 times. Positions are
carried in the dtype of the loaded trajectories (float64 from the HDF5
files), the features in the case's dtype.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, Iterable, Optional, Union

import numpy as np
import torch

from ..config import Config, merge
from ..data import DataLoader
from ..defaults import defaults
from ..ops.batching import unflatten_nodes
from ..utils import get_kinematic_mask, resolve_device
from .metrics import MetricsComputer
from .utils import write_vtk


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


@torch.no_grad()
def rollout_batch(model, case, current, particle_type, neighbors, targets):
    """Roll a batch forward through ``targets.shape[2]`` steps.

    Args:
        current: (B, N, t_window, dim) input windows.
        particle_type: (B, N).
        neighbors: batched NeighborList.
        targets: (B, N, T, dim) ground truth (drives kinematic particles).

    Returns (predictions (B, T, N, dim), overflow (device bool), neighbors).
    """
    b, n = particle_type.shape
    kinematic = get_kinematic_mask(particle_type)[..., None]
    flat_ptype = particle_type.reshape(b * n)
    overflow = torch.zeros((), dtype=torch.bool, device=current.device)
    preds = []
    for t in range(targets.shape[2]):
        features, neighbors = case.preprocess_eval_batched(
            (current, particle_type), neighbors
        )
        overflow = overflow | neighbors.did_buffer_overflow.any()
        out = model(features, flat_ptype)
        pred = {k: unflatten_nodes(v, b, n) for k, v in out.items()}
        next_pos = case.integrate(pred, current)
        next_pos = torch.where(kinematic, targets[:, :, t], next_pos)
        current = torch.cat([current[:, :, 1:], next_pos[:, :, None]], dim=2)
        preds.append(next_pos)
    return torch.stack(preds, dim=1), overflow, neighbors


def _eval_batched_rollout(model, case, traj_batch, neighbors, metrics_computer,
                          n_rollout_steps: int, t_window: int,
                          n_extrap_steps: int = 0, max_retries: int = 5):
    """One trajectory batch with overflow-escalation retries."""
    pos_input, particle_type = traj_batch
    batch_size = pos_input.shape[0]
    if n_rollout_steps == -1:
        n_rollout_steps = pos_input.shape[2] - t_window
    traj_len = n_rollout_steps + n_extrap_steps

    current = pos_input[:, :, :t_window]
    targets = pos_input[:, :, t_window : t_window + traj_len]
    if targets.shape[2] < traj_len:
        # past the ground truth kinematic particles freeze at the last frame
        pad = targets[:, :, -1:].expand(-1, -1, traj_len - targets.shape[2], -1)
        targets = torch.cat([targets, pad], dim=2)

    neighbors_batch = neighbors.broadcast(batch_size)
    boost = 1.0
    for _ in range(max_retries):
        predictions, overflow, neighbors_batch = rollout_batch(
            model, case, current, particle_type, neighbors_batch, targets
        )
        if not bool(overflow):
            break
        boost *= 1.5
        print(f"(eval) neighbor overflow; reallocating with boost {boost:.2f}")
        _, nbrs = case.allocate_eval((current[0], particle_type[0]), capacity_boost=boost)
        neighbors_batch = nbrs.broadcast(batch_size)
    else:
        raise RuntimeError("neighbor list kept overflowing during rollout")

    target_tm = targets.permute(0, 2, 1, 3)[:, :n_rollout_steps]
    metrics = [
        metrics_computer(predictions[j, :n_rollout_steps], target_tm[j])
        for j in range(batch_size)
    ]
    return predictions, metrics, neighbors_batch.select(0)


def eval_rollout(
    model,
    case,
    loader_eval: Iterable,
    neighbors,
    metrics_computer: MetricsComputer,
    n_rollout_steps: int,
    n_trajs: int,
    rollout_dir: Optional[str] = None,
    out_type: str = "none",
    n_extrap_steps: int = 0,
) -> Dict[str, Dict]:
    """Evaluate rollouts over a loader; returns metrics (numpy) per trajectory.

    With ``rollout_dir``, ``out_type="pkl"`` pickles each rollout as
    ``rollout_<i>.pkl``, ``out_type="vtk"`` writes its frames as
    ``rollout_<i>_<t>.vtk`` (predicted) and ``rollout_<i>_ref_<t>.vtk``
    (ground truth); the metrics go to ``metrics<timestamp>.pkl``.
    """
    if out_type not in ("none", "pkl", "vtk"):
        raise ValueError(f"unknown rollout output {out_type!r}")
    batch_size = loader_eval.batch_size
    t_window = loader_eval.dataset.input_seq_length
    eval_metrics: Dict[str, Dict] = {}
    if rollout_dir is not None:
        os.makedirs(rollout_dir, exist_ok=True)

    for i, (pos_np, ptype_np) in enumerate(loader_eval):
        n_traj_left = n_trajs - i * batch_size
        if n_traj_left <= 0:
            break
        pos_np, ptype_np = pos_np[:n_traj_left], ptype_np[:n_traj_left]
        traj_batch = (
            torch.as_tensor(pos_np, device=case.device),
            torch.as_tensor(ptype_np, device=case.device),
        )
        predictions, metrics, neighbors = _eval_batched_rollout(
            model, case, traj_batch, neighbors, metrics_computer,
            n_rollout_steps=n_rollout_steps, t_window=t_window,
            n_extrap_steps=n_extrap_steps,
        )
        for j, m in enumerate(metrics):
            eval_metrics[f"rollout_{i * batch_size + j}"] = _to_numpy(m)

        if rollout_dir is not None and out_type != "none":
            preds = predictions.cpu().numpy()
            for j in range(pos_np.shape[0]):
                truth = pos_np[j].transpose(1, 0, 2)  # (T, N, dim)
                example = {
                    "predicted_rollout": np.concatenate([truth[:t_window], preds[j]]),
                    "ground_truth_rollout": truth,
                    "particle_type": ptype_np[j],
                }
                prefix = os.path.join(rollout_dir, f"rollout_{i * batch_size + j}")
                if out_type == "vtk":
                    for name, frames in (("", example["predicted_rollout"]), ("ref_", truth)):
                        for k, frame in enumerate(frames):
                            write_vtk({"r": frame, "tag": ptype_np[j]}, f"{prefix}_{name}{k}.vtk")
                else:
                    with open(f"{prefix}.pkl", "wb") as f:
                        pickle.dump(example, f)

    if rollout_dir is not None:
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S", time.localtime())
        with open(os.path.join(rollout_dir, f"metrics{stamp}.pkl"), "wb") as f:
            pickle.dump(eval_metrics, f)
    return eval_metrics


def infer(
    model,
    case,
    data_test,
    load_ckp: Optional[str] = None,
    cfg_eval_infer: Union[Dict, Config, None] = None,
    rollout_dir: Optional[str] = None,
    n_rollout_steps: int = defaults.eval.n_rollout_steps,
    seed: int = defaults.seed,
    device="cuda",
) -> Dict[str, Dict]:
    """Run inference over a test dataset and compute metrics.

    Args:
        model: the model module (e.g. ``models.GNS``), on ``device``.
        case: a ``case_builder`` case on ``device``.
        data_test: an eval-split dataset (``H5Dataset`` or ``ArrayDataset``).
        load_ckp: checkpoint directory whose ``params.npz`` (JAX tree layout)
            is loaded into ``model`` first.
        cfg_eval_infer: overrides of ``defaults.eval.infer``.
        device: "cuda" (default) or "cpu"; raises without CUDA unless "cpu".
    """
    from ..checkpoint import load_checkpoint

    device = resolve_device(device)
    if case.device != device:
        raise ValueError(f"case lives on {case.device}, inference asked for {device}")
    cfg = merge(defaults.eval.infer, cfg_eval_infer or {})
    if load_ckp is not None:
        params, _, _, _ = load_checkpoint(load_ckp)
        model.load_jax_params(params)
    model.eval()

    n_trajs = cfg.n_trajs if cfg.n_trajs != -1 else data_test.num_samples
    loader = DataLoader(data_test, batch_size=cfg.batch_size,
                        rng=np.random.default_rng(seed))
    metrics_computer = MetricsComputer(
        list(cfg.metrics),
        dist_fn=case.displacement,
        metadata=data_test.metadata,
        input_seq_length=data_test.input_seq_length,
        stride=cfg.metrics_stride,
    )
    pos, ptype = data_test[0]
    _, neighbors = case.allocate_eval((pos[:, : data_test.input_seq_length], ptype))
    return eval_rollout(
        model=model,
        case=case,
        loader_eval=loader,
        neighbors=neighbors,
        metrics_computer=metrics_computer,
        n_rollout_steps=n_rollout_steps,
        n_trajs=n_trajs,
        rollout_dir=rollout_dir,
        out_type=cfg.out_type,
        n_extrap_steps=cfg.n_extrap_steps,
    )
