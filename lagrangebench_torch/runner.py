"""Orchestration: config -> data -> case -> model -> train and/or infer.

Counterpart of ``lagrangebench_tpu/runner.py`` on one device. The device
comes from ``cfg.gpu`` as in the reference: None means ``cuda``, -1 the CPU,
k ``cuda:k``, which is made the current card before anything is built. ``mode=train`` and ``mode=all`` train with ``Trainer`` into
``<logging.ckp_dir>/<run_name>`` (``config.yaml``, ``params.npz``,
``opt_state.npz``, ``best/``); ``mode=infer`` loads ``<load_ckp>/best`` (or
``load_ckp`` itself), re-laid out for the fused processor where the config
asks for it; then ``infer`` runs on the test split and the averaged metrics
are printed and returned.

Neighbor formats: dense (with or without ``neighbors.emit_geometry``),
sparse (the reference's ``(2, E)`` layout, on the cell list or all-pairs
search; every model but the fused GNS processor and the fused PaiNN layer,
which need the dense layout, as in the JAX package) and slot (the fused
GNS, with batch size 1 in every stage the mode runs). Other settings raise
ValueError saying why. Neighbor backends: ``auto`` (the CUDA kernels for
the dense and slot formats, the cell list for the sparse one),
``celllist``, ``allpairs`` and the reference's names for the cell list.

Models: every model of the JAX package (GNS with either processor, PaiNN,
EGNN, SEGNN, Linear). As in the JAX runner, the model learns whether the
particles are of one type from the train split's first sample
(``homogeneous_particles``; SEGNN adds a type one-hot otherwise).

Not ported (each raises NotImplementedError naming its ROADMAP.md §1 item):
data or spatial parallelism over several devices, the import of the
reference's Haiku checkpoints and the profiler hook
(``logging.profile_dir``).
"""

from __future__ import annotations

import os
import os.path as osp
from datetime import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .case import case_builder
from .checkpoint import load_checkpoint
from .config import Config, save_yaml
from .data import H5Dataset
from .defaults import check_cfg
from .evaluate import averaged_metrics, infer
from .models import ensure_fused_params, setup_model
from .train import Trainer
from .train.trainer import check_profile_dir


def device_from_gpu(gpu: Optional[int]) -> torch.device:
    """``cfg.gpu`` as a device: None -> cuda, -1 -> cpu, k -> cuda:k."""
    if gpu is None:
        return torch.device("cuda")
    if int(gpu) == -1:
        return torch.device("cpu")
    return torch.device(f"cuda:{int(gpu)}")


def is_haiku_checkpoint(model_dir: str) -> bool:
    """A checkpoint in the reference's Haiku layout (``params_array.npy``)."""
    return osp.exists(osp.join(model_dir, "params_array.npy"))


def setup_data(cfg: Config) -> Tuple[H5Dataset, H5Dataset, H5Dataset]:
    """Train, valid and test splits from ``dataset.src``; the train windows
    carry the pushforward's extra frames, the eval windows the rollout."""
    kw = dict(dataset_path=cfg.dataset.src, name=cfg.dataset.name,
              input_seq_length=cfg.model.input_seq_length)
    eval_n_more = max(cfg.eval.n_rollout_steps, 1)
    return (
        H5Dataset("train", extra_seq_length=max(cfg.train.pushforward.unrolls), **kw),
        H5Dataset("valid", extra_seq_length=eval_n_more, **kw),
        H5Dataset("test" if cfg.eval.test else "valid", extra_seq_length=eval_n_more, **kw),
    )


def _check_ported(cfg: Config) -> None:
    if int(cfg.parallel.get("spatial", 0) or 0) > 1 or int(cfg.parallel.data) > 1:
        raise NotImplementedError(
            "parallel.data > 1 and parallel.spatial > 1 are not ported to "
            "lagrangebench_torch (ROADMAP.md §1 item 7); use parallel.data=-1 or 1"
        )
    fmt = cfg.neighbors.format
    if fmt == "sparse" and cfg.model.get("fused_processor", False) \
            and cfg.model.name.lower() in ("gns", "painn"):
        raise ValueError(
            f"model.fused_processor=true ({cfg.model.name}) needs the dense edge layout, as "
            "in the JAX package; use neighbors.format=dense or model.fused_processor=false"
        )
    if fmt == "slot":
        if cfg.model.name.lower() != "gns" or not cfg.model.get("fused_processor", False):
            raise ValueError(
                "neighbors.format=slot runs the fused GNS processor only (model.name=gns, "
                "model.fused_processor=true), as in the JAX package"
            )
        # the batch sizes of the stages this mode runs
        sizes = {}
        if cfg.mode in ("train", "all"):
            sizes["train.batch_size"] = int(cfg.train.batch_size)
            sizes["eval.train.batch_size"] = int(cfg.eval.train.batch_size)
        if cfg.mode in ("infer", "all"):
            sizes["eval.infer.batch_size"] = int(cfg.eval.infer.batch_size)
        if any(v != 1 for v in sizes.values()):
            raise ValueError(
                f"neighbors.format=slot is single-sample: every batch size of mode="
                f"{cfg.mode} must be 1 ({sizes}); the JAX package's batched slot "
                "preprocess fails above batch 1"
            )


def train_or_infer(cfg: Config, data: Optional[Sequence] = None):
    """Train and/or infer as ``cfg.mode`` says; returns the averaged infer
    metrics (None for ``mode=train``).

    ``data``: optional (train, valid, test) datasets used in place of the
    H5 splits of ``dataset.src`` (e.g. in-memory ``ArrayDataset``s).
    """
    check_cfg(cfg)
    _check_ported(cfg)
    check_profile_dir(cfg.logging)
    device = device_from_gpu(cfg.get("gpu"))
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # the kernels launch on the current card
    if device.type == "cuda" and torch.cuda.device_count() > 1 and cfg.parallel.data != 1:
        print(f"{torch.cuda.device_count()} CUDA devices visible; lagrangebench_torch "
              f"runs on one ({device})")
    mode = cfg.mode
    old_model_dir = cfg.load_ckp

    data_train, data_valid, data_test = data if data is not None else setup_data(cfg)
    metadata = data_train.metadata
    bounds = np.asarray(metadata["bounds"])
    case = case_builder(
        box=(bounds[:, 1] - bounds[:, 0]).tolist(),
        metadata=metadata,
        input_seq_length=cfg.model.input_seq_length,
        cfg_neighbors=cfg.neighbors,
        cfg_model=cfg.model,
        noise_std=cfg.train.noise_std,
        external_force_fn=data_train.external_force_fn,
        dtype=cfg.dtype,
        device=device,
    )
    _, particle_type = data_train[0]
    model = setup_model(cfg.model, metadata,
                        has_external_force=data_train.external_force_fn is not None,
                        seed=cfg.seed, device=device,
                        normalization_stats=case.normalization_stats,
                        homogeneous_particles=bool(particle_type.max() == particle_type.min()))

    trained = False
    if mode in ("train", "all"):
        if cfg.logging.run_name is None:
            cfg.logging.run_name = (f"{cfg.model.name}_{data_train.name}_"
                                    + datetime.now().strftime("%Y%m%d-%H%M%S"))
        store_ckp = osp.join(cfg.logging.ckp_dir, cfg.logging.run_name)
        os.makedirs(store_ckp, exist_ok=True)
        save_yaml(cfg, osp.join(store_ckp, "config.yaml"))
        trainer = Trainer(model, case, data_train, data_valid, cfg_train=cfg.train,
                          cfg_eval=cfg.eval, cfg_logging=cfg.logging,
                          input_seq_length=cfg.model.input_seq_length, seed=cfg.seed,
                          device=device)
        trainer.train(step_max=cfg.train.step_max, load_ckp=old_model_dir, store_ckp=store_ckp)
        print(f"Training done; params: {sum(p.numel() for p in model.parameters())}")
        old_model_dir = store_ckp
        trained = True

    if mode in ("infer", "all"):
        if not trained:
            best_dir = osp.join(old_model_dir, "best")
            load_dir = best_dir if osp.exists(osp.join(best_dir, "metadata_ckp.json")) \
                else old_model_dir
            if is_haiku_checkpoint(load_dir):
                raise NotImplementedError(
                    f"{load_dir} is a reference Haiku checkpoint; its import is not "
                    "ported to lagrangebench_torch (ROADMAP.md §1 item 8)"
                )
            params, _, _, step = load_checkpoint(load_dir)
            model.load_jax_params(ensure_fused_params(params, cfg.model))
            print(f"Loaded model from {load_dir} at step {step}")
        eval_metrics = infer(model, case, data_test, cfg_eval_infer=cfg.eval.infer,
                             rollout_dir=cfg.eval.rollout_dir,
                             n_rollout_steps=cfg.eval.n_rollout_steps, seed=cfg.seed,
                             device=device)
        metrics = averaged_metrics(eval_metrics)
        print(metrics)
        return metrics
    return None
