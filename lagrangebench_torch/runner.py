"""Orchestration: config -> data -> case -> model -> train and/or infer.

Counterpart of ``lagrangebench_tpu/runner.py``. The device comes from
``cfg.gpu`` as in the reference: None means ``cuda``, -1 the CPU, k
``cuda:k``, which is made the current card before anything is built.
``mode=train`` and ``mode=all`` train with ``Trainer`` into
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

Data parallelism (``parallel.data``), with the JAX runner's mesh sizing:
for ``parallel.data != 1`` the process group is initialized where a launch
is indicated (``python -m torch.distributed.run --nproc_per_node=N -m
lagrangebench_torch ...``; NCCL on the cards, gloo with ``gpu=-1``), and the
mesh takes all ranks (-1) or ``parallel.data`` of them, cut to the ranks
that exist and down to a divisor of ``train.batch_size``; a mesh of one is
no mesh, so ``parallel.data=2`` in one process runs alone, as JAX does on
one device. Under a launcher rank r runs on ``cuda:LOCAL_RANK`` (every rank
on the CPU with ``gpu=-1``); a rank beyond the mesh does no work. Training
and inference share the mesh; rank 0 names the run and writes.

Spatial sharding (``parallel.spatial: N``, N > 1; GNS, PaiNN, SEGNN and
EGNN, fully periodic boxes): training and inference run over an N-slab ring
(``parallel/spatial.py``) of N launched ranks, N x n_data when
``train.batch_size > 1`` shards the batch over the rows of a (data, space)
mesh (n_data the largest divisor of the batch within ranks // N); with
fewer ranks the runner raises ValueError saying how to launch, rather than
run alone. Checkpoints are written in the standard layout, by rank 0. The
compute dtype is ``model.compute_dtype`` (the JAX runner's spatial path
leaves its functions' float32 default).

Checkpoints: ``load_ckp`` names one of this package's (``params.npz``)
or one of the reference's Haiku checkpoints (``params_array.npy``), which
``compat.load_reference_checkpoint`` imports for GNS, EGNN, PaiNN and
Linear, as the JAX runner does; either is then re-laid out for the fused
processor where the config asks for it.
"""

from __future__ import annotations

import os
import os.path as osp
from datetime import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .case import case_builder
from .checkpoint import flatten_tree, load_checkpoint
from .compat import is_haiku_checkpoint, load_reference_checkpoint
from .config import Config, save_yaml
from .data import H5Dataset
from .defaults import check_cfg
from .evaluate import averaged_metrics, infer
from .models import ensure_fused_params, setup_model
from .parallel import (
    Mesh,
    broadcast_object,
    data_parallel_size,
    init_distributed,
    is_main,
    make_mesh,
)
from .parallel.mesh import launch_hint
from .train import Trainer


def device_from_gpu(gpu: Optional[int]) -> torch.device:
    """``cfg.gpu`` as a device: None -> cuda, -1 -> cpu, k -> cuda:k."""
    if gpu is None:
        return torch.device("cuda")
    if int(gpu) == -1:
        return torch.device("cpu")
    return torch.device(f"cuda:{int(gpu)}")


def rank_device(gpu: Optional[int]) -> torch.device:
    """This process's device. Under a launcher (``LOCAL_RANK`` set) with
    ``gpu`` unset, ``cuda:LOCAL_RANK``; otherwise :func:`device_from_gpu`.
    ``gpu=k`` with more than one launched rank raises ValueError: every
    rank would take the same card."""
    local, world = os.environ.get("LOCAL_RANK"), int(os.environ.get("WORLD_SIZE", "1"))
    if gpu is not None and int(gpu) != -1 and local is not None and world > 1:
        raise ValueError(
            f"gpu={gpu} with {world} launched ranks would put every rank on cuda:{gpu}; "
            "leave gpu unset (rank r runs on cuda:LOCAL_RANK) or set gpu=-1 (the CPU)"
        )
    if gpu is None and local is not None:
        return torch.device(f"cuda:{int(local)}")
    return device_from_gpu(gpu)


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


def _spatial(cfg: Config) -> int:
    return int(cfg.parallel.get("spatial", 0) or 0)


def _check_ported(cfg: Config) -> None:
    if _spatial(cfg) > 1:
        from .parallel.spatial import MODELS

        name = cfg.model.name.lower()
        if name not in MODELS:
            raise ValueError(f"parallel.spatial supports {'|'.join(MODELS)}, got "
                             f"model.name={name}")
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
    device = rank_device(cfg.get("gpu"))
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # the kernels launch on the current card

    n_data = int(cfg.parallel.data)
    n_spatial = _spatial(cfg)
    if n_data != 1 or n_spatial > 1:
        init_distributed(device=device)  # a no-op unless a launch is indicated
    world, rank = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    if n_spatial > 1:
        return _train_or_infer_spatial(cfg, data, device, world, rank)
    n_req = data_parallel_size(n_data, world, int(cfg.train.batch_size))
    mesh = make_mesh(n_req) if n_req > 1 else None
    if rank >= n_req:
        print(f"rank {rank}: the data mesh holds ranks 0-{n_req - 1} (parallel.data={n_data}, "
              f"{world} ranks, train.batch_size={cfg.train.batch_size}); this rank does no work")
        return None
    main = is_main(mesh)
    mode = cfg.mode
    old_model_dir = cfg.load_ckp

    data_train, data_valid, data_test = data if data is not None else setup_data(cfg)
    metadata = data_train.metadata
    case = _case(cfg, data_train, device)
    _, particle_type = data_train[0]
    model = setup_model(cfg.model, metadata,
                        has_external_force=data_train.external_force_fn is not None,
                        seed=cfg.seed, device=device,
                        normalization_stats=case.normalization_stats,
                        homogeneous_particles=bool(particle_type.max() == particle_type.min()))

    trained = False
    if mode in ("train", "all"):
        store_ckp = _run_dir(cfg, data_train, mesh, main)
        trainer = Trainer(model, case, data_train, data_valid, cfg_train=cfg.train,
                          cfg_eval=cfg.eval, cfg_logging=cfg.logging,
                          input_seq_length=cfg.model.input_seq_length, seed=cfg.seed,
                          device=device, mesh=mesh)
        trainer.train(step_max=cfg.train.step_max, load_ckp=old_model_dir, store_ckp=store_ckp)
        if main:
            print(f"Training done; params: {sum(p.numel() for p in model.parameters())}")
        old_model_dir = store_ckp
        trained = True

    if mode in ("infer", "all"):
        if not trained:
            params = _load_params(old_model_dir, main, cfg.model)
            model.load_jax_params(params)
        eval_metrics = infer(model, case, data_test, cfg_eval_infer=cfg.eval.infer,
                             rollout_dir=cfg.eval.rollout_dir,
                             n_rollout_steps=cfg.eval.n_rollout_steps, seed=cfg.seed,
                             device=device, mesh=mesh)
        metrics = averaged_metrics(eval_metrics)
        if main:
            print(metrics)
        return metrics
    return None


def _case(cfg: Config, data_train, device):
    bounds = np.asarray(data_train.metadata["bounds"])
    return case_builder(box=(bounds[:, 1] - bounds[:, 0]).tolist(),
                        metadata=data_train.metadata,
                        input_seq_length=cfg.model.input_seq_length, cfg_neighbors=cfg.neighbors,
                        cfg_model=cfg.model, noise_std=cfg.train.noise_std,
                        external_force_fn=data_train.external_force_fn, dtype=cfg.dtype,
                        device=device)


def _run_dir(cfg: Config, data_train, mesh, main: bool) -> str:
    """The run's checkpoint directory ``<ckp_dir>/<run_name>``; rank 0's
    clock names the run on every rank of ``mesh``, and rank 0 makes the
    directory and writes ``config.yaml``."""
    if cfg.logging.run_name is None:
        cfg.logging.run_name = broadcast_object(
            f"{cfg.model.name}_{data_train.name}_" + datetime.now().strftime("%Y%m%d-%H%M%S"),
            mesh)
    store_ckp = osp.join(cfg.logging.ckp_dir, cfg.logging.run_name)
    if main:
        os.makedirs(store_ckp, exist_ok=True)
        save_yaml(cfg, osp.join(store_ckp, "config.yaml"))
    return store_ckp


def _load_params(model_dir: str, main: bool, cfg_model):
    """The parameter tree of ``<model_dir>/best`` (or ``model_dir`` itself),
    this package's checkpoint or an imported Haiku one, re-laid out for the
    fused processor where ``cfg_model`` asks for it."""
    best_dir = osp.join(model_dir, "best")
    load_dir = best_dir if osp.exists(osp.join(best_dir, "metadata_ckp.json")) else model_dir
    if is_haiku_checkpoint(load_dir):
        params, _, _ = load_reference_checkpoint(load_dir, cfg_model.name, cfg_model,
                                                 verbose=main)
    else:
        params, _, _, step = load_checkpoint(load_dir)
        if main:
            print(f"Loaded model from {load_dir} at step {step}")
    return ensure_fused_params(params, cfg_model)


def _train_or_infer_spatial(cfg: Config, data, device, world: int, rank: int):
    """``train_or_infer`` under ``parallel.spatial: N``: ``train_spatial``,
    then ``infer_spatial``, on the first N ranks (N x n_data for training at
    a batch above one; further ranks do no work)."""
    from .parallel.spatial import _require_periodic, infer_spatial, train_spatial

    n_spatial = _spatial(cfg)
    if world < n_spatial:
        raise ValueError(f"parallel.spatial={n_spatial} shards each sample over {n_spatial} "
                         f"ranks, and {world} are running; {launch_hint(n_spatial)}")
    name = cfg.model.name.lower()
    main = rank == 0
    data_train, data_valid, data_test = data if data is not None else setup_data(cfg)
    metadata = data_train.metadata
    _require_periodic(metadata, f"runner(mode={cfg.mode})")  # before any work
    case = _case(cfg, data_train, device)
    _, particle_type = data_train[0]
    # SEGNN and EGNN run the module built for the config (as JAX passes its
    # model_def); GNS and PaiNN are sized from their parameter trees
    seeded = setup_model(cfg.model, metadata, seed=cfg.seed,
                         device=device if name in ("segnn", "egnn") else "cpu",
                         normalization_stats=case.normalization_stats,
                         homogeneous_particles=bool(particle_type.max() == particle_type.min()))
    kw = dict(num_mp_steps=int(cfg.model.num_mp_steps), model=name, device=device,
              compute_dtype=cfg.model.get("compute_dtype", "float32"),
              model_def=seeded if name in ("segnn", "egnn") else None)
    old_model_dir, params = cfg.load_ckp, None
    if cfg.mode in ("train", "all"):
        store_ckp = _run_dir(cfg, data_train, Mesh(dist.group.WORLD, rank, world), main)
        n_trajs_val = int(cfg.eval.train.n_trajs)
        if n_trajs_val == -1:
            n_trajs_val = data_valid.num_samples
        params, _, _ = train_spatial(
            seeded.jax_params(), case, data_train, data_valid, n_devices=n_spatial,
            cfg_train=cfg.train, cfg_logging=cfg.logging,
            input_seq_length=cfg.model.input_seq_length, metadata=metadata, seed=cfg.seed,
            step_max=cfg.train.step_max, store_ckp=store_ckp, load_ckp=old_model_dir,
            n_rollout_steps_val=int(cfg.eval.n_rollout_steps), n_trajs_val=n_trajs_val, **kw)
        if main:
            print(f"Training done; params: {sum(v.size for v in flatten_tree(params).values())}")
        old_model_dir = store_ckp
    if cfg.mode not in ("infer", "all"):
        return None
    if rank >= n_spatial:
        make_mesh(n_spatial)  # the ring's group is made by every rank
        print(f"rank {rank}: the slab ring holds ranks 0-{n_spatial - 1} "
              f"(parallel.spatial={n_spatial}, {world} ranks); this rank does no work")
        return None
    if params is None:
        params = _load_params(old_model_dir, main, cfg.model)
    eval_metrics = infer_spatial(params, case, data_test, n_devices=n_spatial,
                                 cfg_eval_infer=cfg.eval.infer,
                                 n_rollout_steps=cfg.eval.n_rollout_steps, **kw)
    metrics = averaged_metrics(eval_metrics)
    if main:
        print(metrics)
    return metrics

