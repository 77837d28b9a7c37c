"""Jobs of the data-parallel tests, run in each rank that
``torch.multiprocessing`` spawns and, with no mesh, in the test process for
the one-rank reference. This module imports torch and lagrangebench_torch
only: a spawned child re-imports it, and importing JAX there would cost
seconds per child. pytest does not collect it (no ``test_`` prefix).

Every job returns plain numpy results; :func:`run_ranks` runs a list of
jobs on n gloo ranks over a ``file://`` init method and returns each rank's
results.
"""

import os
import pickle
import sys
import types

import numpy as np
import torch

N, DIM, ISL, LATENT, MP_STEPS, BATCH = 64, 3, 4, 16, 2, 4
PUSHFORWARD = {"steps": [-1, 0], "unrolls": [0, 1], "probs": [0, 1]}  # unroll 1 from step 1


def data(n_trajs=2, seq_len_eval=ISL + 3):
    """Synthetic (train, valid, test) splits: walls and padding in the
    first trajectory, so that the masks matter."""
    from lagrangebench_torch.data import ArrayDataset
    from lagrangebench_torch.data.synthetic import make_synthetic_arrays

    splits, metadata = make_synthetic_arrays(n_particles=N, dim=DIM, box=1.0, seq_len_train=12,
                                             seq_len_eval=seq_len_eval, n_trajs=n_trajs)
    types = [np.zeros(N, np.int64) for _ in range(n_trajs)]
    types[0][:4] = 1
    return tuple(ArrayDataset(split, splits[split], types, metadata, input_seq_length=ISL,
                              extra_seq_length=extra)
                 for split, extra in (("train", 1), ("valid", 3), ("test", 3)))


def model_case(metadata, processor="fused", noise_std=3e-4, seed=0):
    """A float64 GNS (parameters and compute) and its case on the CPU."""
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.config import Config
    from lagrangebench_torch.models import setup_model

    cfg_model = Config({"name": "gns", "fused_processor": processor == "fused",
                        "compute_dtype": "float64", "num_mp_steps": MP_STEPS,
                        "latent_dim": LATENT, "num_mlp_layers": 2, "input_seq_length": ISL,
                        "magnitude_features": False, "isotropic_norm": False})
    case = case_builder([1.0] * DIM, metadata, ISL, cfg_neighbors={"backend": "auto"},
                        cfg_model=cfg_model, noise_std=noise_std, dtype=torch.float64,
                        device="cpu")
    return setup_model(cfg_model, metadata, seed=seed, device="cpu").double(), case


def train(mesh, processor="fused", noise_std=3e-4, overflow_at=None, profile_dir=None,
          params=None):
    """3 training steps at batch 4 (one pushforward unroll from step 1).

    ``overflow_at``: the global sample whose neighbor flag is forced at
    step 1's first attempt (the rank that holds it raises it). ``params``:
    a JAX tree to start from. Returns the loss per attempt, the final
    parameters (by JAX tree path), the adam count and the positions each
    reallocation sized from."""
    from lagrangebench_torch.checkpoint import flatten_tree
    from lagrangebench_torch.train import Trainer

    train_d, valid_d, _ = data()
    model, case = model_case(train_d.metadata, processor, noise_std)
    if params is not None:
        model.load_jax_params(params)
    logging = {"log_steps": 1, "eval_steps": 10**9}
    if profile_dir is not None:
        logging.update(profile_dir=profile_dir, profile_steps=[1, 2])
    tr = Trainer(model, case, train_d, valid_d,
                 cfg_train={"batch_size": BATCH, "noise_std": noise_std,
                            "optimizer": {"lr_start": 1e-3}, "pushforward": PUSHFORWARD},
                 cfg_eval={"n_rollout_steps": 3, "train": {"n_trajs": 1}},
                 cfg_logging=logging, input_seq_length=ISL, device="cpu", mesh=mesh)
    losses, realloc = [], []
    real_step, real_pre, real_alloc = tr.train_step, tr.case.preprocess_batched, tr.case.allocate
    calls = [0]
    per = BATCH // (mesh.size if mesh is not None else 1)
    rank = mesh.rank if mesh is not None else 0

    def train_step(*args):
        out = real_step(*args)
        losses.append(float(out[0]))
        return out

    def preprocess(*args, **kw):
        feats, targets, nbrs = real_pre(*args, **kw)
        calls[0] += 1
        if overflow_at is not None and calls[0] == 2 and overflow_at // per == rank:
            nbrs.did_buffer_overflow[overflow_at % per] = True
        return feats, targets, nbrs

    def allocate(generator, sample, *args, **kw):
        if kw.get("capacity_boost", 1.0) != 1.0:
            realloc.append(np.asarray(sample[0]).copy())
        return real_alloc(generator, sample, *args, **kw)

    tr.train_step = train_step
    tr.case = tr.case._replace(preprocess_batched=preprocess, allocate=allocate)
    tr.train(step_max=2)
    return {"losses": losses, "params": flatten_tree(model.jax_params()),
            "count": tr.optimizer.count, "realloc": realloc}


def infer_run(mesh, batch_size, rollout_dir):
    """``infer`` of 4 test trajectories (3 steps, mse, e_kin, Sinkhorn,
    pickles into ``rollout_dir``) with seeded float64 weights."""
    from lagrangebench_torch.evaluate import infer

    _, _, test = data(n_trajs=4)
    model, case = model_case(test.metadata, noise_std=0.0)
    return infer(model, case, test, rollout_dir=rollout_dir, n_rollout_steps=3, device="cpu",
                 cfg_eval_infer={"batch_size": batch_size, "n_trajs": 4, "out_type": "pkl",
                                 "metrics": ["mse", "e_kin", "sinkhorn"]},
                 mesh=mesh)


class WandbStub(types.ModuleType):
    """A ``wandb`` module that records ``init`` and ``log`` calls."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw["config"]["info"]["dataset_name"]))
        stub = self

        class Run:
            def log(self, metrics, step):
                stub.calls.append(("log", step))

            def finish(self):
                stub.calls.append(("finish", None))

        return Run()


def cli_run(argv, env):
    """``cli.main(argv)`` with ``env`` set (the launcher's variables) and a
    ``wandb`` stub in ``sys.modules``; returns the metrics, the stub's
    calls and what the run printed."""
    import contextlib
    import io

    from lagrangebench_torch import cli

    os.environ.update(env)
    stub = sys.modules["wandb"] = WandbStub()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            metrics = cli.main(argv)
    finally:
        del sys.modules["wandb"]
    return {"metrics": metrics, "wandb": stub.calls, "stdout": out.getvalue()}


def _agent_store(rank, world, pg_file):
    """The rendezvous ``torch.distributed.run`` hands its workers: rank 0
    serves a TCPStore on a port the OS picks, bound once and held, so no
    other process can take it between its choice and its use; the port
    reaches the other ranks over a ``file://`` group that is then torn down.
    Returns (the store, on rank 0 only; the launcher's variables that point
    an env:// rendezvous at it)."""
    import torch.distributed as dist

    from lagrangebench_torch.parallel import init_distributed

    if not dist.is_initialized():
        init_distributed(f"file://{pg_file}", world, rank, device="cpu")
    store = (dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False)
             if rank == 0 else None)
    box = [store.port if store is not None else None]
    dist.broadcast_object_list(box, src=0)
    dist.destroy_process_group()
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(box[0]), "WORLD_SIZE": str(world),
           "RANK": str(rank), "LOCAL_RANK": str(rank),
           "TORCHELASTIC_USE_AGENT_STORE": "True", "TORCHELASTIC_RESTART_COUNT": "0"}
    return store, env


def _rank_main(rank, world, pg_file, out_dir, jobs):
    import torch.distributed as dist

    from lagrangebench_torch.parallel import init_distributed, make_mesh

    torch.set_num_threads(1)
    results, stores = [], []
    for i, (name, kwargs) in enumerate(jobs):
        kwargs = {k: (v.format(rank=rank) if isinstance(v, str) else v)
                  for k, v in kwargs.items()}
        if name == "cli_run":
            # cli.main makes its own group from the launcher's env:// variables,
            # which is what this job tests: a file:// method cannot stand in
            store, env = _agent_store(rank, world, f"{pg_file}{i}")
            stores.append(store)  # held until every job has ended
            results.append(cli_run(kwargs["argv"], env))
            continue
        if not dist.is_initialized():
            init_distributed(f"file://{pg_file}{i}", world, rank, device="cpu")
        results.append(globals()[name](make_mesh(world), **kwargs))
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_ranks(jobs, tmp_dir, world=2):
    """Run ``jobs`` ((function name, kwargs) pairs; a string kwarg may name
    ``{rank}``) on ``world`` spawned gloo ranks; returns each rank's list of
    results."""
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(world, os.path.join(tmp_dir, "pg"), tmp_dir, jobs), nprocs=world)
    out = []
    for rank in range(world):
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
