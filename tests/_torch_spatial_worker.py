"""Jobs of the spatial-sharding tests, run in each rank that
``torch.multiprocessing`` spawns and, on one rank, in the test process for
the references. Imports torch and lagrangebench_torch only (a spawned child
re-imports this module); pytest does not collect it.

The case: 1,024 particles in a 3D periodic box of side 1.0, cutoff 0.09,
input sequence 4, models of latent width 16 with 2 message-passing steps,
float64 on the CPU. SEGNN and EGNN (the ``steerable_*`` jobs): 512
particles, cutoff 0.12, a SEGNN of 2 layers, 8 scalar units and lmax 1, an
EGNN of 2 layers and width 16. :func:`start_ranks` starts a list of jobs on n gloo
ranks over a ``file://`` init method; :func:`join_ranks` waits for them
and returns each rank's results.
"""

import os
import pickle

import numpy as np
import torch

N, DIM, ISL, BOX, CUTOFF, LATENT, MP_STEPS = 1024, 3, 4, 1.0, 0.09, 16, 2
ROLLOUT = 5
STATS = {"velocity": {"mean": np.zeros(DIM), "std": np.full(DIM, 1e-3)},
         "acceleration": {"mean": np.zeros(DIM), "std": np.full(DIM, 1e-4)}}
METADATA = {"dim": DIM, "num_particles_max": N, "periodic_boundary_conditions": [True] * DIM,
            "bounds": [[0.0, BOX]] * DIM, "default_connectivity_radius": CUTOFF,
            "vel_mean": [0.0] * DIM, "vel_std": [1e-3] * DIM, "acc_mean": [0.0] * DIM,
            "acc_std": [1e-4] * DIM}


def trajectory(seed=3, frames=ISL + 1 + ROLLOUT, n=N):
    """(n, frames, dim) straight-line trajectories wrapped in the box and
    (n,) types with five walls."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, BOX, size=(n, 1, DIM))
    vel = rng.normal(0, 2e-3, size=(n, 1, DIM))
    pos = np.mod(base + vel * np.arange(frames)[None, :, None], BOX)
    ptype = np.zeros(n, np.int32)
    ptype[:5] = 1
    return pos, ptype


def model_cfg(name):
    from lagrangebench_torch.config import Config

    return Config({"name": name, "fused_processor": True, "compute_dtype": "float64",
                   "num_mp_steps": MP_STEPS, "latent_dim": LATENT, "num_mlp_layers": 2,
                   "input_seq_length": ISL, "magnitude_features": name == "painn",
                   "isotropic_norm": False})


def seeded_model(name, seed=0):
    """The port's fused GNS or PaiNN with seeded float64 weights, on the CPU."""
    from lagrangebench_torch.models import setup_model

    return setup_model(model_cfg(name), METADATA, seed=seed, device="cpu").double()


def unsharded(model, params, pos, ptype):
    """The port's unsharded model on its own dense neighbor list: the float64
    acceleration before the model's float32 output cast."""
    from lagrangebench_torch.case import case_builder

    net = seeded_model(model)
    net.load_jax_params(params)
    case = case_builder([BOX] * DIM, METADATA, ISL, cfg_neighbors={"multiplier": 1.4},
                        cfg_model=model_cfg(model), noise_std=0.0, dtype=torch.float64,
                        device="cpu")
    feats, _ = case.allocate_eval((torch.as_tensor(pos[:, :ISL]), torch.as_tensor(ptype)))
    seen = []
    head = net.decoder if model == "gns" else net.readout[1]
    hook = head.register_forward_hook(
        lambda m, a, out: seen.append(out if model == "gns" else out[1].squeeze(-1)))
    with torch.no_grad():
        net(feats, torch.as_tensor(ptype))
    hook.remove()
    return seen[0].numpy()


def unsharded_rollout(params, pos, ptype):
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.evaluate.rollout import rollout_batch

    net = seeded_model("gns")
    net.load_jax_params(params)
    case = case_builder([BOX] * DIM, METADATA, ISL, cfg_neighbors={"multiplier": 1.4},
                        cfg_model=model_cfg("gns"), noise_std=0.0, dtype=torch.float64,
                        device="cpu")
    window = torch.as_tensor(pos[:, :ISL])
    _, nbrs = case.allocate_eval((window, torch.as_tensor(ptype)))
    preds, overflow, _ = rollout_batch(net, case, window[None], torch.as_tensor(ptype)[None],
                                       nbrs.broadcast(1),
                                       torch.as_tensor(pos[None, :, ISL:ISL + ROLLOUT]))
    assert not bool(overflow)
    return preds[0].numpy()


def untied(tree, seed=7):
    """The tree with noise of std 0.1 added to every vector (biases, the
    LayerNorm scales and offsets). With the zero-initialized biases a self
    edge, whose raw features are zero, sits exactly on the edge encoder's
    ReLU kink, where the derivative is a convention: JAX's ``jnp.maximum``
    (the spatial mirror's ReLU) takes 1/2, ``torch.relu`` 0."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (v + 0.1 * rng.normal(size=v.shape) if np.ndim(v) == 1 else v)
                for k, v in node.items()}

    return walk(tree)


def common(**kw):
    return dict(box=[BOX] * DIM, cutoff=CUTOFF, input_seq_length=ISL, num_mp_steps=MP_STEPS,
                compute_dtype=torch.float64, device="cpu", **kw)


def forward(n_space, model, params, pos, ptype, k_cap):
    """The spatial forward on a ring of ``n_space``: this slab's global rows
    and accelerations (None on a rank outside the ring)."""
    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    mesh = make_mesh(n_space)
    if not mesh.member:
        return None
    pos_sh, pt_sh, counts, order = sp.spatial_partition(pos[:, :ISL], ptype, n_space, BOX)
    build = sp.build_spatial_gns_forward if model == "gns" else sp.build_spatial_painn_forward
    fwd = build(mesh, params, k_cap=k_cap, vel_mean=STATS["velocity"]["mean"],
                vel_std=STATS["velocity"]["std"], **common())
    r = mesh.rank
    acc, overflow = fwd(pos_sh[r], pt_sh[r], counts[r])
    return {"rows": sp._slab_rows(counts, order, r), "acc": acc[:counts[r]].numpy(),
            "overflow": overflow}


def partition_batch(samples, n_space):
    """Globally partitioned (B, n_space, N_loc, ...) arrays of (pos, ptype) samples."""
    from lagrangebench_torch.parallel import spatial as sp

    parts = [sp.spatial_partition(p, t, n_space, BOX) for p, t in samples]
    n_loc = max(p[0].shape[1] for p in parts)

    def pad(a, fill=0):
        width = [(0, 0)] * a.ndim
        width[1] = (0, n_loc - a.shape[1])
        return np.pad(a, width, constant_values=fill)

    return (np.stack([pad(p[0]) for p in parts]), np.stack([pad(p[1], -1) for p in parts]),
            np.stack([p[2] for p in parts]))


def grads_tree(model, net):
    """The module's gradients as a flat standard-layout JAX tree."""
    from lagrangebench_torch.checkpoint import flatten_tree, unflatten_tree
    from lagrangebench_torch.models import (
        painn_standard_params_from_fused,
        standard_params_from_fused,
    )

    flat = {path: (p.grad.t() if tr else p.grad).numpy().copy()
            for path, p, tr in net.jax_leaves()}
    convert = standard_params_from_fused if model == "gns" else painn_standard_params_from_fused
    return flatten_tree(convert(unflatten_tree(flat), MP_STEPS))


def train_step(n_space, model, params, samples, k_cap, n_data=None, unroll=0):
    """One spatial train step: a 1D ring of ``n_space`` for one sample, or a
    (n_data, n_space) mesh for a batch. Returns the loss, the overflow flag
    and the gradients (standard layout)."""
    from lagrangebench_torch.parallel import make_mesh, make_mesh_2d
    from lagrangebench_torch.parallel import spatial as sp

    batched = n_data is not None
    mesh = make_mesh_2d(n_data, n_space) if batched else make_mesh(n_space)
    if not mesh.member:
        return None
    block = sp._rank_block(mesh, partition_batch(samples, n_space), len(samples))
    build = sp.build_spatial_train_step_dp if batched else sp.build_spatial_gns_train_step
    step, net = build(mesh, params, k_cap=k_cap, normalization_stats=STATS, model=model,
                      **common())
    loss, overflow = step(*block, unroll_steps=unroll)
    return {"loss": float(loss), "overflow": bool(overflow), "grads": grads_tree(model, net)}


def rollout(n_space, params, pos, ptype, caps=None, drift_share=None, chunk=25):
    """``spatial_rollout`` of ROLLOUT steps with the ground truth (walls
    forced onto it); records the capacity escalations and every chunk run
    (its length and both flags). ``caps``: the (k_cap, cell_cap) to start
    from in place of ``spatial_caps``'s; ``drift_share``: the drift margin."""
    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    mesh = make_mesh(n_space)
    if not mesh.member:
        return None
    escalations, chunks = [], []
    real = (sp._escalate, sp._rollout_chunk, sp.DRIFT_SHARE, sp.spatial_caps)

    def escalate(cap):
        escalations.append(cap)
        return real[0](cap)

    def chunk_run(core, pos, ptype, count, n_steps, gt=None):
        out = real[1](core, pos, ptype, count, n_steps, gt)
        chunks.append((n_steps, out[2][0], out[2][1]))
        return out

    sp._escalate, sp._rollout_chunk = escalate, chunk_run
    if drift_share is not None:
        sp.DRIFT_SHARE = drift_share
    if caps is not None:
        sp.spatial_caps = lambda *a, **k: caps
    try:
        preds = sp.spatial_rollout(
            params, pos[:, :ISL], ptype, mesh=mesh, n_steps=ROLLOUT, normalization_stats=STATS,
            chunk=chunk, target=pos[:, ISL:ISL + ROLLOUT].transpose(1, 0, 2), **common())
    finally:
        sp._escalate, sp._rollout_chunk, sp.DRIFT_SHARE, sp.spatial_caps = real
    return {"preds": preds, "escalations": escalations, "chunks": chunks}


PUSHFORWARD = {"steps": [-1, 0], "unrolls": [0, 1], "probs": [0, 1]}  # one unroll from step 1


def loop_data():
    """Synthetic periodic (train, valid) splits of N particles in 3D."""
    from lagrangebench_torch.data import ArrayDataset
    from lagrangebench_torch.data.synthetic import make_synthetic_arrays

    splits, metadata = make_synthetic_arrays(n_particles=N, dim=DIM, box=BOX, seq_len_train=12,
                                             seq_len_eval=ISL + 3, n_trajs=2)
    metadata["default_connectivity_radius"] = CUTOFF
    types = [np.zeros(N, np.int64) for _ in range(2)]
    types[0][:4] = 1
    return tuple(ArrayDataset(split, splits[split], types, metadata, input_seq_length=ISL,
                              extra_seq_length=extra)
                 for split, extra in (("train", 1), ("valid", 3)))


def train_loop(n_space, batch, params, store_ckp=None, seed=0):
    """``train_spatial`` for 3 steps (noise, one pushforward unroll from step
    1, validation and a checkpoint at step 2); the loss of every step."""
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.config import Config, merge
    from lagrangebench_torch.defaults import defaults
    from lagrangebench_torch.parallel import spatial as sp

    train_d, valid_d = loop_data()
    case = case_builder([BOX] * DIM, train_d.metadata, ISL, cfg_model=model_cfg("gns"),
                        noise_std=3e-4, dtype=torch.float64, device="cpu")
    cfg_train = merge(defaults.train, Config({
        "batch_size": batch, "noise_std": 3e-4, "optimizer": {"lr_start": 1e-3},
        "pushforward": PUSHFORWARD}))
    cfg_logging = merge(defaults.logging, Config({"log_steps": 1, "eval_steps": 2}))
    losses = []
    real_dp, real_1d = sp.build_spatial_train_step_dp, sp.build_spatial_gns_train_step

    def recording(build):
        def wrapped(*args, **kw):
            step, net = build(*args, **kw)

            def step_rec(*a, **k):
                out = step(*a, **k)
                losses.append(float(out[0]))
                return out

            step_rec.core = step.core
            return step_rec, net
        return wrapped

    sp.build_spatial_train_step_dp = recording(real_dp)
    sp.build_spatial_gns_train_step = recording(real_1d)
    try:
        std, _, opt = sp.train_spatial(
            params, case, train_d, valid_d, n_devices=n_space, model="gns",
            num_mp_steps=MP_STEPS, cfg_train=cfg_train, cfg_logging=cfg_logging,
            input_seq_length=ISL, metadata=train_d.metadata, seed=seed, step_max=3,
            store_ckp=store_ckp, compute_dtype=torch.float64, n_rollout_steps_val=3,
            n_trajs_val=1, device="cpu")
    finally:
        sp.build_spatial_train_step_dp, sp.build_spatial_gns_train_step = real_dp, real_1d
    from lagrangebench_torch.checkpoint import flatten_tree

    return {"losses": losses, "params": None if std is None else flatten_tree(std),
            "count": None if opt is None else opt.count}


def cli_run(argv, env):
    """``cli.main(argv)`` with ``env`` set (the launcher's variables); the
    metrics and what the run printed."""
    import contextlib
    import io

    from lagrangebench_torch import cli

    os.environ.update(env)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = cli.main(argv)
    return {"metrics": metrics, "stdout": out.getvalue()}


def _rank_main(rank, world, pg_file, out_dir, jobs):
    import torch.distributed as dist

    from lagrangebench_torch.parallel import init_distributed

    from ._torch_dp_worker import _agent_store

    torch.set_num_threads(1)
    results, stores = [], []
    for i, (name, kwargs) in enumerate(jobs):
        if name == "cli_run":
            # cli.main makes its own group from the launcher's env:// variables
            store, env = _agent_store(rank, world, f"{pg_file}{i}")
            stores.append(store)  # held until every job has ended
            results.append(cli_run(kwargs["argv"], env))
            continue
        if not dist.is_initialized():
            init_distributed(f"file://{pg_file}{i}", world, rank, device="cpu")
        kwargs = {k: (v.format(rank=rank) if isinstance(v, str) else v)
                  for k, v in kwargs.items()}
        results.append(globals()[name](**kwargs))
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def start_ranks(jobs, tmp_dir, world=4):
    """Start ``jobs`` ((function name, kwargs) pairs) on ``world`` spawned
    gloo ranks without waiting; :func:`join_ranks` waits and reads the
    results."""
    import torch.multiprocessing as mp

    return mp.start_processes(_rank_main, args=(world, os.path.join(tmp_dir, "pg"), tmp_dir,
                                                jobs), nprocs=world, join=False,
                              start_method="spawn")


def join_ranks(context, tmp_dir, world=4):
    while not context.join():
        pass
    out = []
    for rank in range(world):
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# SEGNN and EGNN
# ---------------------------------------------------------------------------

S_N, S_CUTOFF = 512, 0.12
S_METADATA = dict(METADATA, num_particles_max=S_N, default_connectivity_radius=S_CUTOFF,
                  dt=0.01)


def steerable_cfg(name, **overrides):
    from lagrangebench_torch.config import Config

    return Config({"name": name, "compute_dtype": "float64", "num_mp_steps": MP_STEPS,
                   "latent_dim": 8 if name == "segnn" else LATENT, "num_mlp_layers": 2,
                   "input_seq_length": ISL, "magnitude_features": True,
                   "isotropic_norm": False, "lmax_hidden": 1, "lmax_attributes": 1,
                   "velocity_aggregate": "avg", "segnn_norm": "none", **overrides})


def torch_stats():
    return {k: {kk: torch.as_tensor(vv) for kk, vv in v.items()} for k, v in STATS.items()}


def steerable_model(name, params=None, **overrides):
    """The port's SEGNN or EGNN in float64 on the CPU (seeded, or holding
    ``params``); EGNN integrates with the velocity stats of ``STATS``."""
    from lagrangebench_torch.models import setup_model

    net = setup_model(steerable_cfg(name, **overrides), S_METADATA, seed=0, device="cpu",
                      normalization_stats=torch_stats()).double()
    if params is not None:
        net.load_jax_params(params)
    return net


def s_common(model):
    return dict(box=[BOX] * DIM, cutoff=S_CUTOFF, input_seq_length=ISL,
                compute_dtype=torch.float64, model_def=steerable_model(model), device="cpu")


def steerable_forward(n_space, model, params, pos, ptype, k_cap):
    """The spatial SEGNN or EGNN forward on a ring of ``n_space`` (EGNN's
    normalized by ``STATS``): this slab's global rows and accelerations."""
    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    mesh = make_mesh(n_space)
    if not mesh.member:
        return None
    pos_sh, pt_sh, counts, order = sp.spatial_partition(pos[:, :ISL], ptype, n_space, BOX)
    kw = dict(vel_mean=STATS["velocity"]["mean"], vel_std=STATS["velocity"]["std"])
    if model == "egnn":
        kw.update(acc_mean=STATS["acceleration"]["mean"], acc_std=STATS["acceleration"]["std"])
    build = sp.build_spatial_segnn_forward if model == "segnn" else sp.build_spatial_egnn_forward
    fwd = build(mesh, params, k_cap=k_cap, **kw, **s_common(model))
    r = mesh.rank
    acc, overflow = fwd(pos_sh[r], pt_sh[r], counts[r])
    return {"rows": sp._slab_rows(counts, order, r), "acc": acc[:counts[r]].numpy(),
            "overflow": overflow}


def steerable_train_step(n_space, model, params, samples, k_cap):
    """One spatial train step of SEGNN or EGNN on a ring of ``n_space``: the
    loss, the overflow flag and the gradients by tree path."""
    from lagrangebench_torch.checkpoint import flatten_tree, unflatten_tree
    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    mesh = make_mesh(n_space)
    if not mesh.member:
        return None
    block = sp._rank_block(mesh, partition_batch(samples, n_space), len(samples))
    step, net = sp.build_spatial_gns_train_step(mesh, params, k_cap=k_cap,
                                                normalization_stats=STATS, model=model,
                                                **s_common(model))
    loss, overflow = step(*block)
    grads = flatten_tree(unflatten_tree({path: (p.grad.t() if tr else p.grad).numpy().copy()
                                         for path, p, tr in net.jax_leaves()}))
    return {"loss": float(loss), "overflow": bool(overflow), "grads": grads}


def steerable_rollout(n_space, model, params, pos, ptype):
    """``spatial_rollout`` of SEGNN or EGNN for ROLLOUT steps, walls forced
    onto the ground truth."""
    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    mesh = make_mesh(n_space)
    if not mesh.member:
        return None
    return sp.spatial_rollout(params, pos[:, :ISL], ptype, mesh=mesh, n_steps=ROLLOUT,
                              normalization_stats=STATS, num_mp_steps=MP_STEPS, model=model,
                              target=pos[:, ISL:ISL + ROLLOUT].transpose(1, 0, 2),
                              **s_common(model))


def steerable_unsharded(model, params, pos, ptype, rollout=False):
    """The port's unsharded SEGNN or EGNN on its own dense neighbor list:
    the normalized acceleration of the first window or, with ``rollout``,
    ROLLOUT steps with the walls forced onto the ground truth."""
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.evaluate.rollout import rollout_batch

    net = steerable_model(model, params)
    case = case_builder([BOX] * DIM, S_METADATA, ISL, cfg_neighbors={"multiplier": 1.4},
                        cfg_model=steerable_cfg(model), noise_std=0.0, dtype=torch.float64,
                        device="cpu")
    window = torch.as_tensor(pos[:, :ISL])
    feats, nbrs = case.allocate_eval((window, torch.as_tensor(ptype)))
    with torch.no_grad():
        if not rollout:
            acc = net(feats, torch.as_tensor(ptype))["acc"].numpy()
            std = STATS["acceleration"]["std"] if model == "egnn" else 1.0
            return acc / std
        preds, overflow, _ = rollout_batch(
            net, case, window[None], torch.as_tensor(ptype)[None], nbrs.broadcast(1),
            torch.as_tensor(pos[None, :, ISL:ISL + ROLLOUT]))
    assert not bool(overflow)
    return preds[0].numpy()
