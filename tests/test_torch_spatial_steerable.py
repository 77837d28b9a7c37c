"""Spatial sharding of SEGNN and EGNN in the port
(``lagrangebench_torch.parallel.spatial``) on four gloo ranks, against the
JAX package's spatial SEGNN and EGNN on four virtual devices and against
the port's unsharded models.

One module fixture spawns four ranks once (``tests/_torch_spatial_worker.py``,
which imports no JAX) while this process computes the references: JAX's
``build_spatial_segnn_forward`` and ``build_spatial_egnn_forward`` and its
spatial train step with ``model="segnn"|"egnn"`` on a ring of 4, and the
port's unsharded forwards and rollouts. 512 particles in a 3D periodic box
of side 1, cutoff 0.12, a SEGNN of 2 layers, 8 scalar units and lmax 1, an
EGNN of 2 layers and width 16, float64. Tolerances, of the largest value:
EGNN forward and gradients 1e-10 (sums over slots and ranks run in other
orders); SEGNN forward 1e-9 and gradients 1e-5, as
``tests/test_torch_segnn.py`` holds the unsharded SEGNN (JAX's float64
tensor product rounds its products to float32); positions 1e-9.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_torch.data.synthetic import make_synthetic_dataset
from lagrangebench_torch.parallel import spatial as sp
from lagrangebench_tpu.config import Config as JaxConfig
from lagrangebench_tpu.defaults import defaults as jax_defaults
from lagrangebench_tpu.models.egnn import build_egnn as jax_build_egnn
from lagrangebench_tpu.models.segnn import build_segnn as jax_build_segnn
from lagrangebench_tpu.parallel import make_mesh as jax_make_mesh
from lagrangebench_tpu.parallel import spatial as jsp

from . import _torch_spatial_worker as w

ISL = w.ISL
FORWARD_TOL = {"segnn": 1e-9, "egnn": 1e-10}
GRAD_TOL = {"segnn": 1e-5, "egnn": 1e-10}
POS_TOL = 1e-9
BOX = [w.BOX] * w.DIM


def _jax_model(name):
    """JAX's SEGNN or EGNN for the worker's config, in float64."""
    cfg = JaxConfig(jax_defaults.model.to_dict())
    for key, value in w.steerable_cfg(name).to_dict().items():
        setattr(cfg, key, value)
    if name == "segnn":
        return jax_build_segnn(cfg, w.S_METADATA)
    stats = {k: jnp.asarray(v, jnp.float64) for k, v in w.STATS["velocity"].items()}
    return jax_build_egnn(cfg, w.S_METADATA, velocity_stats=stats)


def _cli_yaml(root, src, name):
    text = (
        "extends: LAGRANGEBENCH_DEFAULTS\n"
        f"dataset:\n  src: {src}\n"
        f"model:\n  name: {name}\n  num_mp_steps: 2\n  latent_dim: {8 if name == 'segnn' else 16}\n"
        "  input_seq_length: 4\n  lmax_hidden: 1\n"
        "train:\n  batch_size: 1\n  step_max: 2\n"
        f"eval:\n  n_rollout_steps: 3\n  rollout_dir: {root}/rollouts\n"
        "  train:\n    n_trajs: 1\n    batch_size: 1\n"
        "  infer:\n    batch_size: 1\n    n_trajs: 1\n    metrics: [mse]\n"
        f"logging:\n  log_steps: 1\n  eval_steps: 1\n  ckp_dir: {root}/ckp\n  wandb: false\n"
    )
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _jax_stats():
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), w.STATS)


def _jax_forward(name, params, pos, ptype, k_cap):
    """JAX's spatial forward on 4 virtual devices, in global order."""
    pos_sh, pt_sh, counts, order = jsp.spatial_partition(pos[:, :ISL], ptype, 4, box_x=w.BOX)
    kw = dict(box=BOX, cutoff=w.S_CUTOFF, input_seq_length=ISL, k_cap=k_cap,
              vel_mean=jnp.zeros(w.DIM), vel_std=jnp.full(w.DIM, 1e-3),
              compute_dtype=jnp.float64)
    if name == "segnn":
        fwd = jsp.build_spatial_segnn_forward(jax_make_mesh(4), params, _jax_model(name), **kw)
    else:
        fwd = jsp.build_spatial_egnn_forward(jax_make_mesh(4), params, _jax_model(name),
                                             acc_mean=jnp.zeros(w.DIM),
                                             acc_std=jnp.full(w.DIM, 1e-4), **kw)
    acc, overflow = fwd(jnp.asarray(pos_sh), jnp.asarray(pt_sh), jnp.asarray(counts)[:, None])
    assert not bool(overflow)
    acc = np.asarray(acc)
    out = np.zeros((w.S_N, w.DIM))
    for d in range(4):
        out[sp._slab_rows(counts, order, d)] = acc[d, :counts[d]]
    return out


def _jax_train_step(name, params, sample, k_cap):
    from lagrangebench_torch.checkpoint import flatten_tree

    pos_sh, pt_sh, counts, _ = jsp.spatial_partition(*sample, 4, box_x=w.BOX)
    step, fp = jsp.build_spatial_gns_train_step(
        jax_make_mesh(4), params, box=BOX, cutoff=w.S_CUTOFF, input_seq_length=ISL,
        num_mp_steps=w.MP_STEPS, k_cap=k_cap, normalization_stats=_jax_stats(),
        compute_dtype=jnp.float64, model=name, model_def=_jax_model(name))
    loss, grads, overflow = step(jax.tree.map(jnp.asarray, fp), jnp.asarray(pos_sh),
                                 jnp.asarray(pt_sh), jnp.asarray(counts))
    assert not bool(overflow)
    return {"loss": float(loss), "grads": flatten_tree(jax.tree.map(np.asarray, grads))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job on four spawned ranks, the references in this process;
    returns (per job: every rank's result, references)."""
    tmp = tmp_path_factory.mktemp("spatial_steerable")
    torch.set_num_threads(1)
    pos, ptype = w.trajectory(n=w.S_N)
    params = {name: w.steerable_model(name).jax_params() for name in ("segnn", "egnn")}
    k_cap = sp.spatial_caps(pos[:, ISL - 1], BOX, w.S_CUTOFF)[0]
    one = [(pos[:, :ISL + 1], ptype)]
    jobs = {}
    for name in ("segnn", "egnn"):
        common = dict(model=name, params=params[name])
        jobs[f"{name}4"] = ("steerable_forward", dict(n_space=4, pos=pos, ptype=ptype,
                                                      k_cap=k_cap, **common))
        jobs[f"step_{name}"] = ("steerable_train_step", dict(n_space=4, samples=one,
                                                             k_cap=k_cap, **common))
        jobs[f"rollout_{name}"] = ("steerable_rollout", dict(n_space=4, pos=pos, ptype=ptype,
                                                             **common))
    for n in (3, 2):
        jobs[f"egnn{n}"] = ("steerable_forward", dict(n_space=n, model="egnn",
                                                      params=params["egnn"], pos=pos,
                                                      ptype=ptype, k_cap=k_cap))
    src = make_synthetic_dataset(str(tmp), name="RPF", n_particles=512, dim=3, box=1.0,
                                 radius=w.S_CUTOFF, seq_len_train=12, seq_len_eval=7, n_trajs=2)
    for name in ("segnn", "egnn"):
        (tmp / name).mkdir()
        argv = [f"config={_cli_yaml(str(tmp / name), src, name)}", "gpu=-1", "mode=all",
                "parallel.spatial=4"]
        jobs[f"cli_{name}"] = ("cli_run", dict(argv=argv))
    names = list(jobs)
    context = w.start_ranks(list(jobs.values()), str(tmp))
    try:
        refs = {}
        for name in ("segnn", "egnn"):
            refs[f"{name}4"] = _jax_forward(name, params[name], pos, ptype, k_cap)
            refs[f"step_{name}"] = _jax_train_step(name, params[name], one[0], k_cap)
            refs[f"unsharded_{name}"] = w.steerable_unsharded(name, params[name], pos, ptype)
            refs[f"rollout_{name}"] = w.steerable_unsharded(name, params[name], pos, ptype,
                                                            rollout=True)
    finally:
        ranks = w.join_ranks(context, str(tmp))
    refs["tmp"] = tmp
    return {name: [ranks[r][i] for r in range(4)] for i, name in enumerate(names)}, refs


def _assemble(rank_results):
    out = np.zeros((w.S_N, w.DIM))
    for got in rank_results:
        if got is not None:
            assert not got["overflow"]
            out[got["rows"]] = got["acc"]
    return out


def _close(got, want, tol, what=""):
    top = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * top, f"{what}: {err:.3g} > {tol} x {top:.3g}"


@pytest.mark.parametrize("name", ["segnn", "egnn"])
def test_forward_on_a_ring_of_4_equals_jax(runs, name):
    """Four gloo ranks against JAX's ``build_spatial_segnn_forward`` and
    ``build_spatial_egnn_forward`` on four virtual devices: every particle's
    (normalized) acceleration within 1e-9 (SEGNN) and 1e-10 (EGNN) of the
    largest; the port's unsharded model agrees as well."""
    by_job, refs = runs
    got = _assemble(by_job[f"{name}4"])
    _close(got, refs[f"{name}4"], FORWARD_TOL[name], what=f"{name} ring 4 vs JAX")
    _close(got, refs[f"unsharded_{name}"], FORWARD_TOL[name], what=f"{name} vs unsharded")


@pytest.mark.parametrize("name", ["segnn", "egnn"])
def test_train_step_on_a_ring_of_4_equals_jax(runs, name):
    """Loss and every gradient against JAX's spatial train step with
    ``model=name`` on four devices (EGNN's sender sums return through the
    reverse halo, whose backward is the halo's forward): the loss within
    1e-10, the gradients within 1e-5 (SEGNN) and 1e-10 (EGNN) of the
    largest; all four ranks hold the sums."""
    by_job, refs = runs
    want = refs[f"step_{name}"]
    top = max(float(np.abs(v).max()) for v in want["grads"].values())
    assert top > 0
    for got in by_job[f"step_{name}"]:
        assert not got["overflow"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-10, abs=0)
        assert set(got["grads"]) == set(want["grads"])
        for k, v in want["grads"].items():
            err = float(np.abs(got["grads"][k] - v).max())
            assert err <= GRAD_TOL[name] * top, f"{k}: {err:.3g} > {GRAD_TOL[name]} x {top:.3g}"


@pytest.mark.parametrize("n", [3, 2])
def test_egnn_forward_on_rings_of_3_and_2_equals_unsharded(runs, n):
    """A ring of 3 (the reverse halo's two shifts; the fourth rank does no
    work) and of 2 (one shift, the periodic frame) against the port's
    unsharded EGNN, within 1e-10 of the largest value."""
    by_job, refs = runs
    assert all(r is None for r in by_job[f"egnn{n}"][n:])
    _close(_assemble(by_job[f"egnn{n}"]), refs["unsharded_egnn"], FORWARD_TOL["egnn"],
           what=f"egnn ring {n}")


@pytest.mark.parametrize("name", ["segnn", "egnn"])
def test_spatial_rollout_equals_unsharded(runs, name):
    """``spatial_rollout`` of 5 steps on four ranks, walls forced onto the
    ground truth, against the port's unsharded rollout: positions within
    1e-9 of the largest, on every rank."""
    by_job, refs = runs
    for got in by_job[f"rollout_{name}"]:
        _close(got, refs[f"rollout_{name}"], POS_TOL, what=f"{name} rollout")



@pytest.mark.parametrize("name", ["segnn", "egnn"])
def test_cli_mode_all_on_a_ring_of_4(runs, name):
    """``cli.main`` with ``model.name=segnn|egnn mode=all parallel.spatial=4
    gpu=-1`` under the launcher's environment on four ranks: 2 training
    steps, one checkpoint directory (the module's tree, as the unsharded
    runner writes it), and finite metrics that rank 0 prints and every rank
    returns."""
    from lagrangebench_torch.checkpoint import flatten_tree, load_checkpoint

    by_job, refs = runs
    results = by_job[f"cli_{name}"]
    ckp_root = refs["tmp"] / name / "ckp"
    made = os.listdir(ckp_root)
    assert len(made) == 1 and made[0].startswith(f"{name}_"), made
    params, _, _, step = load_checkpoint(str(ckp_root / made[0]))
    assert step == 1
    want = flatten_tree(w.steerable_model(name, compute_dtype="float32",
                                          magnitude_features=False).jax_params())
    assert {k: v.shape for k, v in flatten_tree(params).items()} == \
        {k: v.shape for k, v in want.items()}
    metrics = results[0]["metrics"]
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    assert all(r["metrics"] == metrics for r in results)
    assert "Training done" in results[0]["stdout"] and str(metrics) in results[0]["stdout"]
    assert all(r["stdout"] == "" for r in results[1:])
