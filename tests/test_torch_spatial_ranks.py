"""Spatial sharding in the port (``lagrangebench_torch.parallel.spatial``) on
four gloo ranks, against the JAX package's spatial functions on four virtual
devices and against the port on one rank or unsharded.

One module fixture spawns four ranks once (``tests/_torch_spatial_worker.py``,
which imports no JAX) and runs every job there while this process computes
the references: three JAX spatial programs (the GNS and PaiNN forwards and
the GNS train step on a ring of 4) and the port's one-rank runs. 1,024
particles in a 3D periodic box of side 1, cutoff 0.09, latent 16, 2 MP
steps, float64. Sums over slots and ranks run in other orders, so values
agree within 1e-10 of the largest magnitude (positions within 1e-9).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_torch.data.synthetic import make_synthetic_dataset
from lagrangebench_torch.parallel import spatial as sp
from lagrangebench_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from lagrangebench_tpu.parallel import make_mesh as jax_make_mesh
from lagrangebench_tpu.parallel import spatial as jsp

from . import _torch_spatial_worker as w

TOL, POS_TOL = 1e-10, 1e-9
ISL, STEPS = w.ISL, w.ROLLOUT


def _cli_yaml(root, src):
    text = (
        "extends: LAGRANGEBENCH_DEFAULTS\n"
        f"dataset:\n  src: {src}\n"
        "model:\n  name: gns\n  num_mp_steps: 2\n  latent_dim: 16\n  input_seq_length: 4\n"
        "train:\n  batch_size: 1\n  step_max: 2\n"
        "  pushforward:\n    steps: [-1, 0]\n    unrolls: [0, 1]\n    probs: [0, 1]\n"
        f"eval:\n  n_rollout_steps: 3\n  rollout_dir: {root}/rollouts\n"
        "  train:\n    n_trajs: 1\n    batch_size: 1\n"
        "  infer:\n    batch_size: 1\n    n_trajs: 2\n    metrics: [mse, e_kin]\n"
        f"logging:\n  log_steps: 1\n  eval_steps: 2\n  ckp_dir: {root}/ckp\n  wandb: false\n"
    )
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _pushforward_sample(seed):
    """A window in the pushforward layout of one unroll: isl + 2 frames of
    the sequence, then the isl-frame raw window."""
    pos, ptype = w.trajectory(seed=seed)
    return np.concatenate([pos[:, :ISL + 2], pos[:, :ISL]], axis=1), ptype


def _jax_stats():
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), w.STATS)


def _jax_forward(model, params, pos, ptype, k_cap):
    """JAX's spatial forward on 4 virtual devices, in global order."""
    pos_sh, pt_sh, counts, order = jsp.spatial_partition(pos[:, :ISL], ptype, 4, box_x=w.BOX)
    kw = dict(box=[w.BOX] * w.DIM, cutoff=w.CUTOFF, input_seq_length=ISL,
              num_mp_steps=w.MP_STEPS, k_cap=k_cap, vel_mean=jnp.zeros(w.DIM),
              vel_std=jnp.full(w.DIM, 1e-3), compute_dtype=jnp.float64)
    if model == "gns":
        fwd = jsp.build_spatial_gns_forward(jax_make_mesh(4), params, **kw)
    else:
        fwd = jsp.build_spatial_painn_forward(jax_make_mesh(4), params, radius=1.5 * w.CUTOFF,
                                              **kw)
    acc, overflow = fwd(jnp.asarray(pos_sh), jnp.asarray(pt_sh), jnp.asarray(counts)[:, None])
    assert not bool(overflow)
    acc = np.asarray(acc)
    out = np.zeros((w.N, w.DIM))
    for d in range(4):
        out[sp._slab_rows(counts, order, d)] = acc[d, :counts[d]]
    return out


def _jax_train_step(params, sample, k_cap):
    pos_sh, pt_sh, counts, _ = jsp.spatial_partition(*sample, 4, box_x=w.BOX)
    step, fp = jsp.build_spatial_gns_train_step(
        jax_make_mesh(4), params, box=[w.BOX] * w.DIM, cutoff=w.CUTOFF, input_seq_length=ISL,
        num_mp_steps=w.MP_STEPS, k_cap=k_cap, normalization_stats=_jax_stats(),
        compute_dtype=jnp.float64, model="gns")
    loss, grads, overflow = step(jax.tree.map(jnp.asarray, fp), jnp.asarray(pos_sh),
                                 jnp.asarray(pt_sh), jnp.asarray(counts))
    assert not bool(overflow)
    from lagrangebench_torch.checkpoint import flatten_tree

    std = jax.tree.map(np.asarray, jsp._SpatialGNS.unpack_params(grads))
    return {"loss": float(loss), "grads": flatten_tree(std)}


def _assemble(rank_results):
    out = np.zeros((w.N, w.DIM))
    for got in rank_results:
        if got is not None:
            assert not got["overflow"]
            out[got["rows"]] = got["acc"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job on four spawned ranks, the references in this process;
    returns (per job: every rank's result, references, paths)."""
    tmp = tmp_path_factory.mktemp("spatial")
    torch.set_num_threads(1)
    pos, ptype = w.trajectory()
    gns, painn = w.seeded_model("gns"), w.seeded_model("painn")
    gp, pp = w.untied(gns.jax_params()), painn.jax_params()
    k_cap = sp.spatial_caps(pos[:, ISL - 1], [w.BOX] * w.DIM, w.CUTOFF)[0]
    one = [(pos[:, :ISL + 1], ptype)]
    two = [_pushforward_sample(5), _pushforward_sample(6)]
    (tmp / "cli").mkdir()
    src = make_synthetic_dataset(str(tmp), name="RPF", n_particles=512, dim=3, box=1.0,
                                 radius=0.09, seq_len_train=12, seq_len_eval=7, n_trajs=2)
    argv = [f"config={_cli_yaml(str(tmp / 'cli'), src)}", "gpu=-1", "mode=all",
            "parallel.spatial=4"]
    jobs = {
        "gns4": ("forward", dict(n_space=4, model="gns", params=gp, pos=pos, ptype=ptype,
                                 k_cap=k_cap)),
        "gns3": ("forward", dict(n_space=3, model="gns", params=gp, pos=pos, ptype=ptype,
                                 k_cap=k_cap)),
        "gns2": ("forward", dict(n_space=2, model="gns", params=gp, pos=pos, ptype=ptype,
                                 k_cap=k_cap)),
        "painn4": ("forward", dict(n_space=4, model="painn", params=pp, pos=pos, ptype=ptype,
                                   k_cap=k_cap)),
        "step_gns": ("train_step", dict(n_space=4, model="gns", params=gp, samples=one,
                                        k_cap=k_cap)),
        "step_painn": ("train_step", dict(n_space=4, model="painn", params=pp, samples=one,
                                          k_cap=k_cap)),
        "step_dp": ("train_step", dict(n_space=2, n_data=2, model="gns", params=gp,
                                       samples=two, k_cap=k_cap, unroll=1)),
        "rollout": ("rollout", dict(n_space=4, params=gp, pos=pos, ptype=ptype)),
        "overflow": ("rollout", dict(n_space=4, params=gp, pos=pos, ptype=ptype,
                                     caps=(2, 2))),
        "drift": ("rollout", dict(n_space=4, params=gp, pos=pos, ptype=ptype,
                                  drift_share=0.42, chunk=4)),
        "loop": ("train_loop", dict(n_space=2, batch=2, params=gp,
                                    store_ckp=str(tmp / "loop_rank{rank}"))),
        "cli": ("cli_run", dict(argv=argv)),
    }
    names = list(jobs)
    context = w.start_ranks(list(jobs.values()), str(tmp))
    try:
        refs = {
            "gns4": _jax_forward("gns", gp, pos, ptype, k_cap),
            "painn4": _jax_forward("painn", pp, pos, ptype, k_cap),
            "step_gns": _jax_train_step(gp, one[0], k_cap),
            "unsharded": w.unsharded("gns", gp, pos, ptype),
            "step_painn": w.train_step(1, "painn", pp, one, k_cap),
            "step_dp": w.train_step(1, "gns", gp, two, k_cap, n_data=1, unroll=1),
            "rollout": w.unsharded_rollout(gp, pos, ptype),
            "loop": w.train_loop(1, 2, gp),
        }
    finally:
        ranks = w.join_ranks(context, str(tmp))
    by_job = {name: [ranks[r][i] for r in range(4)] for i, name in enumerate(names)}
    return by_job, refs, {"tmp": tmp, "pos": pos, "ptype": ptype, "gns": gns}


def _close(got, want, tol=TOL, what=""):
    top = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * top, f"{what}: {err:.3g} > {tol} x {top:.3g}"


def test_gns_forward_on_a_ring_of_4_equals_jax(runs):
    """Four gloo ranks against JAX's ``build_spatial_gns_forward`` on four
    virtual devices: every particle's acceleration within 1e-10 of the
    largest."""
    by_job, refs, _ = runs
    _close(_assemble(by_job["gns4"]), refs["gns4"], what="gns ring 4")


@pytest.mark.parametrize("job", ["gns3", "gns2"])
def test_gns_forward_on_rings_of_3_and_2_equals_unsharded(runs, job):
    """A ring of 3 (a subgroup of the four ranks; the fourth does no work)
    and of 2 (the degenerate periodic frame) against the port's unsharded
    GNS on its own neighbor list, within 1e-10 of the largest value."""
    by_job, refs, _ = runs
    n = int(job[-1])
    assert all(r is None for r in by_job[job][n:])
    _close(_assemble(by_job[job]), refs["unsharded"], what=job)


def test_painn_forward_on_a_ring_of_4_equals_jax(runs):
    """PaiNN on four ranks (K5's plain version gathering from the slab and
    its two halo slabs, 3 N_loc rows) against JAX's
    ``build_spatial_painn_forward``, within 1e-10 of the largest value."""
    by_job, refs, _ = runs
    _close(_assemble(by_job["painn4"]), refs["painn4"], what="painn ring 4")


def _check_step(got_ranks, want, n_ranks):
    for got in got_ranks[:n_ranks]:
        assert not got["overflow"]
        assert got["loss"] == pytest.approx(want["loss"], rel=TOL, abs=0)
        assert set(got["grads"]) == set(want["grads"])
        top = max(float(np.abs(v).max()) for v in want["grads"].values())
        for k, v in want["grads"].items():
            err = float(np.abs(got["grads"][k] - v).max())
            assert err <= TOL * top, f"{k}: {err:.3g} > {TOL} x {top:.3g}"
    some = max(float(np.abs(v).max()) for v in want["grads"].values())
    assert some > 0


def test_gns_train_step_on_a_ring_of_4_equals_jax(runs):
    """Loss and every gradient (the halo's backward sends the sender
    cotangents home; the particle count is summed outside autograd) against
    JAX's ``build_spatial_gns_train_step`` on four devices, standard layout,
    within 1e-10 of the largest value; all four ranks hold the sums."""
    by_job, refs, _ = runs
    _check_step(by_job["step_gns"], refs["step_gns"], 4)


def test_painn_train_step_on_a_ring_of_4_equals_one_rank(runs):
    by_job, refs, _ = runs
    _check_step(by_job["step_painn"], refs["step_painn"], 4)


def test_data_space_step_equals_one_rank(runs):
    """A (2, 2) (data, space) mesh, two samples with one pushforward unroll,
    against the same batch on one rank."""
    by_job, refs, _ = runs
    _check_step(by_job["step_dp"], refs["step_dp"], 4)


@pytest.mark.parametrize("job", ["rollout", "overflow", "drift"])
def test_spatial_rollout_equals_unsharded(runs, job):
    """``spatial_rollout`` of 5 steps on four ranks, walls forced to the
    ground truth, against the port's unsharded rollout: positions within
    1e-9, on every rank. ``overflow`` starts at caps of 2 (neighbors and
    cell slots), escalates and reruns its chunk; ``drift`` narrows the
    margin, so chunks rerun shorter and the slabs re-partition between the
    chunks that are kept."""
    by_job, refs, _ = runs
    for got in by_job[job]:
        _close(got["preds"], refs["rollout"], tol=POS_TOL, what=job)
    chunks = by_job[job][0]["chunks"]  # (steps, overflow, drift) of every run
    kept = [c for c in chunks if not c[1] and not (c[2] and c[0] > 1)]
    assert sum(steps for steps, _, _ in kept) == STEPS
    if job == "overflow":
        assert by_job[job][0]["escalations"] and chunks[0][1] and len(kept) == 1
    elif job == "drift":
        assert any(c[2] and c[0] > 1 for c in chunks) and len(kept) > 1
    else:
        assert not by_job[job][0]["escalations"] and chunks == [(STEPS, False, False)]


def test_train_spatial_on_2x2_equals_one_rank(runs):
    """``train_spatial`` at batch 2 on a (2, 2) mesh, 3 steps with noise and a
    pushforward unroll from step 1: the losses and the final parameters equal
    the one-rank loop's within 1e-10; only rank 0 writes, a standard-layout
    checkpoint that JAX's ``load_checkpoint`` and the port's ``infer`` read."""
    from lagrangebench_torch.evaluate import infer

    by_job, refs, paths = runs
    want = refs["loop"]
    for got in by_job["loop"]:
        assert len(got["losses"]) == len(want["losses"]) == 3 and got["count"] == 3
        _close(got["losses"], want["losses"], what="losses")
        top = max(float(np.abs(v).max()) for v in want["params"].values())
        for k, v in want["params"].items():
            assert float(np.abs(got["params"][k] - v).max()) <= TOL * top, k
    tmp = paths["tmp"]
    assert [os.path.exists(tmp / f"loop_rank{r}") for r in range(4)] == [True] + [False] * 3
    ckp = tmp / "loop_rank0"
    params, _, opt, step = jax_load_checkpoint(str(ckp))
    assert step == 2 and "Dense_0" in params and not any(k.startswith("mp0_") for k in params)
    assert opt is not None
    train_d, valid_d = w.loop_data()
    from lagrangebench_torch.case import case_builder

    case = case_builder([w.BOX] * w.DIM, valid_d.metadata, ISL, cfg_model=w.model_cfg("gns"),
                        noise_std=0.0, dtype=torch.float64, device="cpu")
    metrics = infer(w.seeded_model("gns", seed=1), case, valid_d, load_ckp=str(ckp),
                    n_rollout_steps=3, device="cpu", cfg_eval_infer={"metrics": ["mse"]})
    assert all(np.isfinite(m["mse"]).all() for m in metrics.values())


def test_cli_mode_all_on_a_ring_of_4(runs):
    """``cli.main`` with ``mode=all parallel.spatial=4 gpu=-1`` under the
    launcher's environment on four ranks: one checkpoint directory in the
    standard layout; rank 0 prints the metrics, every rank returns them."""
    by_job, _, paths = runs
    results = by_job["cli"]
    ckp_root = paths["tmp"] / "cli" / "ckp"
    made = os.listdir(ckp_root)
    assert len(made) == 1 and made[0].startswith("gns_"), made
    params, _, _, _ = jax_load_checkpoint(str(ckp_root / made[0]))
    assert "MLP_1" in params and "Dense_0" in params
    metrics = results[0]["metrics"]
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    assert all(r["metrics"] == metrics for r in results)
    assert "Training done" in results[0]["stdout"] and str(metrics) in results[0]["stdout"]
    assert all(r["stdout"] == "" for r in results[1:])
