"""Port parity: the training path (noise, pushforward curriculum, the train
preprocess, the loss and its gradients, AdamW with its schedule, optimizer
state in checkpoints) against the JAX package, and the trainer's overflow
retry, on the CPU at small sizes.

The JAX side draws its noise from ``jax.random.normal``; the tests replace
that function with one returning a numpy draw, and hand the same draw to
the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lagrangebench_tpu import checkpoint as jax_ckp
from lagrangebench_tpu.case import case_builder as jax_case_builder
from lagrangebench_tpu.models import GNS as JaxGNS
from lagrangebench_tpu.models.base import make_model_fns
from lagrangebench_tpu.ops import space as jax_space
from lagrangebench_tpu.train import strats as jax_strats
from lagrangebench_tpu.train import trainer as jax_trainer
from lagrangebench_torch import checkpoint
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.config import Config
from lagrangebench_torch.data import ArrayDataset
from lagrangebench_torch.data.synthetic import make_synthetic_arrays
from lagrangebench_torch.models import GNS
from lagrangebench_torch.ops import fused_mp, space
from lagrangebench_torch.train import (
    AdamW, Trainer, add_gns_noise, exponential_decay, flat_mse_loss,
    push_forward_sample_steps,
)

ISL, DIM, N, LATENT, STEPS = 4, 3, 125, 16, 2
LOSS_WEIGHT = {"acc": 1.0, "vel": 0.0, "pos": 0.0}


def _fixed_normal(draw):
    """A stand-in for jax.random.normal returning ``draw``."""

    def normal(key, shape, dtype=jnp.float64):
        assert tuple(shape) == draw.shape[-3:], (shape, draw.shape)
        return jnp.asarray(draw, dtype=dtype)

    return normal


def _data():
    splits, metadata = make_synthetic_arrays(
        n_particles=N, dim=DIM, box=1.0, seq_len_train=12, seq_len_eval=12, n_trajs=2
    )
    pos = np.stack([t.transpose(1, 0, 2) for t in splits["train"]])  # (B, N, T, dim)
    ptype = np.zeros(pos.shape[:2], np.int32)
    ptype[0, :4] = 1  # walls: kinematic, no noise, no loss
    ptype[1, -6:] = -1  # padding
    return splits, metadata, pos, ptype


def _cases(metadata):
    kw = dict(box=[1.0] * DIM, metadata=metadata, input_seq_length=ISL, noise_std=3e-4)
    ref = jax_case_builder(cfg_neighbors={"backend": "pallas"}, dtype=jnp.float64, **kw)
    port = case_builder(cfg_neighbors={"backend": "auto"}, dtype=torch.float64,
                        device="cpu", **kw)
    return ref, port


def test_add_gns_noise_matches_jax(monkeypatch):
    """Random-walk noise with the same draw, kinematic and padded particles
    unmoved, target frames shifted by the last input frame's noise: 1e-12."""
    _, _, pos, ptype = _data()
    pos, ptype = pos[0, :, :ISL + 3], ptype[0]
    ptype = ptype.copy()
    ptype[-3:] = -1
    draw = np.random.default_rng(0).normal(size=(N, ISL - 1, DIM))
    monkeypatch.setattr(jax.random, "normal", _fixed_normal(draw))
    _, jshift = jax_space.periodic(jnp.asarray([1.0] * DIM))
    _, want = jax_strats.add_gns_noise(jax.random.PRNGKey(0), jnp.asarray(pos),
                                       jnp.asarray(ptype), ISL, 1e-2, jshift)
    _, shift = space.periodic(torch.tensor([1.0] * DIM, dtype=torch.float64))
    got = add_gns_noise(torch.as_tensor(pos), torch.as_tensor(ptype), ISL, 1e-2, shift,
                        draw=torch.as_tensor(draw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    kin = ptype != 0
    np.testing.assert_array_equal(got.numpy()[kin], pos[kin])


@pytest.mark.parametrize("step,cfg", [
    (0, {"steps": [-1, 3], "unrolls": [0, 1], "probs": [0, 1]}),
    (3, {"steps": [-1, 3], "unrolls": [0, 1], "probs": [0, 1]}),  # at the threshold
    (4, {"steps": [-1, 3], "unrolls": [0, 1], "probs": [0, 1]}),
    (7, {"steps": [-1, 2, 5], "unrolls": [0, 1, 2], "probs": [18, 2, 1]}),
    (7, {"steps": [-1, 2, 5], "unrolls": [0, 1, 3], "probs": [0, 0, 0]}),  # all zero
], ids=["first", "at_threshold", "unlocked", "three", "zero_probs"])
def test_push_forward_sample_steps_matches_jax(step, cfg):
    """The same numpy Generator gives the same unroll counts."""
    pf = Config(cfg)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    ours = [push_forward_sample_steps(a, step, pf) for _ in range(40)]
    theirs = [jax_strats.push_forward_sample_steps(b, step, pf) for _ in range(40)]
    assert ours == theirs
    if step <= 3 and cfg["steps"] == [-1, 3]:
        assert set(ours) == {0}
    if cfg["probs"] == [0, 0, 0]:
        assert set(ours) == {0, 1, 3}


@pytest.mark.parametrize("unroll", [0, 1])
def test_preprocess_batched_matches_jax(monkeypatch, unroll):
    """The train preprocess of a batch of 2 with the same noise draw: equal
    senders, features and targets within 1e-12 (float64)."""
    _, metadata, pos, ptype = _data()
    window = pos[:, :, : ISL + 2]
    draw = np.random.default_rng(1).normal(size=(N, ISL - 1, DIM))
    monkeypatch.setattr(jax.random, "normal", _fixed_normal(draw))
    ref, port = _cases(metadata)
    sample = (pos[0, :, :ISL], ptype[0])
    _, rn = ref.allocate_eval(sample)
    _, pn = port.allocate_eval(sample)
    rn_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), rn)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    _, rf, rt, rn_b = ref.preprocess_batched(keys, (window, ptype), 3e-4, rn_b, unroll)
    # under vmap the stand-in returns the same draw for both samples
    draw_b = torch.as_tensor(np.stack([draw, draw]))
    pf, pt, pn_b = port.preprocess_batched(None, (window, ptype), 3e-4, pn.broadcast(2),
                                           unroll, draw=draw_b)
    np.testing.assert_array_equal(pn_b.idx.numpy(), np.asarray(rn_b.idx))
    for k in ("vel_hist", "rel_disp", "rel_dist", "senders"):
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(rf[k]), rtol=0, atol=1e-12,
                                   err_msg=k)
    for k in ("acc", "vel", "pos"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(rt[k]), rtol=0, atol=1e-12,
                                   err_msg=k)


def _port_model(dtype="float64"):
    return GNS(DIM, node_in=(ISL - 1) * DIM, edge_in=DIM + 1, latent_size=LATENT,
               num_mp_steps=STEPS, compute_dtype=dtype, device="cpu")


def _flat_batch(port, pos, ptype, unroll=0):
    sample = (pos[0, :, :ISL], ptype[0])
    _, pn = port.allocate_eval(sample)
    draw = torch.as_tensor(np.random.default_rng(2).normal(size=(2, N, ISL - 1, DIM)))
    feats, targets, _ = port.preprocess_batched(None, (pos[:, :, : ISL + 1], ptype), 3e-4,
                                                pn.broadcast(2), unroll, draw=draw)
    non_kin = ~((ptype == 1) | (ptype == 2) | (ptype == -1))
    node_weight = (non_kin / np.maximum(non_kin.sum(1), 1)[:, None]).reshape(-1)
    return feats, targets, ptype.reshape(-1), node_weight


def test_train_step_loss_and_grads_match_jax():
    """flat_mse_loss and its gradient (the fused processor's backward)
    against jax.value_and_grad of the JAX flat_mse_loss on the same params
    and batch, float64: loss rtol 1e-12, gradients atol 1e-9."""
    _, metadata, pos, ptype = _data()
    _, port = _cases(metadata)
    feats, targets, flat_ptype, node_weight = _flat_batch(port, pos, ptype)

    jfeats = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    jmodel = JaxGNS(particle_dimension=DIM, latent_size=LATENT, num_mp_steps=STEPS,
                    use_fused_processor=True, compute_dtype="float64")
    init, apply = make_model_fns(jmodel)
    params, state = init(jax.random.PRNGKey(0), (jfeats, jnp.asarray(flat_ptype)))
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda x: np.asarray(x, np.float64) + 0.05 * rng.normal(size=x.shape), params
    )
    jtargets = {k: jnp.asarray(v.numpy()) for k, v in targets.items()}
    (loss_ref, _), grads_ref = jax.value_and_grad(jax_trainer.flat_mse_loss, has_aux=True)(
        params, state, jfeats, jnp.asarray(flat_ptype), jtargets, jnp.asarray(node_weight),
        apply, LOSS_WEIGHT,
    )

    model = _port_model().double()
    model.load_jax_params(params)
    loss = flat_mse_loss(model, feats, torch.as_tensor(flat_ptype), targets,
                         torch.as_tensor(node_weight), LOSS_WEIGHT)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-12)
    flat_ref = {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
        for path, g in jax.tree_util.tree_flatten_with_path(grads_ref)[0]
    }
    leaves = model.jax_leaves()
    assert [name for name, _, _ in leaves] == list(flat_ref)  # the JAX leaf order
    for name, p, transposed in leaves:
        g = p.grad.t() if transposed else p.grad
        np.testing.assert_allclose(g.numpy(), flat_ref[name], rtol=1e-7, atol=1e-9,
                                   err_msg=name)


def test_train_step_reaches_every_parameter_and_not_padded_slots(monkeypatch):
    """After one backward every parameter has a gradient, and no padded
    slot's gathered sender row receives one (exact zeros)."""
    _, metadata, pos, ptype = _data()
    _, port = _cases(metadata)
    feats, targets, flat_ptype, node_weight = _flat_batch(port, pos, ptype, unroll=0)
    model = _port_model("float32")
    seen = []
    real = fused_mp.gns_mp_step_autograd

    def spy(e, hs_gath, hr, h, mask, p, enc=None, latent=None):
        grads = {}
        hs_gath.register_hook(lambda g: grads.setdefault("g", g))
        seen.append((mask, grads))
        return real(e, hs_gath, hr, h, mask, p, enc, latent=latent)

    monkeypatch.setattr(fused_mp, "gns_mp_step_autograd", spy)
    loss = flat_mse_loss(model, {k: v.float() if v.is_floating_point() else v
                                 for k, v in feats.items()},
                         torch.as_tensor(flat_ptype), {k: v.float() for k, v in targets.items()},
                         torch.as_tensor(node_weight, dtype=torch.float32), LOSS_WEIGHT)
    loss.backward()
    assert [n for n, p in model.named_parameters() if p.grad is None] == []
    assert len(seen) == STEPS
    for mask, grads in seen:
        padded = mask == 0
        assert padded.any()
        assert torch.all(grads["g"][padded] == 0)


def test_adamw_three_steps_match_optax():
    """AdamW with the clamped exponential schedule against
    optax.adamw(optax.exponential_decay(...), weight_decay=1e-8), three
    steps, float32: params and moments rtol 1e-6, counts equal."""
    rng = np.random.default_rng(4)
    tree = {"b": rng.normal(size=(5,)).astype(np.float32),
            "a": rng.normal(size=(3, 4)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in tree.items()}
             for _ in range(3)]
    sched = dict(init_value=1e-2, transition_steps=2.0, decay_rate=0.5, end_value=6e-3)
    tx = optax.adamw(optax.exponential_decay(**sched), weight_decay=1e-8)
    jparams, jstate = {k: jnp.asarray(v) for k, v in tree.items()}, None
    jstate = tx.init(jparams)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)

    # "a" is stored transposed on the port side, as nn.Linear weights are
    pa = torch.nn.Parameter(torch.as_tensor(tree["a"]).t().contiguous())
    pb = torch.nn.Parameter(torch.as_tensor(tree["b"]))
    opt = AdamW([("a", pa, True), ("b", pb, False)], exponential_decay(**sched),
                weight_decay=1e-8)
    for g in grads:
        pa.grad = torch.as_tensor(g["a"]).t().contiguous()
        pb.grad = torch.as_tensor(g["b"])
        opt.step()
    np.testing.assert_allclose(pa.detach().t().numpy(), np.asarray(jparams["a"]), rtol=1e-6)
    np.testing.assert_allclose(pb.detach().numpy(), np.asarray(jparams["b"]), rtol=1e-6)
    ours, theirs = opt.state_leaves(), jax.tree.leaves(jstate)
    assert len(ours) == len(theirs) == 6
    assert int(ours[0]) == int(theirs[0]) == 3 and int(ours[-1]) == int(theirs[-1]) == 3
    for a, b in zip(ours[1:-1], theirs[1:-1]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-12)


def _opt_for(model, seed):
    opt = AdamW(model.jax_leaves(), exponential_decay(1e-3, 10.0, 0.1), weight_decay=1e-8)
    g = torch.Generator().manual_seed(seed)
    for p in opt.params:
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    return opt


def test_opt_state_roundtrip_jax_to_port(tmp_path):
    """A JAX checkpoint's opt_state.npz (optax.adamw after one update)
    resumes in the port: every moment lands on its parameter."""
    model = _port_model("float32")
    params = jax.tree.map(jnp.asarray, model.jax_params())
    tx = optax.adamw(optax.exponential_decay(1e-3, 10, 0.1), weight_decay=1e-8)
    state = tx.init(params)
    rng = np.random.default_rng(6)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), params)
    _, state = tx.update(grads, state, params)
    jax_ckp.save_checkpoint(str(tmp_path), params, {}, state, {"step": 1, "loss": None})

    _, _, leaves, step = checkpoint.load_checkpoint(str(tmp_path))
    assert step == 1
    opt = AdamW(model.jax_leaves(), exponential_decay(1e-3, 10.0, 0.1))
    opt.load_state_leaves(leaves)
    assert opt.count == 1
    mu = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_flatten_with_path(state[0].mu)[0]}
    for (name, _, transposed), m in zip(model.jax_leaves(), opt.mu):
        np.testing.assert_array_equal((m.t() if transposed else m).numpy(), mu[name])


def test_opt_state_roundtrip_port_to_jax(tmp_path):
    """The port's opt_state.npz restores into the JAX optax state
    (load_checkpoint + OptStateLeaves.restore) leaf for leaf."""
    model = _port_model("float32")
    opt = _opt_for(model, 7)
    checkpoint.save_checkpoint(str(tmp_path), model.jax_params(), {},
                               {"step": 1, "loss": None}, opt_state=opt.state_leaves())
    params, _, leaves, step = jax_ckp.load_checkpoint(str(tmp_path))
    assert step == 1
    tx = optax.adamw(optax.exponential_decay(1e-3, 10, 0.1), weight_decay=1e-8)
    restored = leaves.restore(tx.init(jax.tree.map(jnp.asarray, params)))
    assert int(restored[0].count) == 1 and int(restored[2].count) == 1
    nu = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
          for path, v in jax.tree_util.tree_flatten_with_path(restored[0].nu)[0]}
    for (name, _, transposed), v in zip(model.jax_leaves(), opt.nu):
        np.testing.assert_array_equal((v.t() if transposed else v).numpy(), nu[name])
    # and back into a fresh port optimizer
    again = AdamW(model.jax_leaves(), exponential_decay(1e-3, 10.0, 0.1))
    again.load_state_leaves(checkpoint.load_checkpoint(str(tmp_path))[2])
    for a, b in zip(again.state_leaves(), opt.state_leaves()):
        np.testing.assert_array_equal(a, b)


def _trainer(tmp_path=None, **cfg_train):
    splits, metadata = make_synthetic_arrays(
        n_particles=N, dim=DIM, box=1.0, seq_len_train=12, seq_len_eval=10, n_trajs=2
    )
    types = [np.zeros(N, np.int64)] * 2
    train = ArrayDataset("train", splits["train"], types, metadata, input_seq_length=ISL,
                         extra_seq_length=1)
    valid = ArrayDataset("valid", splits["valid"], types, metadata, input_seq_length=ISL,
                         extra_seq_length=3)
    case = case_builder([1.0] * DIM, metadata, ISL, cfg_neighbors={"backend": "auto"},
                        device="cpu")
    cfg = {"batch_size": 2, "noise_std": 3e-4,
           "pushforward": {"steps": [-1, 1], "unrolls": [0, 1], "probs": [0, 1]}}
    cfg.update(cfg_train)
    return Trainer(_port_model("float32"), case, train, valid, cfg_train=cfg,
                   cfg_eval={"n_rollout_steps": 3, "train": {"n_trajs": 1}},
                   cfg_logging={"log_steps": 1, "eval_steps": 2},
                   input_seq_length=ISL, device="cpu")


def test_overflowed_step_changes_nothing():
    """A step whose neighbor buffers overflowed commits nothing (parameters,
    moments, gradients), and reading its flag restores the step count and
    the noise generator."""
    tr = _trainer()
    pos, ptype = next(iter(tr.loader_train))
    raw = tr._batch((pos, ptype))
    _, _, nbrs = tr.case.allocate(tr.generator, (pos[0], ptype[0]))
    before = ([p.detach().clone() for p in tr.optimizer.params],
              [m.clone() for m in tr.optimizer.mu], tr.optimizer.count,
              tr.generator.get_state())
    bad = nbrs.broadcast(2)
    bad.did_buffer_overflow[1] = True  # sticky: the update keeps it set
    _, _, flag = tr.train_step(raw, bad, 3e-4, 1)
    assert tr._read_overflow([(flag, before[3], before[2])])
    assert all(torch.equal(a, b) for a, b in zip(before[0], tr.optimizer.params))
    assert all(torch.equal(a, b) for a, b in zip(before[1], tr.optimizer.mu))
    assert tr.optimizer.count == before[2]
    assert torch.equal(tr.generator.get_state(), before[3])
    assert all(p.grad is None for p in tr.optimizer.params)
    loss, _, flag = tr.train_step(raw, nbrs.broadcast(2), 3e-4, 1)
    assert not bool(flag) and torch.isfinite(loss) and tr.optimizer.count == 1
    assert not all(torch.equal(a, b) for a, b in zip(before[0], tr.optimizer.params))


def test_trainer_retries_after_overflow_and_checkpoints(tmp_path, monkeypatch, capsys):
    """train(): an overflow at step 1 reallocates once with boost x1.5 and
    retries; every step updates once; eval and the checkpoint (with its
    optimizer state) run at step 2, and a new trainer resumes from it."""
    tr = _trainer()
    real = tr.case.preprocess_batched
    calls = []

    def flaky(*args, **kw):
        feats, targets, nbrs = real(*args, **kw)
        calls.append(1)
        if len(calls) == 2:  # step 1, first attempt
            nbrs.did_buffer_overflow[:] = True
        return feats, targets, nbrs

    monkeypatch.setattr(tr, "case", tr.case._replace(preprocess_batched=flaky))
    ckp = str(tmp_path / "ckp")
    model, _, opt = tr.train(step_max=3, store_ckp=ckp)
    out = capsys.readouterr().out
    assert out.count("Reallocate neighbors list at step 1 (boost x1.50)") == 1
    assert opt.count == 4 and len(calls) == 5
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert os.path.exists(os.path.join(ckp, "opt_state.npz"))
    _, _, leaves, step = checkpoint.load_checkpoint(ckp)
    assert step == 2 and int(leaves.leaves[0]) == 3
    tr2 = _trainer()
    _, _, opt2 = tr2.train(step_max=2, load_ckp=ckp)
    assert opt2.count == 4  # resumed at step 2 with the saved count 3


def test_failed_eval_records_inf_and_training_continues(tmp_path, monkeypatch):
    """A rollout that fails during in-training eval records val/loss=inf in
    the checkpoint's metadata and training runs to the end."""
    import json

    from lagrangebench_torch.evaluate import RolloutOverflowError
    from lagrangebench_torch.train import trainer as trainer_mod

    def boom(*args, **kwargs):
        raise RolloutOverflowError("neighbor list kept overflowing during rollout")

    monkeypatch.setattr(trainer_mod, "eval_rollout", boom)
    ckp = str(tmp_path / "ckp")
    _, _, opt = _trainer().train(step_max=3, store_ckp=ckp)
    assert opt.count == 4
    with open(os.path.join(ckp, "metadata_ckp.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 2 and meta["loss"] == float("inf")


def test_adamw_skip_commits_only_where_the_flag_is_clear():
    """AdamW.step(skip=flag): a clear flag gives the plain step's bits; a
    set flag leaves parameters and moments as they were (the count
    advances; the trainer sets it back when it reads the flag)."""
    def opt_with_grads():
        model = _port_model("float32")
        opt = AdamW(model.jax_leaves(), exponential_decay(1e-3, 10.0, 0.1))
        g = torch.Generator().manual_seed(8)
        for p in opt.params:
            p.grad = torch.randn(p.shape, generator=g)
        return opt

    plain, kept, skipped = opt_with_grads(), opt_with_grads(), opt_with_grads()
    before = [p.detach().clone() for p in skipped.params]
    plain.step()
    kept.step(skip=torch.tensor(False))
    skipped.step(skip=torch.tensor(True))
    for a, b in zip(plain.params + plain.mu + plain.nu, kept.params + kept.mu + kept.nu):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(before, skipped.params))
    assert all(torch.count_nonzero(m) == 0 for m in skipped.mu + skipped.nu)


def test_deferred_step_with_forced_overflow_commits_nothing():
    """train_step with an overflowing neighbor buffer and a deferred read:
    nothing is committed, and the overflow comes back as a device flag,
    unread."""
    tr = _trainer(overflow_sync_every=4)
    pos, ptype = next(iter(tr.loader_train))
    raw = tr._batch((pos, ptype))
    _, _, nbrs = tr.case.allocate(tr.generator, (pos[0], ptype[0]))
    before = [p.detach().clone() for p in tr.optimizer.params]
    bad = nbrs.broadcast(2)
    bad.did_buffer_overflow[0] = True
    _, nbrs_b, flag = tr.train_step(raw, bad, 3e-4, 0)
    assert isinstance(flag, torch.Tensor) and bool(flag) and bool(nbrs_b.did_buffer_overflow[0])
    assert all(torch.equal(a, b) for a, b in zip(before, tr.optimizer.params))
    assert all(torch.count_nonzero(m) == 0 for m in tr.optimizer.mu)
    _, _, flag = tr.train_step(raw, nbrs.broadcast(2), 3e-4, 0)
    assert not bool(flag)
    assert not all(torch.equal(a, b) for a, b in zip(before, tr.optimizer.params))


def test_overflow_sync_every_skips_until_the_next_read(monkeypatch, capsys):
    """overflow_sync_every=3: an overflow at step 1 is not read until step
    3; steps 1 and 2 are skipped (sticky flag), step 3 restores the count
    and noise stream of step 1, reallocates with boost x1.5 and retries;
    steps 0, 3, 4 and 5 commit."""
    tr = _trainer(overflow_sync_every=3)
    tr.cfg_logging.log_steps = tr.cfg_logging.eval_steps = 100  # reads at sync steps only
    real = tr.case.preprocess_batched
    calls, states = [], []

    def flaky(generator, *args, **kw):
        states.append(generator.get_state().clone())
        feats, targets, nbrs = real(generator, *args, **kw)
        calls.append(1)
        if len(calls) == 2:  # step 1
            nbrs.did_buffer_overflow[:] = True
        return feats, targets, nbrs

    monkeypatch.setattr(tr, "case", tr.case._replace(preprocess_batched=flaky))
    reads = []
    real_read = tr._read_overflow
    monkeypatch.setattr(tr, "_read_overflow", lambda unread: reads.append(len(unread))
                        or real_read(unread))
    _, _, opt = tr.train(step_max=5)
    out = capsys.readouterr().out
    assert out.count("Reallocate neighbors list at step 3 (boost x1.50)") == 1
    assert len(calls) == 7  # steps 0-5 and the retry of step 3
    assert reads == [1, 3, 1, 2]  # steps 0, 3 (three unread), the retry, end of run
    assert opt.count == 4
    assert torch.equal(states[4], states[1])  # the retry draws step 1's noise
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())
