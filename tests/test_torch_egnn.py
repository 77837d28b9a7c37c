"""Port parity: EGNN (``models.EGNN``) against the JAX package's ``EGNN``
from one parameter tree, and the runner on an EGNN checkpoint of the JAX
runner.

Model: float64 on both sides (``compute_dtype="float64"``), periodic and
free boxes, padded sender slots (fill N: gathered clamped to row N-1 and
dropped from both sums), an external force in the free case. pos, vel and
acc within atol 1e-9 (the tolerance of ``tests/test_torch_gns.py``), and
the gradients of a position loss against ``jax.grad`` likewise.

Runner: a JAX ``mode=train`` run of a small EGNN (2 layers, latent 16,
the position loss of ``configs/*/egnn.yaml``) makes a checkpoint; the
port's runner (``gpu=-1 mode=infer``) gives the JAX ``mode=infer``
metrics on it, rtol 1e-5, as ``tests/test_torch_runner.py`` holds PaiNN;
then a port ``mode=all`` run trains from scratch with finite losses.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu import cli as jax_cli
from lagrangebench_tpu.data.synthetic import make_synthetic_dataset
from lagrangebench_tpu.models.egnn import EGNN as JaxEGNN
from lagrangebench_tpu.ops import space as jax_space
from lagrangebench_torch import cli
from lagrangebench_torch.config import Config, load_with_extends, merge
from lagrangebench_torch.defaults import defaults
from lagrangebench_torch.models import EGNN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, K, DIM, ISL, LATENT, STEPS, DT = 27, 8, 3, 4, 16, 2, 0.4


def _inputs(periodic, force, seed=0):
    rng = np.random.default_rng(seed)
    # positions near the walls too, so that the periodic wrap matters
    abs_pos = rng.uniform(0, 1, size=(N, ISL, DIM))
    senders = rng.integers(0, N, size=(N, K)).astype(np.int32)
    senders[rng.uniform(size=(N, K)) < 0.3] = N
    feats = {
        "abs_pos": abs_pos,
        "vel_hist": rng.normal(size=(N, (ISL - 1) * DIM)),
        "senders": senders,
        "receivers": np.broadcast_to(np.arange(N, dtype=np.int32)[:, None], (N, K)).copy(),
        "rel_dist": np.where((senders < N)[..., None], rng.uniform(0, 1, size=(N, K, 1)), 0.0),
    }
    if force:
        feats["force"] = rng.normal(size=(N, DIM))
    stats = {"mean": rng.normal(size=DIM) * 0.01, "std": rng.uniform(0.01, 0.05, size=DIM)}
    return feats, stats, rng.uniform(0, 1, size=(N, DIM))


def _jax_setup(periodic, force):
    feats, stats, target = _inputs(periodic, force)
    disp, shift = jax_space.periodic(jnp.ones(DIM)) if periodic else jax_space.free()
    model = JaxEGNN(hidden_size=LATENT, output_size=1, dt=DT, n_vels=ISL - 1,
                    displacement_fn=disp, shift_fn=shift,
                    velocity_stats={k: jnp.asarray(v) for k, v in stats.items()},
                    num_mp_steps=STEPS, compute_dtype="float64")
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.zeros(N, jnp.int32))
    params = jax.device_get(model.init(jax.random.PRNGKey(0), sample)["params"])
    # every leaf perturbed (zero biases matter too), float32 as checkpoints hold it
    params = jax.tree.map(
        lambda x: (x + 0.05 * np.random.default_rng(1).normal(size=x.shape)).astype(np.float32),
        params)
    return model, params, sample, feats, stats, target


def _port(params, stats, periodic, force):
    model = EGNN(LATENT, DT, ISL - 1, box=[1.0] * DIM if periodic else None,
                 velocity_stats={k: torch.as_tensor(v) for k, v in stats.items()},
                 num_mp_steps=STEPS, has_force=force, compute_dtype="float64", device="cpu")
    model.load_jax_params(params)
    return model


def _paths(tree):
    return ["/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


CASES = [(True, False), (False, True)]
IDS = ["periodic", "free_with_force"]


@pytest.mark.parametrize("periodic,force", CASES, ids=IDS)
def test_egnn_matches_jax_float64(periodic, force):
    model, params, sample, feats, stats, _ = _jax_setup(periodic, force)
    want = model.apply({"params": params}, sample)
    port = _port(params, stats, periodic, force)
    assert [leaf[0] for leaf in port.jax_leaves()] == _paths(params)
    with torch.no_grad():
        got = port({k: torch.as_tensor(v) for k, v in feats.items()}, torch.zeros(N))
    assert set(got) == {"pos", "vel", "acc"}
    for key in got:
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-9,
                                   err_msg=key)
    if periodic:
        assert (got["pos"] >= 0).all() and (got["pos"] < 1).all()


@pytest.mark.parametrize("periodic,force", CASES, ids=IDS)
def test_egnn_gradients_match_jax(periodic, force):
    """The position loss mean |pos - target|^2 and its gradient in every
    parameter against jax.grad (float64; atol 1e-9, rtol 1e-9)."""
    model, params, sample, feats, stats, target = _jax_setup(periodic, force)

    def loss(p):
        pos = model.apply({"params": p}, sample)["pos"]
        return jnp.mean(jnp.sum((pos - target) ** 2, axis=-1))

    wide = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    want_loss, grads = jax.value_and_grad(loss)(wide)
    want = dict(zip(_paths(grads), jax.tree_util.tree_leaves(grads)))
    port = _port(params, stats, periodic, force).double()
    pos = port({k: torch.as_tensor(v) for k, v in feats.items()}, torch.zeros(N))["pos"]
    got_loss = ((pos - torch.as_tensor(target)) ** 2).sum(-1).mean()
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-12)
    for path, p, transposed in port.jax_leaves():
        g = p.grad.t() if transposed else p.grad
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]), rtol=1e-9, atol=1e-9,
                                   err_msg=path)


RUN_STEPS = 3


def _yaml(root, src):
    text = (
        "extends: LAGRANGEBENCH_DEFAULTS\n"
        "dtype: float64\n"
        f"dataset:\n  src: {src}\n"
        "model:\n  name: egnn\n  num_mp_steps: 2\n  latent_dim: 16\n"
        f"  input_seq_length: {ISL}\n  isotropic_norm: true\n  magnitude_features: true\n"
        "train:\n  batch_size: 2\n  step_max: 2\n"
        "  loss_weight:\n    pos: 1.0\n    vel: 0.0\n    acc: 0.0\n"
        "  pushforward:\n    steps: [-1]\n    unrolls: [0]\n    probs: [1]\n"
        f"eval:\n  n_rollout_steps: {RUN_STEPS}\n  rollout_dir: {root}/rollouts\n"
        "  train:\n    n_trajs: 1\n"
        "  infer:\n    batch_size: 2\n    metrics: [mse, e_kin, sinkhorn]\n    out_type: none\n"
        f"logging:\n  log_steps: 1\n  eval_steps: 2\n  ckp_dir: {root}/ckp\n"
        "neighbors:\n  backend: auto\n"
    )
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX-trained EGNN checkpoint (float32 leaves) and the JAX infer
    metrics on it."""
    root = str(tmp_path_factory.mktemp("egnn_runner"))
    src = make_synthetic_dataset(root, n_particles=125, dim=3, box=1.0, seq_len_train=12,
                                 seq_len_eval=ISL + RUN_STEPS, n_trajs=2)
    cfg = _yaml(root, src)
    jax_cli.main([f"config={cfg}", "mode=train"])
    run_dir = os.path.join(root, "ckp", os.listdir(os.path.join(root, "ckp"))[0])
    for path in (os.path.join(run_dir, "params.npz"), os.path.join(run_dir, "best", "params.npz")):
        with np.load(path) as data:
            leaves = {k: data[k].astype(np.float32) for k in data.files}
        np.savez(path, **leaves)
    return root, cfg, run_dir, jax_cli.main([f"load_ckp={run_dir}", "mode=infer"])


def test_runner_infers_the_jax_egnn_checkpoint(jax_run):
    """The port's runner on the JAX run's checkpoint and config.yaml gives
    the JAX infer metrics (mse, e_kin, sinkhorn): rtol 1e-5."""
    _, _, run_dir, want = jax_run
    got = cli.main([f"load_ckp={run_dir}", "mode=infer", "gpu=-1"])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-12, err_msg=key)


def test_runner_mode_all(jax_run, tmp_path, capsys):
    """``mode=all`` on the port alone: finite losses, a checkpoint with the
    optimizer state, finite metrics."""
    _, cfg, _, _ = jax_run
    metrics = cli.main([f"config={cfg}", "gpu=-1", f"logging.ckp_dir={tmp_path}/ckp",
                        f"eval.rollout_dir={tmp_path}/rollouts"])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"train/loss: (\S+?)\.(?: |$)", out, re.M)]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    run_dir = tmp_path / "ckp" / os.listdir(tmp_path / "ckp")[0]
    for name in ("params.npz", "opt_state.npz", "best/params.npz"):
        assert (run_dir / name).exists(), name
    assert all(np.isfinite(v) for v in metrics.values())


def test_chip_smoke_config_is_the_shipped_egnn_config():
    """The config dict chip_smoke.py carries (the card's machine has no
    PyYAML) equals configs/rpf_3d/egnn.yaml resolved over the defaults."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        want = load_with_extends("configs/rpf_3d/egnn.yaml", defaults)
    finally:
        os.chdir(cwd)
    assert merge(defaults, Config(chip_smoke.EGNN_CONFIG)).to_dict() == want.to_dict()
