"""Port parity: SEGNN through the runner and the CLI.

Runner: a JAX ``mode=train`` run of a small SEGNN (2 layers, latent 8,
float64 preprocessing) on a synthetic 3D dataset whose particles are of
two types (a quarter of them walls) makes a checkpoint; the port's runner
(``gpu=-1 mode=infer``) builds a SEGNN whose node irreps carry the
``NodeType.SIZE x0e`` type one-hot (``homogeneous_particles`` from the
train split, as the JAX runner passes it) and gives the JAX ``mode=infer``
metrics on that checkpoint, rtol 1e-5, as ``tests/test_torch_egnn.py``
holds EGNN; then a port ``mode=all`` run trains from scratch with finite
losses.

Presets: every shipped ``configs/*/segnn.yaml`` builds the port's
SEGNN-10-64 for its dataset's dimension, boundaries, external force and
particle types, and one forward on a small dense input gives finite
accelerations of the right shape. ``chip_smoke.SEGNN_CONFIG`` equals
``configs/rpf_3d/segnn.yaml`` resolved over the defaults.
"""

import glob
import os
import re
import sys

import h5py
import numpy as np
import pytest
import torch

from lagrangebench_tpu import cli as jax_cli
from lagrangebench_tpu.data.synthetic import make_synthetic_dataset
from lagrangebench_torch import cli, runner
from lagrangebench_torch.config import Config, load_with_extends, merge
from lagrangebench_torch.defaults import defaults
from lagrangebench_torch.models import setup_model
from lagrangebench_torch.utils import NodeType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ISL, RUN_STEPS, N_PARTICLES = 4, 3, 125


def _yaml(root, src):
    text = (
        "extends: LAGRANGEBENCH_DEFAULTS\n"
        "dtype: float64\n"
        f"dataset:\n  src: {src}\n"
        "model:\n  name: segnn\n  num_mp_steps: 2\n  latent_dim: 8\n"
        f"  input_seq_length: {ISL}\n  isotropic_norm: true\n"
        "train:\n  batch_size: 2\n  step_max: 2\n"
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


def _two_types(src):
    """Mark the first quarter of every trajectory's particles as walls."""
    types = np.zeros(N_PARTICLES, np.int64)
    types[: N_PARTICLES // 4] = NodeType.SOLID_WALL
    for split in ("train", "valid", "test"):
        with h5py.File(os.path.join(src, f"{split}.h5"), "r+") as f:
            for name in f:
                del f[name]["particle_type"]
                f[name].create_dataset("particle_type", data=types)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX-trained SEGNN checkpoint (float32 leaves) on a two-type
    dataset and the JAX infer metrics on it."""
    root = str(tmp_path_factory.mktemp("segnn_runner"))
    src = make_synthetic_dataset(root, n_particles=N_PARTICLES, dim=3, box=1.0,
                                 seq_len_train=12, seq_len_eval=ISL + RUN_STEPS, n_trajs=2)
    _two_types(src)
    cfg = _yaml(root, src)
    jax_cli.main([f"config={cfg}", "mode=train"])
    run_dir = os.path.join(root, "ckp", os.listdir(os.path.join(root, "ckp"))[0])
    for path in (os.path.join(run_dir, "params.npz"), os.path.join(run_dir, "best", "params.npz")):
        with np.load(path) as data:
            leaves = {k: data[k].astype(np.float32) for k in data.files}
        np.savez(path, **leaves)
    return root, cfg, run_dir, jax_cli.main([f"load_ckp={run_dir}", "mode=infer"])


def test_runner_infers_the_jax_segnn_checkpoint(jax_run, monkeypatch):
    """The port's runner on the JAX run's checkpoint and config.yaml builds
    a SEGNN with the type one-hot and gives the JAX infer metrics (mse,
    e_kin, sinkhorn): rtol 1e-5."""
    _, _, run_dir, want = jax_run
    built = []

    def recording(*args, **kwargs):
        built.append(setup_model(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(runner, "setup_model", recording)
    got = cli.main([f"load_ckp={run_dir}", "mode=infer", "gpu=-1"])
    assert f"{NodeType.SIZE}x0e" in repr(built[0].node_features_irreps)
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


# the shipped presets: (dim, periodic, external force, one particle type)
PRESETS = {
    "configs/dam_2d/segnn.yaml": (2, False, True, False),
    "configs/ldc_2d/segnn.yaml": (2, False, False, False),
    "configs/ldc_3d/segnn.yaml": (3, False, False, False),
    "configs/rpf_2d/segnn.yaml": (2, True, True, True),
    "configs/rpf_3d/segnn.yaml": (3, True, True, True),
    "configs/tgv_2d/segnn.yaml": (2, True, False, True),
    "configs/tgv_2d_gen/segnn.yaml": (2, True, False, True),
    "configs/tgv_3d/segnn.yaml": (3, True, False, True),
}


def test_presets_are_every_shipped_segnn_config():
    shipped = glob.glob(os.path.join(REPO, "configs", "*", "segnn.yaml"))
    assert sorted(os.path.relpath(p, REPO) for p in shipped) == sorted(PRESETS)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_shipped_segnn_presets_build_and_run(preset):
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        cfg = load_with_extends(preset, defaults)
    finally:
        os.chdir(cwd)
    dim, periodic, force, homogeneous = PRESETS[preset]
    model = setup_model(cfg.model, {"periodic_boundary_conditions": [periodic] * dim},
                        has_external_force=force, device="cpu",
                        homogeneous_particles=homogeneous)
    assert repr(model.hidden_irreps) == "32x0e+32x1o" and len(model.layers) == 10
    n, k, n_vels = 12, 4, int(cfg.model.input_seq_length) - 1
    rng = np.random.default_rng(0)
    senders = torch.as_tensor(rng.integers(0, n + 1, size=(n, k)))
    rel_disp = torch.as_tensor(rng.uniform(-1, 1, size=(n, k, dim)), dtype=torch.float32)
    feats = {"vel_hist": torch.randn(n, n_vels * dim), "senders": senders,
             "receivers": torch.arange(n)[:, None].expand(n, k), "rel_disp": rel_disp,
             "rel_dist": rel_disp.norm(dim=-1, keepdim=True)}
    if not periodic:
        feats["bound"] = torch.rand(n, 2 * dim)
    if force:
        feats["force"] = torch.randn(n, dim)
    if cfg.model.magnitude_features:
        feats["vel_mag"] = torch.rand(n, n_vels)
    with torch.no_grad():
        acc = model(feats, torch.as_tensor(rng.integers(0, 2, size=n)))["acc"]
    assert acc.shape == (n, dim) and bool(torch.isfinite(acc).all())


def test_chip_smoke_config_is_the_shipped_segnn_config():
    """The config dict chip_smoke.py carries (the card's machine has no
    PyYAML) equals configs/rpf_3d/segnn.yaml resolved over the defaults."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        want = load_with_extends("configs/rpf_3d/segnn.yaml", defaults)
    finally:
        os.chdir(cwd)
    assert merge(defaults, Config(chip_smoke.SEGNN_CONFIG)).to_dict() == want.to_dict()
