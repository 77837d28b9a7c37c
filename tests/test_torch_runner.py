"""Port parity: the runner and CLI (``python -m lagrangebench_torch``) on the
CPU against the JAX package's runner, on a small synthetic H5 dataset.

A JAX ``mode=train`` run of a small PaiNN makes a checkpoint; the port's CLI
(``gpu=-1 mode=infer load_ckp=<run>``, reading the run's own config.yaml)
prints the metrics dict that the JAX ``mode=infer`` returns on it, rtol
1e-5 (float32 models on both sides, the same checkpoint and test split).
The runs preprocess in float64 (``dtype: float64``): under the tests' x64
the JAX case takes velocities from float64 positions, and a float32 case
on the port's side would differ by the cancellation in those differences.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from lagrangebench_tpu import cli as jax_cli
from lagrangebench_tpu.data.synthetic import make_synthetic_dataset
from lagrangebench_torch import cli
from lagrangebench_torch.config import Config, load_with_extends, merge
from lagrangebench_torch.defaults import defaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ISL, STEPS = 4, 3


def _yaml(root, src, **extra):
    text = (
        "extends: LAGRANGEBENCH_DEFAULTS\n"
        "dtype: float64\n"
        f"dataset:\n  src: {src}\n"
        "model:\n  name: painn\n  num_mp_steps: 2\n  latent_dim: 16\n"
        f"  input_seq_length: {ISL}\n  isotropic_norm: true\n  magnitude_features: true\n"
        "train:\n  batch_size: 2\n  step_max: 2\n"
        "  pushforward:\n    steps: [-1]\n    unrolls: [0]\n    probs: [1]\n"
        f"eval:\n  n_rollout_steps: {STEPS}\n  rollout_dir: {root}/rollouts\n"
        "  train:\n    n_trajs: 1\n"
        "  infer:\n    batch_size: 2\n    metrics: [mse, e_kin, sinkhorn]\n    out_type: pkl\n"
        f"logging:\n  log_steps: 1\n  eval_steps: 2\n  ckp_dir: {root}/ckp\n"
        "neighbors:\n  backend: auto\n"
    )
    for key, value in extra.items():
        text += f"{key}: {value}\n"
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX-trained PaiNN checkpoint and the JAX infer metrics on it."""
    root = str(tmp_path_factory.mktemp("runner"))
    src = make_synthetic_dataset(root, n_particles=125, dim=3, box=1.0, seq_len_train=12,
                                 seq_len_eval=ISL + STEPS, n_trajs=2)
    cfg = _yaml(root, src)
    jax_cli.main([f"config={cfg}", "mode=train"])
    run_dir = os.path.join(root, "ckp", os.listdir(os.path.join(root, "ckp"))[0])
    # under the tests' x64 the JAX GaussianRBF keeps float64 widths/offset;
    # checkpoints written without x64 (and the port's parameters) hold
    # float32, so the saved trees are cast before both packages infer
    for path in (os.path.join(run_dir, "params.npz"), os.path.join(run_dir, "best", "params.npz")):
        with np.load(path) as data:
            leaves = {k: data[k].astype(np.float32) if data[k].dtype == np.float64 else data[k]
                      for k in data.files}
        np.savez(path, **leaves)
    metrics = jax_cli.main([f"load_ckp={run_dir}", "mode=infer"])
    return root, src, run_dir, metrics


def test_cli_infers_the_jax_checkpoint_with_the_jax_metrics(jax_run):
    """``python -m lagrangebench_torch gpu=-1 mode=infer load_ckp=<JAX run>``
    prints the JAX infer metrics: rtol 1e-5."""
    _, _, run_dir, want = jax_run
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "lagrangebench_torch", f"load_ckp={run_dir}", "mode=infer",
         "gpu=-1"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    got = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-12, err_msg=key)


def test_mode_all_then_restart(jax_run, tmp_path, capsys):
    """``mode=all`` on the port alone: finite losses, config.yaml,
    params.npz, best/ and rollout pickles; a restart with ``load_ckp=``
    (its saved config) gives the same metrics."""
    _, src, _, _ = jax_run
    cfg = _yaml(str(tmp_path), src)
    metrics = cli.main([f"config={cfg}", "gpu=-1"])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"train/loss: (\S+?)\.(?: |$)", out, re.M)]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    runs = os.listdir(tmp_path / "ckp")
    assert len(runs) == 1
    run_dir = tmp_path / "ckp" / runs[0]
    for name in ("config.yaml", "params.npz", "opt_state.npz", "best/params.npz"):
        assert (run_dir / name).exists(), name
    assert (tmp_path / "rollouts" / "rollout_0.pkl").exists()
    assert all(np.isfinite(v) for v in metrics.values())

    again = cli.main([f"load_ckp={run_dir}", "mode=infer", "gpu=-1"])
    assert "Loaded model from" in capsys.readouterr().out
    for key in metrics:
        np.testing.assert_allclose(again[key], metrics[key], rtol=1e-6, err_msg=key)


def test_vtk_output(jax_run, tmp_path):
    """``eval.infer.out_type=vtk`` writes predicted and reference frames."""
    _, _, run_dir, _ = jax_run
    cli.main([f"load_ckp={run_dir}", "mode=infer", "gpu=-1", "eval.infer.out_type=vtk",
              f"eval.rollout_dir={tmp_path}"])
    for name in ("rollout_0_0.vtk", f"rollout_1_{ISL + STEPS - 1}.vtk", "rollout_0_ref_0.vtk"):
        text = (tmp_path / name).read_text()
        assert text.startswith("# vtk DataFile Version 3.0") and "POINTS 125 float" in text


@pytest.mark.parametrize("argv,match", [
    (["model.latentdim=8"], "Unknown config key: model.latentdim"),
    ([], "config=... or load_ckp=..."),
    (["mode"], "not of the form key=value"),
], ids=["unknown_key", "no_config", "not_key_value"])
def test_cli_fails_cleanly(jax_run, argv, match):
    """Mistyped keys and a missing config= raise a ValueError that names
    the problem, before any work."""
    root = jax_run[0]
    if argv and argv[0].startswith("model."):
        argv = [f"config={os.path.join(root, 'cfg.yaml')}"] + argv
    with pytest.raises(ValueError, match=match):
        cli.main(argv)


@pytest.mark.parametrize("override,item", [
    ("parallel.data=2", "item 7"), ("parallel.spatial=2", "item 7"),
    ("logging.profile_dir=profile", "item 8"),
])
def test_unported_paths_name_their_roadmap_item(jax_run, override, item):
    root = jax_run[0]
    with pytest.raises(NotImplementedError, match=item):
        cli.main([f"config={os.path.join(root, 'cfg.yaml')}", "gpu=-1", override])


def test_haiku_checkpoint_is_not_ported(jax_run, tmp_path):
    (tmp_path / "params_array.npy").write_bytes(b"")
    root = jax_run[0]
    with pytest.raises(NotImplementedError, match="item 8"):
        cli.main([f"config={os.path.join(root, 'cfg.yaml')}", "gpu=-1", "mode=infer",
                  f"load_ckp={tmp_path}"])


def test_chip_smoke_config_is_the_shipped_painn_config():
    """The config dict chip_smoke.py carries (the card's machine has no
    PyYAML) equals configs/rpf_3d/painn.yaml resolved over the defaults."""
    sys.path.insert(0, REPO)
    import chip_smoke

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        want = load_with_extends("configs/rpf_3d/painn.yaml", defaults)
    finally:
        os.chdir(cwd)
    assert merge(defaults, Config(chip_smoke.PAINN_CONFIG)).to_dict() == want.to_dict()
