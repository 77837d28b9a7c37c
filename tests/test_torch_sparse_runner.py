"""Port parity through the runners: the sparse layout and a JAX-written
cell-list config.

* The port's runner, ``mode=all`` on the CPU (``gpu=-1``), trains the
  standard GNS processor on sparse edges (``neighbors.format: sparse``,
  backend ``auto``, which resolves to the cell list) and infers; the JAX
  runner's ``mode=infer`` on the port's checkpoint and the same dataset
  gives the port's metrics, rtol 1e-5.
* A ``config.yaml`` written by a JAX training run that kept the JAX
  default backend (``celllist``, dense layout) runs in the port as written
  (``load_ckp=<run> mode=infer gpu=-1``) and gives the JAX ``mode=infer``
  metrics on that checkpoint, rtol 1e-5.

* A sparse rollout whose edge buffer overflows reallocates with a boost
  and predicts what a rollout on a list sized right from the start does.

Both preprocess in float64 (``dtype: float64``), as the other runner tests.
``chip_smoke.py``'s copy of ``configs/WaterDrop_2d/gns.yaml`` (the card's
machine need not have PyYAML) equals the YAML over the defaults.
"""

import os
import sys

import numpy as np
import pytest

from lagrangebench_tpu import cli as jax_cli
from lagrangebench_tpu.data.synthetic import make_synthetic_dataset
from lagrangebench_torch import cli
from lagrangebench_torch.config import Config, load_with_extends, load_yaml, merge
from lagrangebench_torch.defaults import defaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ISL, STEPS = 4, 3


def _yaml(root, src, neighbors=""):
    text = (
        "extends: LAGRANGEBENCH_DEFAULTS\n"
        "dtype: float64\n"
        f"dataset:\n  src: {src}\n"
        "model:\n  name: gns\n  num_mp_steps: 2\n  latent_dim: 16\n"
        f"  input_seq_length: {ISL}\n"
        "train:\n  batch_size: 2\n  step_max: 2\n"
        "  pushforward:\n    steps: [-1]\n    unrolls: [0]\n    probs: [1]\n"
        f"eval:\n  n_rollout_steps: {STEPS}\n  rollout_dir: {root}/rollouts\n"
        "  train:\n    n_trajs: 1\n"
        "  infer:\n    batch_size: 2\n    metrics: [mse, e_kin, sinkhorn]\n    out_type: none\n"
        f"logging:\n  log_steps: 1\n  eval_steps: 2\n  ckp_dir: {root}/ckp\n"
        + neighbors
    )
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sparse_runner"))
    return make_synthetic_dataset(root, n_particles=125, dim=3, box=1.0, seq_len_train=12,
                                  seq_len_eval=ISL + STEPS, n_trajs=2)


def _run_dir(root):
    ckp = os.path.join(root, "ckp")
    (name,) = os.listdir(ckp)
    return os.path.join(ckp, name)


def _same_metrics(got, want):
    assert set(got) == set(want)
    for key in want:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-12, err_msg=key)


def test_port_sparse_mode_all_matches_jax_infer(dataset, tmp_path):
    """The port trains and infers on sparse edges; JAX infers the port's
    checkpoint with the port's metrics."""
    root = str(tmp_path)
    cfg = _yaml(root, dataset, "neighbors:\n  format: sparse\n")
    got = cli.main([f"config={cfg}", "gpu=-1", "mode=all"])
    run_dir = _run_dir(root)
    saved = load_yaml(os.path.join(run_dir, "config.yaml"))
    assert saved["neighbors"]["format"] == "sparse"
    want = jax_cli.main([f"config={cfg}", f"load_ckp={run_dir}", "mode=infer"])
    _same_metrics(got, want)


def test_jax_written_celllist_config_runs_as_written(dataset, tmp_path):
    """A JAX run's config.yaml keeps the JAX default backend, celllist; the
    port reads it unchanged and infers the JAX metrics."""
    root = str(tmp_path)
    jax_cli.main([f"config={_yaml(root, dataset)}", "mode=train"])
    run_dir = _run_dir(root)
    saved = load_yaml(os.path.join(run_dir, "config.yaml"))
    assert saved["neighbors"]["backend"] == "celllist"
    want = jax_cli.main([f"load_ckp={run_dir}", "mode=infer"])
    got = cli.main([f"load_ckp={run_dir}", "mode=infer", "gpu=-1"])
    _same_metrics(got, want)


def test_chip_smoke_waterdrop_config_is_the_shipped_one():
    sys.path.insert(0, REPO)
    import chip_smoke

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        want = load_with_extends("configs/WaterDrop_2d/gns.yaml", defaults)
    finally:
        os.chdir(cwd)
    got = merge(defaults, Config(chip_smoke.WATERDROP_CONFIG))
    assert got.to_dict() == want.to_dict()
    assert got.neighbors.backend == "celllist" and not got.model.fused_processor


def test_sparse_rollout_reallocates_after_overflow(capsys):
    """The rollout's retry on a sparse list: a buffer of a third of the
    edges overflows, is reallocated (boost x1.5, then larger) and gives the
    predictions of a list sized right."""
    import torch

    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.data.synthetic import make_synthetic_arrays
    from lagrangebench_torch.evaluate.rollout import _eval_batched_rollout
    from lagrangebench_torch.models import GNSStandard

    splits, meta = make_synthetic_arrays(n_particles=125, dim=3, box=1.0, seq_len_eval=ISL + 3,
                                         n_trajs=2)
    pos = torch.as_tensor(np.stack([t.transpose(1, 0, 2) for t in splits["test"]]))
    ptype = torch.zeros(pos.shape[:2], dtype=torch.int64)
    case = case_builder([1.0] * 3, meta, ISL, cfg_neighbors={"format": "sparse"},
                        dtype=torch.float64, device="cpu")
    model = GNSStandard(3, node_in=(ISL - 1) * 3, edge_in=4, latent_size=16, num_mp_steps=2,
                        compute_dtype="float64", device="cpu")
    preds = {}
    for boost in (1.0, 0.3):
        _, nbrs = case.allocate_eval((pos[0, :, :ISL], ptype[0]), capacity_boost=boost)
        assert nbrs.format == "sparse" and nbrs.backend == "celllist"
        preds[boost], _, _ = _eval_batched_rollout(
            model, case, (pos, ptype), nbrs, lambda p, t: {}, n_rollout_steps=3, t_window=ISL)
    assert "neighbor overflow; reallocating" in capsys.readouterr().out
    np.testing.assert_array_equal(preds[0.3].numpy(), preds[1.0].numpy())
