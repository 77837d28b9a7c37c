"""Data parallelism in the port (``lagrangebench_torch.parallel``) on the CPU:
two gloo ranks against one rank.

One module fixture spawns two ranks once (``tests/_torch_dp_worker.py``,
which imports no JAX) and runs every job there: training of a small float64
GNS with each processor (the fused one on its plain path), a forced
overflow in rank 1's rows, ``infer`` on a sharded and on a fallback batch,
and ``cli.main`` under the launcher's environment (``mode=all``,
``gpu=-1``, a ``wandb`` stub). The one-rank references run in this
process. A run on two ranks is the run on one rank up to the order of the
sums: float64 losses and parameters within 1e-12 of the largest value.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from lagrangebench_tpu.data.dataset import get_dataset_name_from_path as jax_dataset_name
from lagrangebench_torch import cli
from lagrangebench_torch.data.synthetic import make_synthetic_dataset

from . import _torch_dp_worker as w

TOL = 1e-12


def _yaml(root, src, **extra):
    text = (
        "extends: LAGRANGEBENCH_DEFAULTS\n"
        f"dataset:\n  src: {src}\n"
        "model:\n  name: gns\n  num_mp_steps: 2\n  latent_dim: 16\n  input_seq_length: 4\n"
        "train:\n  batch_size: 2\n  step_max: 2\n"
        "  pushforward:\n    steps: [-1, 0]\n    unrolls: [0, 1]\n    probs: [0, 1]\n"
        f"eval:\n  n_rollout_steps: 3\n  rollout_dir: {root}/rollouts\n"
        "  train:\n    n_trajs: 2\n    batch_size: 2\n"
        "  infer:\n    batch_size: 2\n    metrics: [mse, e_kin, sinkhorn]\n    out_type: pkl\n"
        f"logging:\n  log_steps: 1\n  eval_steps: 2\n  ckp_dir: {root}/ckp\n  wandb: true\n"
        "neighbors:\n  backend: auto\n"
    )
    for key, value in extra.items():
        text += f"{key}: {value}\n"
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The one-rank references on one thread, as each spawned rank runs:
    at these sizes more threads only contend with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job on two spawned ranks; returns (rank results, paths)."""
    tmp = tmp_path_factory.mktemp("dp")
    src = make_synthetic_dataset(str(tmp), name="RPF", n_particles=27, dim=3, box=1.0,
                                 seq_len_train=12, seq_len_eval=7, n_trajs=2)
    argv = {}
    for name in ("cli", "cli_b1"):
        (tmp / name).mkdir()
        argv[name] = [f"config={_yaml(str(tmp / name), src)}", "gpu=-1", "mode=all",
                      "parallel.data=-1"]
    jobs = [
        ("train", {"processor": "standard", "profile_dir": str(tmp / "prof")}),
        ("train", {"processor": "fused"}),
        ("train", {"processor": "fused", "overflow_at": 3}),
        ("infer_run", {"batch_size": 2, "rollout_dir": str(tmp / "b2_rank{rank}")}),
        ("infer_run", {"batch_size": 3, "rollout_dir": str(tmp / "b3_rank{rank}")}),
        ("cli_run", {"argv": argv["cli"]}),
        ("cli_run", {"argv": argv["cli_b1"] + ["train.batch_size=1", "eval.infer.batch_size=1"]}),
    ]
    ranks = w.run_ranks(jobs, str(tmp))
    return ranks, {"tmp": tmp, "src": src, "cli_root": tmp / "cli"}


def _check_params(got, want):
    top = max(float(np.abs(v).max()) for v in want.values())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL * top, err_msg=k)


def _check_tree(got, want, path):
    """Nested metric dicts equal within 1e-12 relative."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _check_tree(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=0, err_msg=path)


@pytest.mark.parametrize("job,processor", [(0, "standard"), (1, "fused")])
def test_two_ranks_train_as_one(runs, job, processor):
    """3 steps at batch 4 with noise and one pushforward unroll: the two
    ranks' losses and parameters equal the one-rank run's within 1e-12 of
    the largest value, and the ranks end bit-identical."""
    ranks, _ = runs
    one = w.train(None, processor)
    r0, r1 = ranks[0][job], ranks[1][job]
    assert r0["count"] == r1["count"] == one["count"] == 3
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=0,
                               atol=TOL * max(map(abs, one["losses"])))
    assert r0["losses"] == r1["losses"]
    _check_params(r0["params"], one["params"])
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k], err_msg=k)


def test_overflow_in_rank_1_retries_on_both_ranks(runs):
    """An overflow forced in global sample 3 (rank 1's second row) at step 1:
    both ranks reallocate from sample 3 once and retry the batch, as the
    one-rank run does; the result equals the one-rank run's."""
    ranks, _ = runs
    one = w.train(None, "fused", overflow_at=3)
    assert len(one["realloc"]) == 1 and len(one["losses"]) == 4 and one["count"] == 3
    for rank in ranks:
        got = rank[2]
        assert got["count"] == 3 and len(got["losses"]) == 4
        assert len(got["realloc"]) == 1
        np.testing.assert_array_equal(got["realloc"][0], one["realloc"][0])
        _check_params(got["params"], one["params"])
    window = w.data()[0]
    assert any(np.array_equal(one["realloc"][0], window[i][0]) for i in range(len(window)))


@pytest.mark.parametrize("job,batch", [(3, 2), (4, 3)], ids=["sharded", "fallback"])
def test_sharded_infer_equals_one_rank(runs, job, batch):
    """``infer`` over 4 trajectories on two ranks: batch 2 shards (one
    trajectory per rank per batch), batch 3 rolls out whole on each rank
    (then a batch of 1). Every trajectory's metrics equal the one-rank
    run's within 1e-12 on both ranks; rank 0 writes the same pickles as the
    one-rank run, rank 1 none."""
    import pickle

    ranks, paths = runs
    ref_dir = paths["tmp"] / f"ref_b{batch}"
    want = w.infer_run(None, batch, str(ref_dir))
    assert len(want) == 4
    for rank in ranks:
        _check_tree(rank[job], want, "")
    assert not (paths["tmp"] / f"b{batch}_rank1").exists()
    rank0 = paths["tmp"] / f"b{batch}_rank0"
    for i in range(4):
        with open(rank0 / f"rollout_{i}.pkl", "rb") as f:
            got = pickle.load(f)
        with open(ref_dir / f"rollout_{i}.pkl", "rb") as f:
            ref = pickle.load(f)
        np.testing.assert_allclose(got["predicted_rollout"], ref["predicted_rollout"],
                                   rtol=0, atol=TOL)
    assert len([n for n in os.listdir(rank0) if n.startswith("metrics")]) == 1


def test_cli_under_the_launcher(runs, tmp_path):
    """``cli.main`` on two gloo ranks under the launcher's environment
    (``mode=all gpu=-1 parallel.data=-1``): one checkpoint directory,
    named by the dataset's short name; only rank 0 prints; rank 0's
    metrics equal the one-rank run's (float32 parameters: rtol 1e-6)."""
    ranks, paths = runs
    runs_made = os.listdir(paths["cli_root"] / "ckp")
    assert len(runs_made) == 1 and runs_made[0].startswith("gns_rpf3d_"), runs_made
    run_dir = paths["cli_root"] / "ckp" / runs_made[0]
    for name in ("config.yaml", "params.npz", "opt_state.npz", "best/params.npz"):
        assert (run_dir / name).exists(), name
    assert ranks[1][5]["metrics"] == ranks[0][5]["metrics"]
    assert ranks[1][5]["stdout"] == ""
    assert "Training done" in ranks[0][5]["stdout"]
    assert str(ranks[0][5]["metrics"]) in ranks[0][5]["stdout"]

    argv = [f"config={_yaml(str(tmp_path), paths['src'])}", "gpu=-1", "mode=all"]
    want = w.cli_run(argv, {})
    got = ranks[0][5]["metrics"]
    assert set(got) == set(want["metrics"])
    for key in got:
        np.testing.assert_allclose(got[key], want["metrics"][key], rtol=1e-6, err_msg=key)


def test_wandb_only_on_rank_0(runs):
    """Under two ranks only rank 0 calls ``wandb.init`` (once) and ``log``
    (every log step and the eval); ``dataset_name`` is the JAX package's
    short name of the directory."""
    ranks, paths = runs
    calls0, calls1 = ranks[0][5]["wandb"], ranks[1][5]["wandb"]
    assert calls1 == []
    assert calls0[0] == ("init", jax_dataset_name(paths["src"])) == ("init", "rpf3d")
    assert [c for c in calls0 if c[0] == "log"] == [("log", 0), ("log", 1), ("log", 2),
                                                    ("log", 2)]
    assert calls0[-1] == ("finish", None)


def test_parallel_data_2_in_one_process_runs_alone(tmp_path):
    """``parallel.data=2`` without a launcher runs on this process alone and
    equals ``parallel.data=1``, as the JAX runner does on one device."""
    metrics = {}
    for n in (1, 2):
        root = tmp_path / str(n)
        root.mkdir()
        src = make_synthetic_dataset(str(root), name="RPF", n_particles=27, dim=3, box=1.0,
                                     seq_len_train=12, seq_len_eval=7, n_trajs=2)
        argv = [f"config={_yaml(str(root), src)}", "gpu=-1", f"parallel.data={n}",
                "logging.wandb=false"]
        with contextlib.redirect_stdout(io.StringIO()):
            metrics[n] = cli.main(argv)
    assert metrics[1] == metrics[2]


def test_profiler_hook_writes_a_trace_per_rank(runs, tmp_path):
    """``logging.profile_dir`` with ``profile_steps=[1, 2]``: a CPU run writes
    ``trace_rank0.json`` holding the train step's ops (the model's products,
    the backward, AdamW's foreach ops); under two ranks each rank writes its
    own file, which also holds the gradient all-reduce."""
    w.train(None, "standard", profile_dir=str(tmp_path))
    assert os.listdir(tmp_path) == ["trace_rank0.json"]
    names = _trace_names(tmp_path / "trace_rank0.json")
    for op in ("aten::mm", "aten::_foreach_add_", "autograd::engine::evaluate_function"):
        assert any(op in n for n in names), op
    _, paths = runs
    assert sorted(os.listdir(paths["tmp"] / "prof")) == ["trace_rank0.json", "trace_rank1.json"]
    for rank in range(2):
        names = _trace_names(paths["tmp"] / "prof" / f"trace_rank{rank}.json")
        assert any("all_reduce" in n for n in names), rank


def _trace_names(path):
    with open(path) as f:
        return {ev.get("name", "") for ev in json.load(f)["traceEvents"]}


def test_rank_beyond_the_mesh_does_no_work(runs):
    """Two launched ranks at ``train.batch_size=1``: the mesh is cut to one
    rank, so rank 1 says that the mesh left it out and returns None, and
    rank 0 trains and infers alone (one checkpoint directory)."""
    ranks, paths = runs
    left_out = ranks[1][6]
    assert left_out["metrics"] is None and left_out["wandb"] == []
    assert left_out["stdout"].startswith("rank 1: the data mesh holds ranks 0-0")
    assert set(ranks[0][6]["metrics"]) == set(ranks[0][5]["metrics"])
    assert len(os.listdir(paths["tmp"] / "cli_b1" / "ckp")) == 1
