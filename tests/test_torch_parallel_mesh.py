"""The port's mesh helpers (``lagrangebench_torch.parallel``), process-group
setup and the runner's device per rank, in one process, and the dataset's
short name, against the JAX package.

* The mesh sizing equals the JAX runner's (``lagrangebench_tpu/runner.py``,
  driven up to its ``Trainer`` with stubs in place of data, case and model
  and ``jax.devices`` returning the world's devices) for every
  ``parallel.data`` in {-1, 1, 2, 3, 4}, world size in {1, 2, 4} and batch
  size in {1, 2, 3, 4, 6}.
* ``init_distributed`` mirrors the JAX package's four tests
  (``tests/test_sharding.py``) with the launcher's variables in place of
  the TPU ones.
* ``get_dataset_name_from_path`` equals JAX's for the seven published
  dataset directories and, with its warning, for a name outside the
  convention.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import lagrangebench_tpu.parallel as jax_parallel
from lagrangebench_tpu import runner as jax_runner
from lagrangebench_tpu.config import merge as jax_merge
from lagrangebench_tpu.data.dataset import URLS
from lagrangebench_tpu.data.dataset import get_dataset_name_from_path as jax_name
from lagrangebench_tpu.defaults import defaults as jax_defaults
from lagrangebench_torch import runner
from lagrangebench_torch.data import ArrayDataset, H5Dataset, get_dataset_name_from_path
from lagrangebench_torch.data.synthetic import make_synthetic_arrays, make_synthetic_dataset
from lagrangebench_torch.parallel import (
    Mesh, data_parallel_size, init_distributed, make_mesh, make_mesh_2d, shard_batch,
)

LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
               "LOCAL_WORLD_SIZE")


class _Stop(Exception):
    pass


class _Data:
    """What the JAX runner reads of a split before it builds the mesh."""

    metadata = {"bounds": [[0.0, 1.0]] * 3}
    external_force_fn = None
    name = "syn"

    def __getitem__(self, i):
        return np.zeros((8, 3, 3)), np.zeros(8, np.int32)


def _jax_mesh_size(monkeypatch, tmp_path, parallel_data, world, batch_size):
    """The mesh size the JAX runner builds (1 for no mesh), read from the
    ``mesh`` it hands its ``Trainer``."""
    ds = _Data()

    def trainer(*args, mesh=None, **kw):
        raise _Stop(1 if mesh is None else mesh)

    monkeypatch.setattr(jax, "devices", lambda *a: [object()] * world)
    monkeypatch.setattr(jax_parallel, "init_distributed", lambda *a, **k: 0)
    monkeypatch.setattr(jax_runner, "make_mesh", lambda n: n)
    monkeypatch.setattr(jax_runner, "check_cfg", lambda cfg: None)
    monkeypatch.setattr(jax_runner, "setup_data", lambda cfg: (ds, ds, ds))
    monkeypatch.setattr(jax_runner, "case_builder",
                        lambda **kw: types.SimpleNamespace(normalization_stats=None))
    monkeypatch.setattr(jax_runner, "setup_model", lambda *a, **kw: (None, None, None))
    monkeypatch.setattr(jax_runner, "save_yaml", lambda *a: None)
    monkeypatch.setattr(jax_runner, "Trainer", trainer)
    cfg = jax_merge(jax_defaults, {"mode": "train", "parallel": {"data": parallel_data},
                                   "train": {"batch_size": batch_size},
                                   "logging": {"ckp_dir": str(tmp_path), "run_name": "r"}})
    with pytest.raises(_Stop) as stop:
        jax_runner.train_or_infer(cfg)
    return stop.value.args[0]


@pytest.mark.parametrize("batch_size", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("parallel_data", [-1, 1, 2, 3, 4])
def test_mesh_sizing_equals_the_jax_runner(monkeypatch, tmp_path, parallel_data, world,
                                           batch_size):
    want = _jax_mesh_size(monkeypatch, tmp_path, parallel_data, world, batch_size)
    assert data_parallel_size(parallel_data, world, batch_size) == want


@pytest.fixture
def no_launch(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def test_init_distributed_single_process_noop(no_launch):
    """No explicit arguments and no launcher environment: no group, rank 0."""
    assert init_distributed() == 0
    assert not no_launch


def test_init_distributed_propagates_failures(monkeypatch):
    """An explicit launch whose group cannot form raises; it is not
    swallowed into a run alone."""
    def boom(**kw):
        raise RuntimeError("store unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="store unreachable"):
        init_distributed("tcp://127.0.0.1:1", world_size=2, rank=1, device="cpu")


def test_init_distributed_idempotent(monkeypatch, no_launch):
    """A process whose group exists returns its rank at once."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 3)
    assert init_distributed("tcp://127.0.0.1:1", world_size=4, rank=3) == 3
    assert not no_launch


def test_init_distributed_ignores_single_host_markers(monkeypatch, no_launch):
    """``LOCAL_RANK=0 LOCAL_WORLD_SIZE=1 WORLD_SIZE=1`` alone (what a
    single-process tool sets) is no launch; with ``MASTER_ADDR`` and
    ``RANK`` too it is one, over NCCL for CUDA ranks and gloo for CPU
    ranks."""
    for var, value in (("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "1"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(var, value)
    assert init_distributed() == 0
    assert not no_launch

    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("RANK", "0")

    def boom(**kw):
        no_launch.append(kw)
        raise RuntimeError("would initialize")

    monkeypatch.setattr(dist, "init_process_group", boom)
    for device, backend in (("cuda", "nccl"), ("cpu", "gloo")):
        with pytest.raises(RuntimeError, match="would initialize"):
            init_distributed(device=device)
        assert no_launch[-1]["backend"] == backend
        assert no_launch[-1]["init_method"] == "env://"


def test_mesh_in_one_process():
    """Without a group: a mesh of one over this process; more ranks than
    exist raise, for the 2D (data, space) mesh too, saying how to launch."""
    mesh = make_mesh(-1)
    assert (mesh.group, mesh.rank, mesh.size, mesh.member) == (None, 0, 1, True)
    with pytest.raises(ValueError, match="only 1 available"):
        make_mesh(2)
    with pytest.raises(ValueError, match="needs 2 ranks, 1 available.*torch.distributed.run"):
        make_mesh_2d(1, 2)


def test_shard_batch_takes_this_ranks_rows():
    """Each rank's contiguous rows of every leaf (numpy and torch, nested);
    the tree itself with no mesh or a mesh of one; a batch that does not
    split raises."""
    tree = {"a": np.arange(12).reshape(6, 2), "b": (torch.arange(6), [np.arange(6) * 2])}
    assert shard_batch(tree, None) is tree
    assert shard_batch(tree, Mesh(None, 0, 1)) is tree
    got = shard_batch(tree, Mesh(None, 2, 3))
    np.testing.assert_array_equal(got["a"], [[8, 9], [10, 11]])
    assert torch.equal(got["b"][0], torch.tensor([4, 5]))
    np.testing.assert_array_equal(got["b"][1][0], [8, 10])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(np.zeros(5), Mesh(None, 0, 2))


@pytest.mark.parametrize("gpu,env,want", [
    (None, {}, "cuda"), (-1, {}, "cpu"), (1, {}, "cuda:1"),
    (None, {"LOCAL_RANK": "3", "WORLD_SIZE": "4"}, "cuda:3"),
    (-1, {"LOCAL_RANK": "3", "WORLD_SIZE": "4"}, "cpu"),
    (0, {"LOCAL_RANK": "0", "WORLD_SIZE": "1"}, "cuda:0"),
    (1, {"LOCAL_RANK": "1", "WORLD_SIZE": "2"}, ValueError),
], ids=["default", "cpu", "gpu_k", "launched", "launched_cpu", "launched_one", "conflict"])
def test_rank_device(monkeypatch, gpu, env, want):
    """Under a launcher rank r runs on ``cuda:LOCAL_RANK`` unless ``gpu=-1``;
    ``gpu=k`` with several launched ranks names the conflict."""
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    if want is ValueError:
        with pytest.raises(ValueError, match="every rank on cuda:1"):
            runner.rank_device(gpu)
    else:
        assert runner.rank_device(gpu) == torch.device(want)


@pytest.mark.parametrize("url", sorted(URLS.values()), ids=sorted(URLS))
def test_dataset_name_equals_jax(url):
    path = os.path.join("datasets", os.path.basename(url)[: -len(".zip")])
    assert get_dataset_name_from_path(path) == jax_name(path)
    assert get_dataset_name_from_path(path + "/") == jax_name(path)


def test_dataset_name_outside_the_convention_warns():
    with pytest.warns(UserWarning, match="does not follow the lagrangebench convention"):
        want = jax_name("data/my_flows")
    with pytest.warns(UserWarning, match="does not follow the lagrangebench convention"):
        assert get_dataset_name_from_path("data/my_flows") == want == "my_flows"


def test_h5dataset_infers_the_short_name(tmp_path):
    """``H5Dataset`` with no name takes the short name, as JAX's does; an
    explicit name and ``ArrayDataset``'s stay as given."""
    src = make_synthetic_dataset(str(tmp_path), name="TGV", n_particles=8, dim=2, box=1.0,
                                 seq_len_train=8, seq_len_eval=8, n_trajs=1)
    assert H5Dataset("train", src, input_seq_length=2).name == "tgv2d" == jax_name(src)
    assert H5Dataset("train", src, name="mine", input_seq_length=2).name == "mine"
    splits, metadata = make_synthetic_arrays(n_particles=8, dim=2, box=1.0, seq_len_train=8,
                                             seq_len_eval=8, n_trajs=1, name="RPF")
    arrays = ArrayDataset("train", splits["train"], [np.zeros(8, np.int64)], metadata,
                          input_seq_length=2)
    assert arrays.name == "RPF"
