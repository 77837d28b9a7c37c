"""Port parity: synthetic data, stats, datasets, loader, config and defaults
against the JAX package."""

import glob
import importlib
import os

import numpy as np
import pytest

from lagrangebench_tpu import config as jax_config
from lagrangebench_tpu.data import DataLoader as JaxDataLoader
from lagrangebench_tpu.data import H5Dataset as JaxH5Dataset
from lagrangebench_tpu.data import get_dataset_stats as jax_stats
from lagrangebench_tpu.data import synthetic as jax_synthetic
from lagrangebench_torch import config
from lagrangebench_torch.data import ArrayDataset, DataLoader, H5Dataset, get_dataset_stats
from lagrangebench_torch.data import synthetic

# the packages re-export their default Config under the module's name
defaults = importlib.import_module("lagrangebench_torch.defaults")
jax_defaults = importlib.import_module("lagrangebench_tpu.defaults")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_synthetic_trajectories_bit_equal():
    """_trajectory and _stats give bit-equal arrays from the same seed."""
    for seed in (0, 7, 201):
        a = synthetic._trajectory(15, 40, 3, 1.0, seed)
        b = jax_synthetic._trajectory(15, 40, 3, 1.0, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    trajs = [synthetic._trajectory(15, 40, 2, 2.0, s) for s in (1, 2)]
    assert synthetic._stats(trajs, 2.0, 2) == jax_synthetic._stats(trajs, 2.0, 2)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """One on-disk dataset written by the JAX package."""
    return jax_synthetic.make_synthetic_dataset(
        str(tmp_path_factory.mktemp("syn")), n_particles=27, dim=3, box=1.0,
        seq_len_train=20, seq_len_eval=17, n_trajs=2,
    )


def test_port_writes_the_same_dataset(dataset_dir, tmp_path):
    path = synthetic.make_synthetic_dataset(
        str(tmp_path), n_particles=27, dim=3, box=1.0, seq_len_train=20,
        seq_len_eval=17, n_trajs=2,
    )
    import h5py
    import json

    for split in ("train", "valid", "test"):
        with h5py.File(os.path.join(path, f"{split}.h5")) as a, h5py.File(
            os.path.join(dataset_dir, f"{split}.h5")
        ) as b:
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.array_equal(a[k]["position"][:], b[k]["position"][:])
                assert np.array_equal(a[k]["particle_type"][:], b[k]["particle_type"][:])
    with open(os.path.join(path, "metadata.json")) as fa, open(
        os.path.join(dataset_dir, "metadata.json")
    ) as fb:
        assert json.load(fa) == json.load(fb)


@pytest.mark.parametrize("isotropic", [False, True])
def test_noise_folded_stats(dataset_dir, isotropic):
    ds = H5Dataset("test", dataset_dir, input_seq_length=4, extra_seq_length=4)
    ours = get_dataset_stats(ds.metadata, isotropic, 3e-4)
    theirs = jax_stats(ds.metadata, isotropic, 3e-4)
    for k in ("acceleration", "velocity"):
        for s in ("mean", "std"):
            np.testing.assert_allclose(ours[k][s], np.asarray(theirs[k][s]), rtol=1e-15)


@pytest.mark.parametrize(
    "split,isl,extra", [("test", 4, 4), ("valid", 3, 14), ("train", 4, 2)]
)
def test_windows_match(dataset_dir, split, isl, extra):
    """Eval subsequence split and train windows, H5 and in-memory, equal the
    JAX dataset's; the loader collates the same batches."""
    ours = H5Dataset(split, dataset_dir, input_seq_length=isl, extra_seq_length=extra)
    theirs = JaxH5Dataset(split, dataset_dir, input_seq_length=isl, extra_seq_length=extra)
    assert len(ours) == len(theirs) > 0
    for i in range(len(theirs)):
        for a, b in zip(ours[i], theirs[i]):
            assert np.array_equal(a, b)
    import h5py

    with h5py.File(os.path.join(dataset_dir, f"{split}.h5")) as f:
        keys = sorted(f)
        trajs = [f[k]["position"][:] for k in keys]
        types = [f[k]["particle_type"][:] for k in keys]
    mem = ArrayDataset(split, trajs, types, ours.metadata, input_seq_length=isl,
                       extra_seq_length=extra)
    assert len(mem) == len(ours)
    for i in range(len(mem)):
        for a, b in zip(mem[i], ours[i]):
            assert np.array_equal(a, b)
    got = list(DataLoader(ours, batch_size=2))
    want = list(JaxDataLoader(theirs, batch_size=2))
    assert len(got) == len(want)
    for (pa, ta), (pb, tb) in zip(got, want):
        assert np.array_equal(pa, pb) and np.array_equal(ta, tb)


def test_loader_stops_early_without_hanging(dataset_dir):
    ds = H5Dataset("train", dataset_dir, input_seq_length=4, extra_seq_length=0)
    first = next(iter(DataLoader(ds, batch_size=1, num_prefetch=1)))
    assert first[0].shape == (1, 27, 5, 3)


def _same_backend(tree: dict) -> dict:
    """The one deliberate difference: the port's default backend is auto."""
    if tree["neighbors"]["backend"] == "celllist":
        tree["neighbors"]["backend"] = "auto"
    return tree


def test_defaults_tree_matches():
    assert defaults.defaults.neighbors.backend == "auto"
    assert defaults.defaults.to_dict() == _same_backend(jax_defaults.defaults.to_dict())


def test_every_config_resolves_like_the_jax_loader():
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
    assert paths
    jax_base = jax_config.merge(jax_defaults.defaults, {"neighbors": {"backend": "auto"}})
    cwd = os.getcwd()
    os.chdir(REPO)  # parent paths in `extends:` are repo-relative
    try:
        for path in paths:
            ours = config.load_with_extends(path, defaults.defaults)
            theirs = jax_config.load_with_extends(path, jax_base)
            assert ours.to_dict() == theirs.to_dict(), path
            defaults.check_cfg(config.merge(ours, {"dataset": {"src": "x"}}))
    finally:
        os.chdir(cwd)


def test_dotlist_and_backend_resolution():
    cfg = config.from_dotlist(["model.latent_dim=64", "neighbors.backend=auto", "a.b=[1, 2]"])
    assert cfg.to_dict() == jax_config.from_dotlist(
        ["model.latent_dim=64", "neighbors.backend=auto", "a.b=[1, 2]"]
    ).to_dict()
    for name in ("auto", "pallas", "cuda"):
        assert defaults.resolve_backend(name) == "cuda"
    for name, want in (("celllist", "celllist"), ("allpairs", "allpairs"),
                       ("jaxmd_vmap", "celllist")):
        assert defaults.resolve_backend(name) == want
    with pytest.raises(ValueError):
        defaults.resolve_backend("nope")
