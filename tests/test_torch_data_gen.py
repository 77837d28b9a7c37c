"""Port parity: the dataset tooling (``lagrangebench_torch.data_gen``:
``h5_tools``, ``jax_sph_converter``, ``gns_converter``, ``generate``)
against the JAX package's on the same inputs.

``consolidate_frames`` and ``compute_statistics_h5`` give JAX's files and
numbers; ``convert_jax_sph_dir`` gives JAX's ``.h5`` arrays and
``metadata.json`` on one jax-sph source tree (the LDC trim on, a
one-trajectory time-split, a multi-trajectory split), and its in-memory
part, ``split_trajectories``, the same splits and metadata as the files; a
tiny ensemble generated by the port converts with JAX's converter and
loads in JAX's ``H5Dataset``; ``generate.main`` runs on the CPU; and
``tfrecord_to_h5`` equals JAX's where TensorFlow imports.
"""

import json
import os

import h5py
import numpy as np
import pytest
import torch
import yaml

from lagrangebench_tpu import data_gen as jdg
from lagrangebench_tpu.data import H5Dataset as JaxH5Dataset
from lagrangebench_tpu.data_gen import jax_sph_converter as jconv
from lagrangebench_torch import data_gen as tdg
from lagrangebench_torch.data import H5Dataset
from lagrangebench_torch.data_gen import jax_sph_converter as tconv


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors are small, and under the suite's
    parallel workers more threads oversubscribe the cores (each of the
    solver's many small ops then waits on its thread pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_dataset(got_dir, want_dir, splits=("train", "valid", "test")):
    for s in splits:
        got, want = _h5_arrays(f"{got_dir}/{s}.h5"), _h5_arrays(f"{want_dir}/{s}.h5")
        assert sorted(got) == sorted(want), s
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{s}/{key}")
    with open(f"{got_dir}/metadata.json") as f, open(f"{want_dir}/metadata.json") as g:
        assert json.load(f) == json.load(g)


def _trajectories(n_trajs=4, n=8, steps=30, box=2.0, seed=0):
    rng = np.random.default_rng(seed)
    trajs, types = [], []
    for _ in range(n_trajs):
        base = rng.uniform(0, box, size=(1, n, 2))
        vel = rng.normal(0, 0.01, size=(1, n, 2))
        t = np.arange(steps)[:, None, None]
        trajs.append(np.mod(base + vel * t + rng.normal(0, 1e-3, (steps, n, 2)), box))
        types.append(np.where(np.arange(n) < n - 2, 0, 1).astype(np.int64))
    return trajs, types


@pytest.mark.parametrize("n_trajs", [1, 2, 4, 7])
def test_consolidate_frames_matches_jax(tmp_path, n_trajs):
    trajs, types = _trajectories(n_trajs)
    meta = {"bounds": [[0.0, 2.0]] * 2, "periodic_boundary_conditions": [True, True],
            "default_connectivity_radius": 0.3, "dt": 0.01, "write_every": 1, "dx": 0.1}
    jdg.consolidate_frames(trajs, types, str(tmp_path / "jax"), dict(meta))
    tdg.consolidate_frames(trajs, types, str(tmp_path / "port"), dict(meta))
    _assert_same_dataset(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("pbc", [True, False])
def test_compute_statistics_h5_matches_jax(tmp_path, pbc):
    trajs, types = _trajectories(3)
    paths = []
    for i, (t, ptype) in enumerate(zip(trajs, types)):
        paths.append(str(tmp_path / f"s{i}.h5"))
        tdg.h5_tools.write_split(paths[-1], [(t.astype(np.float32), ptype), (t, ptype)])
    got = tdg.compute_statistics_h5(paths, [2.0, 2.0], [pbc] * 2)
    want = jdg.compute_statistics_h5(paths, [2.0, 2.0], [pbc] * 2)
    assert got == want
    # the in-memory function, fed the same trajectories in the same order
    same = tdg.h5_tools.compute_statistics(
        [p for t, ptype in zip(trajs, types) for p in ((t.astype(np.float32), ptype),
                                                       (t, ptype))],
        [2.0, 2.0], [pbc] * 2)
    assert same == want


def _jax_sph_tree(root, name="2D_LDC_512", n_trajs=4, n_frames=12, seed=0, pbc=False,
                  frame_counts=None):
    """A jax-sph source tree: per-trajectory dirs of per-frame files with
    fluid inside the domain and wall padding below it."""
    rng = np.random.default_rng(seed)
    src = root / name
    dx = 0.05
    for t in range(n_trajs):
        d = src / f"{name}_{100 + t}"
        d.mkdir(parents=True)
        with open(d / "config.yaml", "w") as f:
            yaml.safe_dump({
                "case": {"name": name.split("_")[1], "dx": dx, "dim": 2,
                         "bounds": [[0.0, 1.0], [0.0, 1.0]], "pbc": [pbc, pbc],
                         "viscosity": 0.01},
                "solver": {"name": "SIR", "dt": 0.001},
                "io": {"write_every": 10},
            }, f)
        fluid = rng.uniform(3 * dx, 1.0 - 3 * dx, size=(40, 2))
        walls = np.stack([rng.uniform(0, 1, 10), rng.uniform(0, 1.5 * dx, 10)], 1)
        tag = np.concatenate([np.zeros(40), np.ones(10)]).astype(np.int32)
        base = np.concatenate([fluid, walls])
        frames = n_frames if frame_counts is None else frame_counts[t]
        for k in range(frames):
            r = base + 0.001 * k * (tag[:, None] == 0) + rng.normal(0, 1e-4, base.shape)
            with h5py.File(d / f"traj_{k}.h5", "w") as f:
                f.create_dataset("r", data=r.astype(np.float32))
                f.create_dataset("tag", data=tag)
    return src


@pytest.mark.parametrize("layout", ["ldc_trim", "time_split", "multi_split", "long_test",
                                    "subsample"])
def test_convert_jax_sph_dir_matches_jax(tmp_path, layout):
    kw, convert = {}, {}
    if layout == "ldc_trim":
        kw, convert = dict(n_trajs=4), dict(split="2_1_1")
    elif layout == "time_split":
        kw, convert = dict(name="2D_RPF_50", n_trajs=1, n_frames=40, pbc=True), \
            dict(split="80_10_10")
    elif layout == "multi_split":
        kw, convert = dict(name="2D_TGV_50", n_trajs=7, pbc=True), dict(split="5_1_1")
    elif layout == "long_test":
        kw, convert = dict(name="2D_TGV_50", n_trajs=5, pbc=True,
                           frame_counts=[12, 12, 12, 12, 20]), dict(split="3_1_1")
    else:
        kw, convert = dict(n_trajs=3), dict(split="1_1_1", skip_first_n_frames=2,
                                            slice_every_nth_frame=3, trim=False)
    src = str(_jax_sph_tree(tmp_path, **kw))
    jconv.convert_jax_sph_dir(src, str(tmp_path / "jax"), **convert)
    tconv.convert_jax_sph_dir(src, str(tmp_path / "port"), **convert)
    _assert_same_dataset(tmp_path / "port", tmp_path / "jax")
    if layout == "ldc_trim":
        with h5py.File(tmp_path / "port" / "train.h5") as f:
            assert f["00000/position"][0, :, 1].min() >= 2 * 0.05


def test_split_trajectories_is_the_converter(tmp_path):
    """The in-memory function gives the files' splits and metadata."""
    src = _jax_sph_tree(tmp_path, name="2D_TGV_50", n_trajs=5, pbc=True)
    tconv.convert_jax_sph_dir(str(src), str(tmp_path / "port"), split="3_1_1")
    dirs = sorted(os.listdir(src))
    trajs = [tconv._read_trajectory(str(src / d), 0, 1, None) for d in dirs]
    per_split, meta = tconv.split_trajectories(trajs, tconv._load_config(str(src / dirs[-1])),
                                               "3_1_1", name="2D_TGV_50")
    with open(tmp_path / "port" / "metadata.json") as f:
        assert json.load(f) == json.loads(json.dumps(meta))
    for s, pairs in per_split.items():
        arrays = _h5_arrays(tmp_path / "port" / f"{s}.h5")
        for j, (pos, tag) in enumerate(pairs):
            np.testing.assert_array_equal(arrays[f"{j:05d}/position"], pos)
            np.testing.assert_array_equal(arrays[f"{j:05d}/particle_type"], tag)


def test_trim_outer_walls_matches_jax():
    dx = 0.05
    r = np.random.default_rng(0).uniform(-0.1, 1.4, size=(200, 2))
    tag = np.random.default_rng(1).integers(0, 3, 200)
    for domain in ((1.0, 1.0), (5.366, 2.0)):
        np.testing.assert_array_equal(tconv.trim_outer_walls(r, tag, dx, domain),
                                      jconv.trim_outer_walls(r, tag, dx, domain))


def test_port_generated_ensemble_loads_in_jax(tmp_path):
    """A tiny TGV ensemble generated by the port (K1 + K2's plain versions
    on the CPU), converted by JAX's converter, loads in JAX's H5Dataset."""
    from lagrangebench_torch.data_gen import wcsph

    dirs = wcsph.generate_tgv_ensemble(str(tmp_path / "sim"), n_side=8, n_trajs=3, n_frames=6,
                                       write_every=3, verbose=False, device="cpu")
    assert [os.path.basename(d) for d in dirs] == [f"2D_TGV_64_{100 + i}" for i in range(3)]
    assert sorted(os.listdir(dirs[0])) == ["config.yaml"] + [f"traj_{k:04d}.h5"
                                                             for k in range(6)]
    jconv.convert_jax_sph_dir(str(tmp_path / "sim"), str(tmp_path / "jax"), split="1_1_1",
                              trim=False)
    tconv.convert_jax_sph_dir(str(tmp_path / "sim"), str(tmp_path / "port"), split="1_1_1",
                              trim=False)
    _assert_same_dataset(tmp_path / "port", tmp_path / "jax")
    ds = JaxH5Dataset("train", str(tmp_path / "jax"), name="tgv2d", input_seq_length=3)
    pos, ptype = ds[0]
    assert pos.shape == (64, 4, 2) and np.isfinite(np.asarray(pos)).all()
    assert ds.metadata["case"] == "TGV" and ds.metadata["periodic_boundary_conditions"] == [
        True, True]


@pytest.mark.parametrize("case", ["tgv2d", "rpf"])
def test_generate_main_on_cpu(tmp_path, case):
    """``python -m lagrangebench_torch.data_gen.generate --device cpu``: the
    dataset loads in the port (RPF with its force, through the jax.numpy
    namespace) and in JAX."""
    from lagrangebench_torch.data_gen import generate

    args = ["--case", case, "--device", "cpu", "--sim_dir", str(tmp_path / "sim"),
            "--dst_dir", str(tmp_path / "ds")]
    if case == "tgv2d":
        args += ["--n_side", "8", "--n_trajs", "3", "--n_frames", "12", "--write_every", "2",
                 "--split", "1_1_1"]
    else:  # 3,200 particles: few substeps
        args += ["--n_frames", "10", "--write_every", "1", "--warmup_steps", "1",
                 "--split", "60_20_20"]
    assert generate.main(args) == str(tmp_path / "ds")
    name = "tgv2d" if case == "tgv2d" else "rpf2d"
    ds = H5Dataset("train", str(tmp_path / "ds"), name=name, input_seq_length=3)
    jds = JaxH5Dataset("train", str(tmp_path / "ds"), name=name, input_seq_length=3)
    np.testing.assert_array_equal(ds[0][0], jds[0][0])
    assert (ds.external_force_fn is not None) == (case == "rpf")
    assert (jds.external_force_fn is not None) == (case == "rpf")
    if case == "rpf":
        assert ds.metadata["num_particles_max"] == 3200
        assert ds.metadata["sequence_length_train"] == 10 - 2 * 2 - 1


def _write_tfrecord(path, trajs, types):
    import tensorflow as tf

    with tf.io.TFRecordWriter(str(path)) as w:
        for i, (pos, ptype) in enumerate(zip(trajs, types)):
            ctx = tf.train.Features(feature={
                "key": tf.train.Feature(int64_list=tf.train.Int64List(value=[i])),
                "particle_type": tf.train.Feature(bytes_list=tf.train.BytesList(
                    value=[ptype.astype(np.int64).tobytes()])),
            })
            frames = tf.train.FeatureList(feature=[
                tf.train.Feature(bytes_list=tf.train.BytesList(
                    value=[p.astype(np.float32).tobytes()])) for p in pos])
            ex = tf.train.SequenceExample(
                context=ctx, feature_lists=tf.train.FeatureLists(
                    feature_list={"position": frames}))
            w.write(ex.SerializeToString())


def test_tfrecord_to_h5_matches_jax(tmp_path):
    pytest.importorskip("tensorflow")
    from lagrangebench_tpu.data_gen.gns_converter import tfrecord_to_h5 as jax_convert
    from lagrangebench_torch.data_gen.gns_converter import tfrecord_to_h5

    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    meta = {"bounds": [[0.1, 0.9], [0.1, 0.9]], "sequence_length": 5, "dim": 2, "dt": 0.0025,
            "default_connectivity_radius": 0.015}
    with open(src / "metadata.json", "w") as f:
        json.dump(meta, f)
    for split, n in (("train", 12), ("valid", 9)):
        trajs = [rng.uniform(0.1, 0.9, size=(6, n + i, 2)) for i in range(2)]
        types = [rng.integers(0, 6, n + i) for i in range(2)]
        _write_tfrecord(src / f"{split}.tfrecord", trajs, types)
    jax_convert(str(src), str(tmp_path / "jax"))
    assert tfrecord_to_h5(str(src), str(tmp_path / "port")) == str(tmp_path / "port")
    _assert_same_dataset(tmp_path / "port", tmp_path / "jax", splits=("train", "valid"))
    with open(tmp_path / "port" / "metadata.json") as f:
        assert json.load(f)["num_particles_max"] == 13


@pytest.mark.parametrize("name", ["tgv_2d_gen", "rpf_2d_gen"])
def test_chip_smoke_gen_configs_are_the_shipped_ones(name):
    """The configs phase 15 of chip_smoke.py carries inline equal
    configs/<name>/gns.yaml resolved over its base.yaml and the defaults."""
    import sys

    from lagrangebench_torch.config import Config, load_with_extends, merge
    from lagrangebench_torch.defaults import defaults

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    cwd = os.getcwd()
    os.chdir(repo)
    try:
        want = load_with_extends(f"configs/{name}/gns.yaml", defaults)
    finally:
        os.chdir(cwd)
    inline = {"tgv_2d_gen": chip_smoke.TGV_GEN_CONFIG, "rpf_2d_gen": chip_smoke.RPF_GEN_CONFIG}
    assert merge(defaults, Config(inline[name])).to_dict() == want.to_dict()
