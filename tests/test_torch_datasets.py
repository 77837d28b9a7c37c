"""Port parity: the dataset classes and the external force of a dataset.

The seven named classes ``TGV2D`` .. ``DAM2D`` have the JAX package's
names, default directories (as written there) and docs; ``URLS`` is JAX's;
a missing dataset directory downloads (``urllib.request.urlretrieve``
monkeypatched: nothing leaves the machine) and unzips as in JAX.

The force repair: a dataset's ``force.py`` is written in ``jax.numpy``;
the port runs it with ``jax.numpy`` bound to its own namespace, and applies
it per particle as JAX's ``jax.vmap`` does. The force features equal JAX's
in float64 (1e-12), for the test suite's ``force.py`` and the generator's
``RPF_FORCE_PY``, unbatched and batched; ``mode=infer`` of a GNS trained
by JAX on a forced dataset gives JAX's metrics (rtol 1e-5, as
``tests/test_torch_runner.py``; the std metrics over two trajectories to
1e-5 of their mean metric); and the loader leaves no ``jax`` in
``sys.modules``.
"""

import ast
import inspect
import os
import subprocess
import sys
import urllib.request
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lagrangebench_tpu
import lagrangebench_tpu.data.dataset as jds
import lagrangebench_torch
import lagrangebench_torch.data.dataset as tds
from lagrangebench_tpu import cli as jax_cli
from lagrangebench_tpu.case import case_builder as jax_case_builder
from lagrangebench_tpu.data.synthetic import make_synthetic_dataset
from lagrangebench_tpu.data_gen.wcsph import RPF_FORCE_PY as JAX_RPF_FORCE_PY
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.data.force import JnpNamespace, apply_force, load_force_fn
from lagrangebench_torch.data_gen.wcsph import RPF_FORCE_PY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("TGV2D", "TGV3D", "RPF2D", "RPF3D", "LDC2D", "LDC3D", "DAM2D")
ISL, STEPS = 4, 3

# the force of tests/test_dataset_families.py
FAMILY_FORCE_PY = (
    "import jax.numpy as jnp\n"
    "def force_fn(position):\n"
    "    # reverse-Poiseuille-style: +x force in the upper half\n"
    "    sign = jnp.where(position[1] > 0.5, 1.0, -1.0)\n"
    "    return jnp.array([sign, 0.0]) * 0.01\n"
)
FORCES = {"families": FAMILY_FORCE_PY, "rpf": RPF_FORCE_PY}


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


@pytest.mark.parametrize("name", NAMES)
def test_named_classes_match_jax(name):
    port, ref = getattr(tds, name), getattr(jds, name)
    assert port.__name__ == ref.__name__ == name
    assert port.__doc__ == ref.__doc__
    assert issubclass(port, tds.H5Dataset)
    got = inspect.signature(port.__init__).parameters
    want = inspect.signature(ref.__init__).parameters
    assert list(got) == list(want)
    for key in want:
        assert got[key].default == want[key].default, key
    assert getattr(lagrangebench_torch, name) is port
    assert getattr(lagrangebench_torch.data, name) is port
    assert name in lagrangebench_torch.__all__ and name in lagrangebench_tpu.__all__


def test_urls_and_nl_backend_match_jax():
    assert tds.URLS == jds.URLS and tds.ZENODO_PREFIX == jds.ZENODO_PREFIX
    got = inspect.signature(tds.H5Dataset.__init__).parameters["nl_backend"].default
    assert got == inspect.signature(jds.H5Dataset.__init__).parameters["nl_backend"].default


def _fake_zenodo(monkeypatch, src, urls):
    dirname = os.path.basename(src)

    def fake_retrieve(url, filename):
        urls.append(url)
        with zipfile.ZipFile(filename, "w") as z:
            for f in os.listdir(src):
                z.write(os.path.join(src, f), arcname=f"{dirname}/{f}")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)


@pytest.mark.parametrize("how", ["h5dataset", "named"])
def test_download_flow(tmp_path, monkeypatch, how):
    """A missing directory with a known name downloads its archive into the
    parent and unzips it there; the archive is removed. The same dataset
    then loads as in JAX."""
    src = make_synthetic_dataset(str(tmp_path / "src"), n_particles=8, dim=2, box=1.0,
                                 seq_len_train=12, seq_len_eval=10, n_trajs=2, name="TGV")
    urls = []
    _fake_zenodo(monkeypatch, src, urls)
    target = tmp_path / "dst" / os.path.basename(src)
    if how == "named":
        ds = tds.TGV2D("train", dataset_path=str(target), input_seq_length=3)
    else:
        ds = tds.H5Dataset("train", dataset_path=str(target), name="tgv2d",
                           input_seq_length=3)
    assert urls == [tds.URLS["tgv2d"]]
    assert ds.name == "tgv2d" and ds.dataset_path == str(target)
    assert sorted(os.listdir(tmp_path / "dst")) == [os.path.basename(src)]
    ref = jds.H5Dataset("train", dataset_path=str(target), name="tgv2d", input_seq_length=3)
    assert len(ds) == len(ref)
    np.testing.assert_array_equal(ds[0][0], ref[0][0])


def test_download_unknown_name_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlretrieve",
                        lambda *a: pytest.fail("must not download"))
    with pytest.raises(ValueError, match="not available for download"):
        tds.H5Dataset("train", str(tmp_path / "missing"), name="foo2d")
    with pytest.raises(AssertionError, match="not available for download"):
        jds.H5Dataset("train", str(tmp_path / "missing"), name="foo2d")


def _force_dir(tmp_path, text):
    d = tmp_path / "force_ds"
    d.mkdir()
    (d / "force.py").write_text(text)
    return str(d)


def _force_cases(tmp_path, text):
    """The two packages' cases on the same forced 2D data, float64."""
    src = make_synthetic_dataset(str(tmp_path), n_particles=100, dim=2, box=2.0,
                                 seq_len_train=12, seq_len_eval=12, n_trajs=2, name="RPF")
    with open(os.path.join(src, "force.py"), "w") as f:
        f.write(text)
    port_force = tds._load_force_fn(src)
    jax_force = jds.H5Dataset._load_force_fn(src)
    port_ds = tds.H5Dataset("test", src, input_seq_length=ISL, extra_seq_length=STEPS)
    meta = port_ds.metadata
    kw = dict(box=[2.0, 2.0], metadata=meta, input_seq_length=ISL, noise_std=0.0)
    ref = jax_case_builder(cfg_neighbors={"backend": "celllist"}, dtype=jnp.float64,
                           external_force_fn=jax_force, **kw)
    port = case_builder(cfg_neighbors={"backend": "auto"}, dtype=torch.float64,
                        device="cpu", external_force_fn=port_force, **kw)
    pos = np.stack([port_ds[i][0] for i in range(2)])  # (B, N, T, dim)
    ptype = np.stack([port_ds[i][1] for i in range(2)])
    return ref, port, pos, ptype


@pytest.mark.parametrize("text", sorted(FORCES))
def test_force_features_match_jax(tmp_path, text):
    """allocate_eval of one sample, and the batched eval preprocess of two:
    the "force" feature equals JAX's to 1e-12 in float64, and the bands
    have both signs."""
    ref, port, pos, ptype = _force_cases(tmp_path, FORCES[text])
    sample = (pos[0, :, :ISL], ptype[0])
    rf, rn = ref.allocate_eval(sample)
    pf, pn = port.allocate_eval(sample)
    assert pf["force"].shape == (100, 2) and pf["force"].dtype == torch.float64
    np.testing.assert_allclose(pf["force"].numpy(), np.asarray(rf["force"]), rtol=0,
                               atol=1e-12)
    assert set(np.unique(np.sign(pf["force"][:, 0].numpy()))) == {-1.0, 1.0}

    rn_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), rn)
    window = pos[:, :, 1:ISL + 1]
    rf_b, _ = ref.preprocess_eval_batched((window, ptype), rn_b)
    pf_b, _ = port.preprocess_eval_batched((window, ptype), pn.broadcast(2))
    assert pf_b["force"].shape == (200, 2)
    np.testing.assert_allclose(pf_b["force"].numpy(), np.asarray(rf_b["force"]), rtol=0,
                               atol=1e-12)


def test_rpf_force_text_is_jax():
    assert RPF_FORCE_PY == JAX_RPF_FORCE_PY


@pytest.mark.parametrize("text", sorted(FORCES))
def test_force_file_applies_per_particle(tmp_path, text):
    """The loaded function reads r[1] as the y-coordinate of each particle,
    on any leading shape, in the positions' dtype."""
    fn = load_force_fn(os.path.join(_force_dir(tmp_path, FORCES[text]), "force.py"))
    r = torch.as_tensor(np.random.default_rng(0).uniform(0, 2, size=(3, 7, 2)))
    got = apply_force(fn, r)
    want_fn = jds.H5Dataset._load_force_fn(str(tmp_path / "force_ds"))
    want = np.asarray(jax.vmap(jax.vmap(want_fn))(jnp.asarray(r.numpy())))
    assert got.shape == r.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert apply_force(fn, r.float()).dtype == torch.float32


def test_force_namespace_lacks_a_name(tmp_path):
    d = _force_dir(tmp_path, "import jax.numpy as jnp\n"
                             "def force_fn(r):\n    return jnp.tanh(r)\n")
    fn = tds._load_force_fn(d)
    with pytest.raises(AttributeError, match=r"jax\.numpy\.tanh .*force\.py"):
        apply_force(fn, torch.zeros(4, 2))
    with pytest.raises(AttributeError, match="linspace"):
        JnpNamespace("x.py").linspace


def test_force_namespace_names():
    """Every name of the namespace maps onto torch as jnp would compute."""
    jnp_t = JnpNamespace("x.py")
    x = torch.tensor([[0.3, -1.2], [2.0, 0.5]], dtype=torch.float64)
    xn = jnp.asarray(x.numpy())
    pairs = [
        (jnp_t.where(x > 0, x, 0.0), jnp.where(xn > 0, xn, 0.0)),
        (jnp_t.array([x[0, 0], 1.0]), jnp.array([xn[0, 0], 1.0])),
        (jnp_t.asarray([1.0, 2.0], dtype=torch.float64), jnp.asarray([1.0, 2.0])),
        (jnp_t.zeros((2, 3), dtype=torch.float64), jnp.zeros((2, 3))),
        (jnp_t.ones(3, dtype=torch.float64), jnp.ones(3)),
        (jnp_t.sin(x), jnp.sin(xn)), (jnp_t.cos(x), jnp.cos(xn)), (jnp_t.exp(x), jnp.exp(xn)),
        (jnp_t.stack([x, x], axis=1), jnp.stack([xn, xn], axis=1)),
        (jnp_t.concatenate([x, x], axis=0), jnp.concatenate([xn, xn], axis=0)),
        (jnp_t.linalg.norm(x, axis=-1), jnp.linalg.norm(xn, axis=-1)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15, atol=0)
    assert jnp_t.pi == np.pi


def test_array_dataset_carries_the_force():
    meta = {"num_particles_max": 4}
    traj = np.zeros((6, 4, 2))
    fn = lambda r: r  # noqa: E731
    ds = tds.ArrayDataset("train", [traj], [np.zeros(4, np.int64)], meta,
                          input_seq_length=2, external_force_fn=fn)
    assert ds.external_force_fn is fn
    assert tds.ArrayDataset("train", [traj], [np.zeros(4, np.int64)], meta,
                            input_seq_length=2).external_force_fn is None


def test_loader_leaves_no_jax_in_sys_modules(tmp_path):
    """In a fresh interpreter without JAX imported, loading and applying a
    jnp-written force.py imports no JAX and leaves no jax entry behind."""
    d = _force_dir(tmp_path, RPF_FORCE_PY)
    code = (
        "import sys, torch\n"
        "assert 'jax' not in sys.modules\n"
        "from lagrangebench_torch.data.dataset import _load_force_fn\n"
        "from lagrangebench_torch.data.force import apply_force\n"
        f"fn = _load_force_fn({d!r})\n"
        "out = apply_force(fn, torch.tensor([[0.5, 0.5], [0.5, 1.5]]))\n"
        "assert out.tolist() == [[1.0, 0.0], [-1.0, -0.0]], out\n"
        "left = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.'))\n"
        "print('LEFT', left)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "LEFT []"


def test_loader_restores_a_real_jax(tmp_path):
    """Where JAX is imported (as in this test process), the loader puts the
    real modules back."""
    before = (sys.modules["jax"], sys.modules["jax.numpy"])
    fn = tds._load_force_fn(_force_dir(tmp_path, RPF_FORCE_PY))
    assert (sys.modules["jax"], sys.modules["jax.numpy"]) == before
    assert apply_force(fn, torch.tensor([[0.0, 1.5]])).tolist() == [[-1.0, -0.0]]


# -- mode=infer on a forced dataset -------------------------------------------


def _yaml(root, src):
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
        "  infer:\n    batch_size: 2\n    metrics: [mse, e_kin, sinkhorn]\n    out_type: pkl\n"
        f"logging:\n  log_steps: 1\n  eval_steps: 2\n  ckp_dir: {root}/ckp\n"
        "neighbors:\n  backend: auto\n"
    )
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def forced_run(tmp_path_factory):
    """A JAX-trained GNS on a forced (RPF-style) dataset, and JAX's infer
    metrics on it."""
    root = str(tmp_path_factory.mktemp("forced"))
    src = make_synthetic_dataset(root, n_particles=64, dim=2, box=2.0, seq_len_train=12,
                                 seq_len_eval=ISL + STEPS, n_trajs=2, name="RPF")
    with open(os.path.join(src, "force.py"), "w") as f:
        f.write(RPF_FORCE_PY)
    jax_cli.main([f"config={_yaml(root, src)}", "mode=train"])
    run_dir = os.path.join(root, "ckp", os.listdir(os.path.join(root, "ckp"))[0])
    # the port's parameters are float32: both packages infer from the
    # checkpoint cast to float32 (as tests/test_torch_runner.py does)
    for path in (os.path.join(run_dir, "params.npz"), os.path.join(run_dir, "best", "params.npz")):
        with np.load(path) as data:
            leaves = {k: data[k].astype(np.float32) if data[k].dtype == np.float64 else data[k]
                      for k in data.files}
        np.savez(path, **leaves)
    metrics = jax_cli.main([f"load_ckp={run_dir}", "mode=infer"])
    return run_dir, metrics


def test_forced_infer_matches_jax(forced_run):
    """``python -m lagrangebench_torch gpu=-1 mode=infer load_ckp=<JAX run>``
    on the forced dataset: JAX's metrics, rtol 1e-5 (the std metrics to
    1e-5 of their mean metric). The checkpoint's node
    encoder takes the force feature, so the port's GNS must be built with
    it."""
    run_dir, want = forced_run
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "lagrangebench_torch", f"load_ckp={run_dir}", "mode=infer",
         "gpu=-1"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    got = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in want:
        if "/std" in key:
            # a std over two trajectories is half their difference: held to
            # 1e-5 of its metric's mean, which the float32 models' ~1e-7
            # relative differences per trajectory can reach 1e-5 of the std
            mean = want[key.replace("/std", "/")]
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5 * abs(mean),
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-12,
                                       err_msg=key)


def test_forced_dataset_builds_a_forced_model(forced_run):
    """The runner's GNS on the forced dataset has the force in its node
    input: 2 wider than without (dim 2)."""
    from lagrangebench_torch import runner
    from lagrangebench_torch.config import load_with_extends
    from lagrangebench_torch.defaults import defaults
    from lagrangebench_torch.models import setup_model

    run_dir, _ = forced_run
    cfg = load_with_extends(os.path.join(run_dir, "config.yaml"), defaults)
    train, _, _ = runner.setup_data(cfg)
    assert train.external_force_fn is not None

    with_force = setup_model(cfg.model, train.metadata, has_external_force=True, device="cpu")
    without = setup_model(cfg.model, train.metadata, has_external_force=False, device="cpu")
    widths = [sum(p.numel() for p in m.parameters()) for m in (with_force, without)]
    assert widths[0] > widths[1]
