"""The port's import and export of the reference's Haiku checkpoints
(``lagrangebench_torch.compat``) against the JAX package's
(``lagrangebench_tpu.compat``) and against genuine Haiku models.

The Haiku trees come from the reference-structured Haiku GNS, EGNN and
PaiNN of ``tests/test_compat.py``, built in this process (the installed
Haiku; no download). For GNS, EGNN, PaiNN (per-layer and shared filters)
and Linear: the port's importer equals JAX's leaf for leaf, exactly; its
exporter inverts it bit for bit; the port's model on the imported weights
matches the Haiku forward (rtol 1e-5, atol 1e-6, as ``tests/test_compat.py``
holds JAX's). Checkpoints written by either package read the same in the
other; fused trees export as their standard layout; a skeleton pickled
under Haiku's ``FlatMapping`` reads with Haiku hidden from the loader. The
SEGNN draft refuses without its flag, equals JAX's draft on a synthetic
e3nn checkpoint, and fails loudly on a missing or an unknown module.
"""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

hk = pytest.importorskip("haiku")

from lagrangebench_torch import compat  # noqa: E402
from lagrangebench_torch.checkpoint import flatten_tree  # noqa: E402
from lagrangebench_tpu import compat as jax_compat  # noqa: E402

from . import test_compat as ref  # noqa: E402

LATENT, MP_STEPS, N, E, DIM = ref.LATENT, ref.MP_STEPS, ref.N, ref.E, ref.DIM
N_VELS, N_RBF, RADIUS = 2, 5, 0.3


def _leaves(tree):
    """{path: array} of a nested dict, keys joined by a separator no Haiku
    module path holds."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out[" | ".join(prefix + (k,))] = np.asarray(v)

    walk(tree, ())
    return out


def _assert_trees_equal(got, want):
    """Keys, dtypes and values equal, bit for bit."""
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _gns():
    rng = np.random.default_rng(0)
    vel_hist = rng.normal(size=(N, 2 * DIM)).astype(np.float32)
    rel_disp = (rng.normal(size=(E, DIM)) * 0.3).astype(np.float32)
    rel_dist = np.linalg.norm(rel_disp, axis=-1, keepdims=True)
    senders = rng.integers(0, N, size=(E,)).astype(np.int32)
    receivers = rng.integers(0, N, size=(E,)).astype(np.int32)
    ptype = np.zeros((N,), np.int32)
    model = hk.without_apply_rng(hk.transform(
        lambda *a: ref._HaikuGNS()(*a)))
    args = (vel_hist, np.concatenate([rel_disp, rel_dist], -1), senders, receivers, ptype)
    params = model.init(jax.random.PRNGKey(0), *args)
    feats = {"vel_hist": vel_hist, "rel_disp": rel_disp, "rel_dist": rel_dist,
             "senders": senders, "receivers": receivers}
    return params, np.asarray(model.apply(params, *args)), feats


def _egnn():
    rng = np.random.default_rng(1)
    vel_hist = (rng.normal(size=(N, N_VELS, DIM)) * 0.1).astype(np.float32)
    pos = rng.uniform(size=(N, DIM)).astype(np.float32)
    senders = rng.integers(0, N, size=(E,)).astype(np.int32)
    receivers = rng.integers(0, N, size=(E,)).astype(np.int32)
    edge_attr = np.abs(rng.normal(size=(E, 1))).astype(np.float32)
    model = hk.without_apply_rng(hk.transform(
        lambda *a: ref._HaikuEGNN(LATENT, MP_STEPS)(*a)))
    args = (vel_hist, pos, senders, receivers, edge_attr)
    params = model.init(jax.random.PRNGKey(1), *args)
    feats = {"vel_hist": vel_hist.reshape(N, N_VELS * DIM), "abs_pos": pos[:, None],
             "rel_dist": edge_attr, "senders": senders, "receivers": receivers}
    return params, np.asarray(model.apply(params, *args)["pos"]), feats


def _painn():
    rng = np.random.default_rng(2)
    vel_hist = (rng.normal(size=(N, N_VELS, DIM)) * 0.1).astype(np.float32)
    vel_mag = np.sqrt(np.sum(vel_hist**2, axis=-1))
    rel_disp = (rng.normal(size=(E, DIM)) * 0.1).astype(np.float32)
    senders = rng.integers(0, N, size=(E,)).astype(np.int32)
    receivers = rng.integers(0, N, size=(E,)).astype(np.int32)

    def fwd(s0, v0, rd, se, re):
        rbf = ref._hk_gaussian_rbf(N_RBF, RADIUS)
        return ref._HaikuPaiNN(LATENT, MP_STEPS, rbf, RADIUS)(s0, v0, rd, se, re)

    model = hk.without_apply_rng(hk.transform(fwd))
    args = (vel_mag, vel_hist.transpose(0, 2, 1), rel_disp, senders, receivers)
    params = model.init(jax.random.PRNGKey(2), *args)
    feats = {"vel_hist": vel_hist.reshape(N, N_VELS * DIM), "vel_mag": vel_mag,
             "rel_disp": rel_disp, "senders": senders, "receivers": receivers}
    return params, np.asarray(model.apply(params, *args)), feats


def _plain(tree):
    """A Haiku tree as nested dicts of numpy arrays."""
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}


@pytest.fixture(scope="module")
def haiku_trees():
    """{case: (Haiku tree, Haiku output, features)} from the genuine Haiku
    models; ``painn_shared`` is PaiNN's tree with one (n_rbf, 3H) filter
    linear (the reference's ``shared_filters`` layout), ``linear`` the
    reference's one hk.Linear."""
    out = {"gns": _gns(), "egnn": _egnn(), "painn": _painn()}
    out = {k: (_plain(v[0]),) + v[1:] for k, v in out.items()}
    shared = dict(out["painn"][0])
    filt = shared["painn/~/filter_net"]
    shared["painn/~/filter_net"] = {"w": filt["w"][:, :3 * LATENT], "b": filt["b"][:3 * LATENT]}
    out["painn_shared"] = (shared, None, None)
    rng = np.random.default_rng(4)
    out["linear"] = ({"linear/~/linear": {"w": rng.normal(size=(7, 3)).astype(np.float32),
                                          "b": rng.normal(size=(3,)).astype(np.float32)}},
                     None, None)
    return out


def _port_import(case, tree):
    if case == "gns":
        return compat.haiku_gns_to_flax(tree, MP_STEPS), jax_compat.haiku_gns_to_flax(
            tree, MP_STEPS)
    if case == "egnn":
        return compat.haiku_egnn_to_flax(tree, MP_STEPS), jax_compat.haiku_egnn_to_flax(
            tree, MP_STEPS)
    if case.startswith("painn"):
        shared = case == "painn_shared"
        return (compat.haiku_painn_to_flax(tree, MP_STEPS, shared_filters=shared),
                jax_compat.haiku_painn_to_flax(tree, MP_STEPS, shared_filters=shared))
    return compat.haiku_linear_to_flax(tree), jax_compat.haiku_linear_to_flax(tree)


def _port_export(case, params):
    if case == "gns":
        return compat.flax_gns_to_haiku(params, MP_STEPS)
    if case == "egnn":
        return compat.flax_egnn_to_haiku(params, MP_STEPS)
    if case.startswith("painn"):
        return compat.flax_painn_to_haiku(params, MP_STEPS, shared_filters=case == "painn_shared")
    return compat.flax_linear_to_haiku(params)


CASES = ["gns", "egnn", "painn", "painn_shared", "linear"]


@pytest.mark.parametrize("case", CASES)
def test_importer_equals_jax(haiku_trees, case):
    """The port's importer gives JAX's tree: the same paths, dtypes and
    values, bit for bit."""
    got, want = _port_import(case, haiku_trees[case][0])
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("case", CASES)
def test_export_round_trips_bit_for_bit(haiku_trees, case):
    """Haiku -> port -> Haiku returns the genuine Haiku tree bit for bit, and
    the port's exporter equals JAX's on the same tree."""
    tree = haiku_trees[case][0]
    params, _ = _port_import(case, tree)
    back = _port_export(case, params)
    _assert_trees_equal(back, tree)
    jax_export = {"gns": lambda p: jax_compat.flax_gns_to_haiku(p, MP_STEPS),
                  "egnn": lambda p: jax_compat.flax_egnn_to_haiku(p, MP_STEPS),
                  "painn": lambda p: jax_compat.flax_painn_to_haiku(p, MP_STEPS),
                  "painn_shared": lambda p: jax_compat.flax_painn_to_haiku(
                      p, MP_STEPS, shared_filters=True),
                  "linear": jax_compat.flax_linear_to_haiku}[case]
    _assert_trees_equal(back, jax_export(params))


def _port_model(case):
    from lagrangebench_torch.models import EGNN, GNSStandard, PaiNN

    if case == "gns":
        return GNSStandard(particle_dimension=DIM, node_in=2 * DIM, edge_in=DIM + 1,
                           latent_size=LATENT, num_mp_steps=MP_STEPS, device="cpu")
    if case == "egnn":
        return EGNN(hidden_size=LATENT, dt=0.01, n_vels=N_VELS, num_mp_steps=MP_STEPS,
                    device="cpu")
    return PaiNN(hidden_size=LATENT, num_mp_steps=MP_STEPS, n_rbf=N_RBF, radius=RADIUS,
                 n_vels=N_VELS, device="cpu")


@pytest.mark.parametrize("case", ["gns", "egnn", "painn"])
def test_forward_on_imported_weights_matches_haiku(haiku_trees, case, tmp_path):
    """A checkpoint in the reference's on-disk layout (written as
    ``save_haiku`` does), imported with ``load_reference_checkpoint`` into
    the port's model: its forward matches the Haiku model's (rtol 1e-5,
    atol 1e-6) on sparse edges, float32."""
    tree, want, feats = haiku_trees[case]
    ckp = str(tmp_path / case)
    ref._save_haiku_layout(ckp, tree)
    assert compat.is_haiku_checkpoint(ckp)
    params, state, step = compat.load_reference_checkpoint(ckp, case,
                                                           {"num_mp_steps": MP_STEPS})
    assert state == {} and step == 7
    model = _port_model(case)
    model.load_jax_params(params)
    with torch.no_grad():
        out = model({k: torch.as_tensor(v) for k, v in feats.items()},
                    torch.zeros(N, dtype=torch.int64))
    got = out["pos" if case == "egnn" else "acc"].numpy()
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_read_the_same_in_both_packages(haiku_trees, writer, tmp_path):
    """A checkpoint that one package's ``save_reference_checkpoint`` writes
    (GNS, standard layout) holds the same bytes as the other's and reads the
    same in both ``load_reference_checkpoint``s: parameters bit for bit,
    state and step."""
    params, _ = _port_import("gns", haiku_trees["gns"][0])
    cfg = {"num_mp_steps": MP_STEPS}
    ckp, other = str(tmp_path / "a"), str(tmp_path / "b")
    save = compat.save_reference_checkpoint if writer == "port" else \
        jax_compat.save_reference_checkpoint
    save(ckp, "gns", params, cfg, step=11, loss=0.5)
    (jax_compat.save_reference_checkpoint if writer == "port" else
     compat.save_reference_checkpoint)(other, "gns", params, cfg, step=11, loss=0.5)
    for name in ("params_array.npy", "state_array.npy", "opt_state.pkl", "metadata_ckp.json"):
        with open(os.path.join(ckp, name), "rb") as f, open(os.path.join(other, name), "rb") as g:
            assert f.read() == g.read(), name
    for name in ("params", "state"):
        with open(os.path.join(ckp, f"{name}_tree.pkl"), "rb") as f, \
                open(os.path.join(other, f"{name}_tree.pkl"), "rb") as g:
            assert pickle.load(f) == pickle.load(g), name
    got, got_state, got_step = compat.load_reference_checkpoint(ckp, "gns", cfg)
    want, want_state, want_step = jax_compat.load_reference_checkpoint(ckp, "gns", cfg)
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))
    _assert_trees_equal(got, params)
    assert got_state == want_state == {} and got_step == want_step == 11


@pytest.mark.parametrize("case", ["gns", "painn"])
def test_fused_layout_exports_as_standard(haiku_trees, case, tmp_path):
    """A fused-layout tree (the port's re-layout of the imported one) exports
    as the genuine Haiku tree, bit for bit."""
    from lagrangebench_torch.models import (
        fused_params_from_standard,
        painn_fused_params_from_standard,
    )

    tree = haiku_trees[case][0]
    params, _ = _port_import(case, tree)
    relayout = fused_params_from_standard if case == "gns" else painn_fused_params_from_standard
    fused = relayout(params, MP_STEPS)
    assert set(flatten_tree(fused)) != set(flatten_tree(params))
    ckp = str(tmp_path / "fused")
    compat.save_reference_checkpoint(ckp, case, fused, {"num_mp_steps": MP_STEPS})
    _assert_trees_equal(compat.load_haiku_pytree(ckp, "params"), tree)


def test_skeleton_pickled_under_a_haiku_mapping_class(haiku_trees, tmp_path, monkeypatch):
    """A skeleton pickled as a Haiku ``FlatMap`` (which pickles as the class
    ``FlatMapping`` and one dict) reads with every Haiku module hidden from
    the loader, and equals what JAX's loader reads with Haiku."""
    from haiku._src import data_structures

    tree = haiku_trees["egnn"][0]
    ckp = str(tmp_path / "flat")
    ref._save_haiku_layout(ckp, tree)
    skeleton = data_structures.to_immutable_dict(jax.tree.map(lambda x: 0, tree))
    with open(os.path.join(ckp, "params_tree.pkl"), "wb") as f:
        pickle.dump(skeleton, f)
    with open(os.path.join(ckp, "params_tree.pkl"), "rb") as f:
        assert b"FlatMapping" in f.read()
    want = jax.tree.map(np.asarray, jax_compat.load_haiku_pytree(ckp, "params"))
    for name in [m for m in sys.modules if m == "haiku" or m.startswith("haiku.")]:
        monkeypatch.setitem(sys.modules, name, None)
    got = compat.load_haiku_pytree(ckp, "params")
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, tree)


# ---------------------------------------------------------------------------
# the SEGNN draft
# ---------------------------------------------------------------------------

def _port_segnn():
    from lagrangebench_torch.models.segnn import SEGNN, node_feature_irreps

    metadata = {"dim": 3, "periodic_boundary_conditions": [True] * 3,
                "bounds": [[0.0, 1.0]] * 3}
    return SEGNN(node_features_irreps=node_feature_irreps(metadata, ref.SEG_ISL, False, False,
                                                          True),
                 scalar_units=8, lmax_hidden=1, lmax_attributes=1, num_mp_steps=2,
                 n_vels=ref.SEG_ISL - 1, device="cpu")


@pytest.fixture(scope="module")
def segnn_draft():
    """The JAX SEGNN and its sample of ``tests/test_compat.py``, a synthetic
    e3nn checkpoint of the draft's layout for it, and the port's SEGNN of
    the same config."""
    model, sample = ref._segnn_model_and_sample()
    tree = ref._synthetic_e3nn_checkpoint(model, sample, np.random.default_rng(0))
    return model, sample, tree, _port_segnn()


def test_segnn_importer_refuses_without_flag(segnn_draft):
    with pytest.raises(NotImplementedError, match="UNVALIDATED"):
        compat.haiku_segnn_to_flax({}, segnn_draft[3])


def test_segnn_importer_equals_jax(segnn_draft):
    """On the same synthetic checkpoint the port's draft gives JAX's tree
    exactly; the site map read from the port's modules names the same
    sites with the same irreps as JAX's, which it sows at init."""
    from lagrangebench_torch.models.e3 import Irreps

    model, sample, tree, port = segnn_draft
    want = jax_compat.haiku_segnn_to_flax(tree, model, sample, allow_unvalidated=True)
    got = compat.haiku_segnn_to_flax(tree, port, allow_unvalidated=True)
    _assert_trees_equal(got, jax.tree.map(np.asarray, want))
    _, want_specs = jax_compat.segnn_site_specs(model, sample)
    _, got_specs = compat.segnn_site_specs(port)
    assert got_specs.keys() == want_specs.keys()
    for k, spec in want_specs.items():
        assert [Irreps(s) for s in got_specs[k]] == [Irreps(s) for s in spec], k
    port.load_jax_params(got)  # every leaf of the port's tree, of its shape
    assert all(np.any(v != 0) for v in flatten_tree(got).values())


@pytest.mark.parametrize("fault,match", [("missing", "missing haiku module"),
                                         ("unknown", "not consumed")])
def test_segnn_importer_fails_loudly(segnn_draft, fault, match):
    """A module the checkpoint lacks, and one the site map does not know,
    each raise ValueError with the found-versus-expected list."""
    tree = dict(segnn_draft[2])
    if fault == "missing":
        del tree["segnn/~/embedding_nodes/~/linear"]
    else:
        tree["segnn/~/embedding_msg_features/~/linear"] = {}
    with pytest.raises(ValueError, match=match):
        compat.haiku_segnn_to_flax(tree, segnn_draft[3], allow_unvalidated=True)
