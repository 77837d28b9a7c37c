"""Port parity on the sparse (2, E) edge layout against the JAX package.

* ``ops/scatter.py``'s sparse branches (``segment_sum``, ``segment_mean``,
  ``aggregate_to_receivers``, ``aggregate_mean_to_receivers``) with
  out-of-range ids, against ``lagrangebench_tpu/ops/scatter.py``: 1e-12.
* The case's sparse features, of one sample and of a batch flattened with
  per-sample offsets (``ops.batching``), against the JAX case on the same
  synthetic data (cell list, float64, padded particles): 1e-12.
* On those sparse features (3D; SEGNN also 2D with walls and two particle
  types), with one parameter tree carried across: the standard GNS
  processor (1 and 2 layers per MLP), PaiNN's standard layer, EGNN and
  SEGNN against the JAX models in float64, forward within 1e-9 (of the
  largest value where it exceeds 1, as the dense PaiNN tests hold it); the
  parameter gradients of GNS (2 layers, 1e-9) and PaiNN (rtol 1e-7, atol
  1e-9), the tolerances of the dense tests.
* Inside the port, the same weights on the sparse and the dense layout of
  one radius graph: 1e-9.
* The fused GNS processor and the fused PaiNN layer refuse sparse edges.

The JAX forwards run eagerly (jit-compiling SEGNN takes XLA minutes on
the CPU); the JAX gradients are jitted (eagerly they take ten times as
long).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.case import case_builder as jax_case_builder
from lagrangebench_tpu.config import Config as JaxConfig
from lagrangebench_tpu.defaults import defaults as jax_defaults
from lagrangebench_tpu.models import setup_model as jax_setup_model
from lagrangebench_tpu.ops import scatter as jax_scatter
from lagrangebench_tpu.utils import broadcast_to_batch
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.config import Config
from lagrangebench_torch.data.synthetic import make_synthetic_arrays
from lagrangebench_torch.defaults import defaults
from lagrangebench_torch.models import setup_model
from lagrangebench_torch.ops import scatter

ISL = 4
SETUPS = {"3d": dict(dim=3, n=125, walls=False), "2d_walls": dict(dim=2, n=100, walls=True)}


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# ops/scatter.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean", "aggregate_to_receivers",
                                "aggregate_mean_to_receivers"])
def test_sparse_scatter_matches_jax(fn):
    """(E, 3, 4) data into 30 buckets by (E,) receiver ids holding padded
    edges (id N) and negative ids, which drop."""
    rng = np.random.default_rng(0)
    n, e = 30, 200
    data = rng.normal(size=(e, 3, 4))
    ids = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    ids[-25:] = n
    ids[:3] = -1
    senders = np.where(ids < n, rng.integers(0, n, size=e), n).astype(np.int32)
    if fn.startswith("segment"):
        got = getattr(scatter, fn)(torch.as_tensor(data), torch.as_tensor(ids), n)
        want = getattr(jax_scatter, fn)(jnp.asarray(data), jnp.asarray(ids), n,
                                        indices_are_sorted=False)
    else:
        got = getattr(scatter, fn)(torch.as_tensor(data), torch.as_tensor(ids),
                                   torch.as_tensor(senders), n)
        want = getattr(jax_scatter, fn)(jnp.asarray(data), jnp.asarray(ids),
                                        jnp.asarray(senders), n)
    assert got.shape == (n, 3, 4) and np.abs(np.asarray(want)).max() > 0.1
    _close(got.numpy(), want, 1e-12)


# ---------------------------------------------------------------------------
# the case's sparse features
# ---------------------------------------------------------------------------


def _data(setup):
    """(2, N, ISL, dim) positions and (2, N) types (two kinds; sample 1's
    last five particles padding) with their metadata."""
    spec = SETUPS[setup]
    splits, metadata = make_synthetic_arrays(n_particles=spec["n"], dim=spec["dim"], box=1.0,
                                             seq_len_train=ISL + 1, seq_len_eval=ISL + 1,
                                             n_trajs=2)
    metadata["periodic_boundary_conditions"] = [not spec["walls"]] * spec["dim"]
    pos = np.stack([t.transpose(1, 0, 2) for t in splits["test"]])[:, :, :ISL]
    ptype = np.zeros(pos.shape[:2], np.int64)
    if spec["walls"]:
        ptype[:, ::4] = 1
    ptype[1, -5:] = -1
    return pos, ptype, metadata


def _port_case(metadata, fmt):
    dim = metadata["dim"]
    return case_builder([1.0] * dim, metadata, ISL,
                        cfg_neighbors={"backend": "celllist", "format": fmt},
                        cfg_model={"magnitude_features": True}, dtype=torch.float64,
                        device="cpu")


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The port's flat features of a batch of 2, sparse and dense (one
    radius graph), and the JAX case's sparse features of the same batch."""
    pos, ptype, metadata = _data(name)
    out = {"setup": name, "metadata": metadata, "pos": pos, "ptype": ptype}
    for fmt in ("sparse", "dense"):
        case = _port_case(metadata, fmt)
        single, nbrs = case.allocate_eval((pos[0], ptype[0]))
        feats, nbrs_b = case.preprocess_eval_batched((pos, ptype), nbrs.broadcast(2))
        assert nbrs_b.backend == "celllist" and not nbrs_b.did_buffer_overflow.any()
        out[fmt] = feats
        out[f"{fmt}_single"] = single
        out[f"{fmt}_case"] = case
    jcase = jax_case_builder([1.0] * metadata["dim"], metadata, ISL,
                             cfg_neighbors={"backend": "celllist", "format": "sparse"},
                             cfg_model={"magnitude_features": True}, dtype=jnp.float64)
    jsingle, jn = jcase.allocate_eval((pos[0], ptype[0]))
    out["jax"], _ = jcase.preprocess_eval_batched((pos, ptype), broadcast_to_batch(jn, 2))
    out["jax_single"] = jsingle
    out["jax_case"] = jcase
    return out


@pytest.mark.parametrize("setup", list(SETUPS))
def test_sparse_features_match_jax(setup):
    """Every feature of one sample and of the flattened batch equals the JAX
    case's (ids exactly; padded edges fill N, or B*N in the flat graph)."""
    s = _setup(setup)
    n = s["ptype"].shape[1]
    for got, want, fill in ((s["sparse_single"], s["jax_single"], n),
                            (s["sparse"], s["jax"], 2 * n)):
        assert set(got) == set(want)
        for key, value in want.items():
            value = np.asarray(value)
            assert tuple(got[key].shape) == value.shape, key
            if key in ("senders", "receivers"):
                np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
            else:
                _close(got[key].numpy(), value, 1e-12)
        assert (got["senders"] == fill).any() and got["senders"].dim() == 1


# ---------------------------------------------------------------------------
# the models on sparse edges
# ---------------------------------------------------------------------------

MODELS = {
    "gns_1": {"name": "gns", "num_mlp_layers": 1},
    "gns_2": {"name": "gns", "num_mlp_layers": 2},
    "painn": {"name": "painn"},
    "egnn": {"name": "egnn"},
    "segnn": {"name": "segnn"},
}


def _cfgs(model):
    values = {"latent_dim": 16, "num_mp_steps": 2, "input_seq_length": ISL,
              "magnitude_features": True, "compute_dtype": "float64", **MODELS[model]}
    jcfg, pcfg = JaxConfig(jax_defaults.model.to_dict()), Config(defaults.model.to_dict())
    for key, value in values.items():
        setattr(jcfg, key, value)
        setattr(pcfg, key, value)
    return jcfg, pcfg


def _models(s, model):
    """The JAX model and the port model on one perturbed float32 tree."""
    jcfg, pcfg = _cfgs(model)
    homogeneous = s["setup"] != "2d_walls"
    stats = s["sparse_case"].normalization_stats
    port = setup_model(pcfg, s["metadata"], device="cpu", normalization_stats=stats,
                       homogeneous_particles=homogeneous)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
                          port.jax_params())
    port.load_jax_params(params)
    jmodel, _, _ = jax_setup_model(jcfg, s["metadata"],
                                   normalization_stats=s["jax_case"].normalization_stats,
                                   homogeneous_particles=homogeneous)
    return jmodel, port, params


def _uncast_site(model):
    """The intermediate holding the model's float64 output before a final
    float32 cast (None where the output is not cast)."""
    if model.startswith("gns"):
        return "MLP_6", lambda m: m.decoder, lambda o: o
    if model == "painn":
        return "GatedEquivariantBlock_1", lambda m: m.readout[-1], lambda o: o[1][..., 0]
    return None


def _jax_out(jmodel, params, sample, model):
    site = _uncast_site(model)
    if site is None:
        return jmodel.apply({"params": params}, sample)
    _, inter = jmodel.apply({"params": params}, sample, capture_intermediates=True)
    return {"acc": site[2](inter["intermediates"][site[0]]["__call__"][0])}


def _port_out(port, feats, ptype, model):
    site = _uncast_site(model)
    seen = {}
    handle = None
    if site is not None:
        def hook(module, inputs, output):
            seen["acc"] = site[2](output)

        handle = site[1](port).register_forward_hook(hook)
    out = port(feats, torch.as_tensor(ptype))
    if handle is not None:
        handle.remove()
        return seen
    return out


def _jax_sample(s):
    return ({k: jnp.asarray(v) for k, v in s["jax"].items()}, jnp.asarray(s["ptype"].reshape(-1)))


def _check_forward(s, model, port, want):
    """The port's sparse forward against ``want`` (JAX's), and its dense
    forward on the same weights against its sparse one."""
    ptype = s["ptype"].reshape(-1)
    with torch.no_grad():
        got = _port_out(port, s["sparse"], ptype, model)
        dense = _port_out(port, s["dense"], ptype, model)
    for key, value in want.items():
        assert np.abs(np.asarray(value)).max() > 1e-3, key
        _close(got[key].numpy(), value, 1e-9)
        _close(dense[key].numpy(), got[key].numpy(), 1e-9)


@pytest.mark.parametrize("setup,model", [("3d", "gns_1"), ("3d", "egnn"), ("3d", "segnn"),
                                         ("2d_walls", "segnn")])
def test_sparse_models_match_jax(setup, model):
    """Forward on the batch's sparse features: within 1e-9 of the JAX
    model; and the same weights on the sparse and the dense layout of one
    radius graph agree within 1e-9."""
    s = _setup(setup)
    jmodel, port, params = _models(s, model)
    _check_forward(s, model, port, _jax_out(jmodel, params, _jax_sample(s), model))


@pytest.mark.parametrize("model", ["gns_2", "painn"])
def test_sparse_models_and_gradients_match_jax(model):
    """As above in 3D, with float64 parameters on both sides; and
    d(sum acc^2)/d(params) on sparse edges against jax.grad of the same
    loss."""
    s = _setup("3d")
    jmodel, port, params = _models(s, model)
    sample = _jax_sample(s)

    def loss(p):
        acc = _jax_out(jmodel, p, sample, model)["acc"]
        return jnp.sum(acc**2), acc

    wide = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    (_, acc), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(wide)
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    port.double()
    (_port_out(port, s["sparse"], s["ptype"].reshape(-1), model)["acc"] ** 2).sum().backward()
    rtol = 1e-7 if model == "painn" else 1e-9
    for path, p, transposed in port.jax_leaves():
        g = p.grad.t() if transposed else p.grad
        np.testing.assert_allclose(g.numpy(), want[path], rtol=rtol, atol=1e-9, err_msg=path)
    _check_forward(s, model, port, {"acc": acc})


@pytest.mark.parametrize("name", ["gns", "painn"])
def test_fused_models_refuse_sparse_edges(name):
    s = _setup("3d")
    _, pcfg = _cfgs("gns_2" if name == "gns" else name)
    pcfg.fused_processor = True
    pcfg.latent_dim = 128 if name == "gns" else 16
    port = setup_model(pcfg, s["metadata"], device="cpu")
    with pytest.raises(ValueError, match="needs the dense edge layout"):
        port(s["sparse"], torch.as_tensor(s["ptype"].reshape(-1)))
