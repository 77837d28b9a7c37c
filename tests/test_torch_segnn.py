"""Port parity: SEGNN (``models.SEGNN``) against the JAX package's
``SEGNN`` from one parameter tree (``load_jax_params``), on dense (N, K)
inputs made from a numpy seed: 2 layers, latent 8, 200 particles, padded
slots (sender N).

Cases: 3D periodic with one particle type; 2D with walls (``bound``), an
external force, two particle types (the ``NodeType.SIZE`` one-hot) and
``magnitude_features``; 2D with walls, two types, lmax 2 (attributes and
hidden) and ``segnn_norm: instance``; 3D with instance norm,
``velocity_aggregate: last`` and one block per step. (The JAX side runs
eagerly: jit-compiling an lmax-2 SEGNN takes XLA minutes on the CPU.)

* float64 (``compute_dtype="float64"`` on both sides): acc within atol
  and rtol 1e-9; the gradients of a loss sum(acc * c) in every parameter
  and in the input features ``vel_hist`` and ``rel_disp`` within 1e-5 of
  the largest |gradient| per tensor. JAX's float64 tensor product is a
  float64 dot rounded to float32 whose transpose XLA runs as float32 dots
  (``tests/test_torch_e3.py``), so its gradients are float32 sums in
  another summation order than the port's (up to 1.7e-6 measured).
* ``aggregate_mean_to_receivers`` (dense) and ``features_2d_to_3d``:
  equal to JAX's.
* float32, the shipped setting: acc and the gradients within 1e-5 of the
  largest value.
* bfloat16 compute: acc within 2e-2 and the gradients within 5e-2 of the
  largest value. Both round the weights to bf16 and sum in float32, but
  at other points: JAX rounds the Clebsch-Gordan products, the port
  (weights first) rounds x; one rounding is up to 2^-9 of a value, and
  the gradients of the bf16 operands are rounded to bf16 too (7.8e-3 and
  2.0e-2 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.config import Config as JaxConfig
from lagrangebench_tpu.defaults import defaults as jax_defaults
from lagrangebench_tpu.models.segnn import build_segnn as jax_build_segnn
from lagrangebench_tpu.models.utils import features_2d_to_3d as jax_features_2d_to_3d
from lagrangebench_tpu.ops.scatter import aggregate_mean_to_receivers as jax_mean
from lagrangebench_torch.config import Config
from lagrangebench_torch.defaults import defaults
from lagrangebench_torch.models import setup_model
from lagrangebench_torch.models.utils import features_2d_to_3d
from lagrangebench_torch.ops.scatter import aggregate_mean_to_receivers
from lagrangebench_torch.utils import NodeType

N, K, ISL = 200, 12, 4

CASES = {
    "3d_periodic": dict(dim=3),
    "2d_walls_force_types": dict(dim=2, walls=True, force=True, types=True,
                                 model={"magnitude_features": True}),
    "2d_walls_types_lmax2_instance": dict(
        dim=2, walls=True, types=True,
        model={"lmax_attributes": 2, "lmax_hidden": 2, "segnn_norm": "instance"}),
    "3d_instance_last_one_block": dict(
        dim=3, model={"segnn_norm": "instance", "velocity_aggregate": "last",
                      "num_mlp_layers": 1}),
}


def _model_cfg(case, cdt):
    model = {"name": "segnn", "latent_dim": 8, "num_mp_steps": 2, "input_seq_length": ISL,
             "compute_dtype": cdt, **CASES[case].get("model", {})}
    jcfg = JaxConfig(jax_defaults.model.to_dict())
    pcfg = Config(defaults.model.to_dict())
    for key, value in model.items():
        setattr(jcfg, key, value)
        setattr(pcfg, key, value)
    return jcfg, pcfg


def _inputs(case, dtype, seed=0):
    spec = CASES[case]
    dim = spec["dim"]
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K)).astype(np.int32)
    senders[rng.uniform(size=(N, K)) < 0.3] = N
    rel_disp = np.where((senders < N)[..., None], rng.uniform(-1, 1, size=(N, K, dim)), 0.0)
    feats = {
        "vel_hist": rng.normal(size=(N, (ISL - 1) * dim)),
        "senders": senders,
        "receivers": np.broadcast_to(np.arange(N, dtype=np.int32)[:, None], (N, K)).copy(),
        "rel_disp": rel_disp,
        "rel_dist": np.linalg.norm(rel_disp, axis=-1, keepdims=True),
    }
    if spec.get("walls"):
        feats["bound"] = rng.uniform(-1, 1, size=(N, 2 * dim))
    if spec.get("force"):
        feats["force"] = rng.normal(size=(N, dim))
    if spec.get("model", {}).get("magnitude_features"):
        feats["vel_mag"] = rng.uniform(0, 2, size=(N, ISL - 1))
    ptype = rng.integers(0, 2, size=N) if spec.get("types") else np.zeros(N, np.int64)
    feats = {k: v.astype(dtype) if v.dtype.kind == "f" else v for k, v in feats.items()}
    return feats, ptype, rng.normal(size=(N, dim))


def _setup(case, cdt, dtype):
    spec = CASES[case]
    jcfg, pcfg = _model_cfg(case, cdt)
    metadata = {"periodic_boundary_conditions": [not spec.get("walls", False)] * spec["dim"],
                "dim": spec["dim"]}
    kw = dict(has_external_force=spec.get("force", False),
              homogeneous_particles=not spec.get("types", False))
    feats, ptype, cot = _inputs(case, dtype)
    jmodel = jax_build_segnn(jcfg, metadata, **kw)
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    port = setup_model(pcfg, metadata, device="cpu", **kw)
    # the port's tree (test_parameter_tree_matches_jax holds it to JAX's
    # init), every leaf perturbed (zero biases matter too), float32 as
    # checkpoints hold it; a missing or misshapen leaf fails JAX's apply
    params = jax.tree.map(
        lambda x: (x + 0.1 * np.random.default_rng(1).normal(size=x.shape)).astype(np.float32),
        port.jax_params())
    port.load_jax_params(params)
    return jmodel, params, sample, port, feats, ptype, cot


def _paths(tree):
    return ["/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _jax_grads(jmodel, params, sample, cot, wide):
    feats, ptype = sample

    def loss(p, vel_hist, rel_disp):
        f = dict(feats, vel_hist=vel_hist, rel_disp=rel_disp)
        return jnp.sum(jmodel.apply({"params": p}, (f, ptype))["acc"] * cot)

    p = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params) if wide else params
    return jax.grad(loss, argnums=(0, 1, 2))(p, feats["vel_hist"], feats["rel_disp"])


def _port_grads(port, feats, ptype, cot):
    t = {k: torch.as_tensor(v) for k, v in feats.items()}
    t["vel_hist"].requires_grad_()
    t["rel_disp"].requires_grad_()
    acc = port(t, torch.as_tensor(ptype))["acc"]
    (acc * torch.as_tensor(cot, dtype=acc.dtype)).sum().backward()
    return acc, t["vel_hist"].grad, t["rel_disp"].grad


def _close_to_max(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, f"{what}: {err:.3g} of the largest > {tol}"


@pytest.mark.parametrize("case", ["3d_periodic", "2d_walls_force_types"])
def test_parameter_tree_matches_jax(case):
    """The port's parameter tree has the paths, in JAX's flatten order, and
    the shapes of the tree the JAX model's init makes."""
    jmodel, params, sample, port, *_ = _setup(case, "float32", np.float32)
    want = jax.device_get(jmodel.init(jax.random.PRNGKey(0), sample)["params"])
    assert [leaf[0] for leaf in port.jax_leaves()] == _paths(want)
    shapes = dict(zip(_paths(want), (x.shape for x in jax.tree_util.tree_leaves(want))))
    assert {path: p.shape for path, p, _ in port.jax_leaves()} == shapes


@pytest.mark.parametrize("case", list(CASES))
def test_segnn_matches_jax_float64(case):
    """acc (1e-9) and the gradients in every parameter and in vel_hist and
    rel_disp (1e-5 of the largest), float64 on both sides."""
    jmodel, params, sample, port, feats, ptype, cot = _setup(case, "float64", np.float64)
    want = np.asarray(jmodel.apply({"params": params}, sample)["acc"])
    dim = CASES[case]["dim"]
    assert want.shape == (N, dim)
    if CASES[case].get("types"):
        assert f"{NodeType.SIZE}x0e" in repr(port.node_features_irreps)

    port = port.double()
    acc, g_vel, g_disp = _port_grads(port, feats, ptype, cot)
    np.testing.assert_allclose(acc.detach().numpy(), want, rtol=1e-9, atol=1e-9)
    grads = _jax_grads(jmodel, params, sample, cot, wide=True)
    _close_to_max(g_vel.numpy(), grads[1], 1e-5, "d/d vel_hist")
    _close_to_max(g_disp.numpy(), grads[2], 1e-5, "d/d rel_disp")
    want_p = dict(zip(_paths(grads[0]), jax.tree_util.tree_leaves(grads[0])))
    for path, p, _ in port.jax_leaves():
        _close_to_max(p.grad.numpy(), want_p[path], 1e-5, path)


@pytest.mark.parametrize("case,cdt,tol", [
    ("3d_periodic", "float32", (1e-5, 1e-5)),
    ("2d_walls_force_types", "float32", (1e-5, 1e-5)),
    ("3d_periodic", "bfloat16", (2e-2, 5e-2)),
], ids=["3d_float32", "2d_walls_float32", "3d_bfloat16"])
def test_segnn_matches_jax_float32_and_bf16(case, cdt, tol):
    """float32 features; acc and the gradients (parameters, vel_hist,
    rel_disp) within the stated fraction of the largest value."""
    jmodel, params, sample, port, feats, ptype, cot = _setup(case, cdt, np.float32)
    want = np.asarray(jmodel.apply({"params": params}, sample)["acc"])
    acc, g_vel, g_disp = _port_grads(port, feats, ptype, cot)
    assert acc.dtype == torch.float32
    _close_to_max(acc.detach().numpy(), want, tol[0], "acc")
    grads = _jax_grads(jmodel, params, sample, cot, wide=False)
    _close_to_max(g_vel.numpy(), grads[1], tol[1], "d/d vel_hist")
    _close_to_max(g_disp.numpy(), grads[2], tol[1], "d/d rel_disp")
    want_p = dict(zip(_paths(grads[0]), jax.tree_util.tree_leaves(grads[0])))
    for path, p, _ in port.jax_leaves():
        _close_to_max(p.grad.numpy(), want_p[path], tol[1], path)


def test_aggregate_mean_matches_jax():
    """The dense mean over each receiver's valid slots, rows without a
    valid slot included (zeros), equal to JAX's."""
    feats, _, _ = _inputs("3d_periodic", np.float64)
    senders = feats["senders"].copy()
    senders[:3] = N  # receivers with no neighbor
    data = np.random.default_rng(2).normal(size=(N, K, 4))
    got = aggregate_mean_to_receivers(torch.as_tensor(data), torch.as_tensor(feats["receivers"]),
                                      torch.as_tensor(senders), N)
    want = jax_mean(jnp.asarray(data), jnp.asarray(feats["receivers"]), jnp.asarray(senders), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[:3].numpy(), 0.0)


def test_features_2d_to_3d_matches_jax():
    feats, _, _ = _inputs("2d_walls_force_types", np.float64)
    got = features_2d_to_3d({k: torch.as_tensor(v) for k, v in feats.items()})
    want = jax_features_2d_to_3d({k: jnp.asarray(v) for k, v in feats.items()})
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert got["bound"].shape == (N, 6) and got["rel_disp"].shape == (N, K, 3)
