"""Port parity: the Linear model (``models.Linear``) against the JAX
package's ``Linear`` from one parameter tree: float64 acc within atol 1e-9
(the tolerance of ``tests/test_torch_gns.py``), the float32 path, the
factory and a ``params.npz`` round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lagrangebench_tpu import checkpoint as jax_ckp
from lagrangebench_tpu.models import Linear as JaxLinear
from lagrangebench_torch import checkpoint
from lagrangebench_torch.config import Config
from lagrangebench_torch.models import Linear, setup_model

N, DIM, ISL = 27, 2, 4


def _setup(dtype):
    rng = np.random.default_rng(0)
    feats = {"vel_hist": rng.normal(size=(N, (ISL - 1) * DIM)).astype(dtype),
             "vel_mag": rng.normal(size=(N, ISL - 1)).astype(dtype),
             "bound": rng.uniform(-1, 1, size=(N, 2 * DIM)).astype(dtype)}
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.zeros(N, jnp.int32))
    model = JaxLinear(dimension_out=DIM)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), sample)["params"])
    params = jax.tree.map(
        lambda x: (x + 0.1 * np.random.default_rng(1).normal(size=x.shape)).astype(np.float32),
        params)
    ref = np.asarray(model.apply({"params": params}, sample)["acc"])
    return params, ref, {k: torch.as_tensor(v) for k, v in feats.items()}


def _port(params, node_in):
    model = Linear(node_in, DIM, device="cpu")
    model.load_jax_params(params)
    return model


def test_linear_matches_jax_float64():
    params, ref, feats = _setup(np.float64)
    model = _port(params, feats["vel_hist"].shape[1] + ISL - 1 + 2 * DIM)
    with torch.no_grad():
        acc = model(feats, torch.zeros(N, dtype=torch.int64))["acc"]
    assert acc.dtype == torch.float64
    np.testing.assert_allclose(acc.numpy(), ref, rtol=0, atol=1e-9)


def test_linear_matches_jax_float32():
    """float32 features: float32 products on both sides ("highest" in JAX),
    atol 1e-6 for outputs of O(1) (summation order)."""
    params, ref, feats = _setup(np.float32)
    model = _port(params, feats["vel_hist"].shape[1] + ISL - 1 + 2 * DIM)
    with torch.no_grad():
        acc = model(feats, torch.zeros(N, dtype=torch.int64))["acc"]
    assert acc.dtype == torch.float32
    np.testing.assert_allclose(acc.numpy(), ref, rtol=0, atol=1e-6)


def test_linear_factory_and_checkpoint(tmp_path):
    """setup_model builds Linear for the case's node features (here free
    walls: the bound features, and the magnitudes); a params.npz written by
    the JAX package loads leaf for leaf and comes back unchanged."""
    params, ref, feats = _setup(np.float64)
    cfg = Config({"name": "linear", "input_seq_length": ISL, "magnitude_features": True})
    meta = {"dim": DIM, "periodic_boundary_conditions": [False] * DIM}
    model = setup_model(cfg, meta, device="cpu")
    assert isinstance(model, Linear)
    jax_ckp.save_checkpoint(str(tmp_path), params, {}, None, {"step": 1, "loss": 0.5})
    loaded, _, _, _ = checkpoint.load_checkpoint(str(tmp_path))
    model.load_jax_params(loaded)
    with torch.no_grad():
        acc = model(feats, torch.zeros(N, dtype=torch.int64))["acc"]
    np.testing.assert_allclose(acc.numpy(), ref, rtol=0, atol=1e-9)
    back = model.jax_params()
    for key in ("kernel", "bias"):
        np.testing.assert_array_equal(back["Dense_0"][key], params["Dense_0"][key])
