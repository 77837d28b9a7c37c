"""Port parity: GNS with the fused processor, the weight bridge from JAX
parameter trees (fused and standard layouts) and params.npz checkpoints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu import checkpoint as jax_ckp
from lagrangebench_tpu.models import GNS as JaxGNS
from lagrangebench_torch import checkpoint
from lagrangebench_torch.models import GNS, fused_params_from_standard

N, K, DIM, ISL, LATENT, STEPS = 48, 8, 3, 4, 32, 2


def _features(seed):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K)).astype(np.int32)
    senders[rng.uniform(size=(N, K)) < 0.3] = N
    valid = (senders < N)[..., None]
    rel_disp = np.where(valid, rng.uniform(-1, 1, size=(N, K, DIM)), 0.0)
    feats = {
        "vel_hist": rng.normal(size=(N, (ISL - 1) * DIM)),
        "senders": senders,
        "receivers": np.broadcast_to(np.arange(N, dtype=np.int32)[:, None], (N, K)).copy(),
        "rel_disp": rel_disp,
        "rel_dist": np.linalg.norm(rel_disp, axis=-1, keepdims=True),
    }
    ptype = rng.integers(0, 3, size=N).astype(np.int32)
    ptype[-5:] = -1  # padding wraps to the last embedding row
    return feats, ptype


def _jax_params(fused: bool, dtype: str, seed=0):
    feats, ptype = _features(seed)
    model = JaxGNS(particle_dimension=DIM, latent_size=LATENT, num_mp_steps=STEPS,
                   use_fused_processor=fused, compute_dtype=dtype)
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    params = model.init(jax.random.PRNGKey(seed), sample)["params"]
    # perturb zero biases / unit scales so every parameter matters; keep
    # float32 leaves, as checkpoints hold (x64 mode would make the fused
    # layout's flat arrays float64)
    params = jax.tree.map(
        lambda x: (
            np.asarray(x) + 0.05 * np.random.default_rng(1).normal(size=x.shape)
        ).astype(np.float32),
        jax.device_get(params),
    )
    acc = model.apply({"params": params}, sample)["acc"]
    return params, np.asarray(acc), feats, ptype


def _port(dtype: str):
    return GNS(DIM, node_in=(ISL - 1) * DIM, edge_in=DIM + 1, latent_size=LATENT,
               num_mp_steps=STEPS, compute_dtype=dtype, device="cpu")


def _port_acc(model, feats, ptype):
    with torch.no_grad():
        out = model({k: torch.as_tensor(v) for k, v in feats.items()}, torch.as_tensor(ptype))
    return out["acc"].numpy()


@pytest.mark.parametrize("fused", [True, False], ids=["fused_layout", "standard_layout"])
def test_bridge_float64(fused):
    """JAX-initialised params (fused or standard layout) give the same acc
    in float64: atol 1e-9."""
    params, ref_acc, feats, ptype = _jax_params(fused, "float64")
    model = _port("float64")
    model.load_jax_params(params)
    acc = _port_acc(model, feats, ptype)
    assert acc.dtype == np.float32 and ref_acc.dtype == np.float32
    # both sides return float32 (the models' contract); compare before
    # that rounding by running the port in float64 internally
    np.testing.assert_allclose(acc, ref_acc, rtol=0, atol=1e-6)
    feats_t = {k: torch.as_tensor(v) for k, v in feats.items()}
    h64 = _hidden_acc64(model, feats_t, torch.as_tensor(ptype))
    ref64 = _jax_acc64(params, fused, feats, ptype)
    np.testing.assert_allclose(h64, ref64, rtol=0, atol=1e-9)


def _hidden_acc64(model, feats, ptype):
    """The port's acc before the final float32 cast."""
    captured = {}
    handle = model.decoder.register_forward_hook(lambda m, i, o: captured.setdefault("acc", o))
    with torch.no_grad():
        model(feats, ptype)
    handle.remove()
    return captured["acc"].numpy()


def _jax_acc64(params, fused, feats, ptype):
    """The JAX model's acc before its final float32 cast."""
    model = JaxGNS(particle_dimension=DIM, latent_size=LATENT, num_mp_steps=STEPS,
                   use_fused_processor=fused, compute_dtype="float64")
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    _, inter = model.apply({"params": params}, sample, capture_intermediates=True)
    last_mlp = "MLP_1" if fused else f"MLP_{2 + 2 * STEPS}"
    return np.asarray(inter["intermediates"][last_mlp]["__call__"][0])


def test_bridge_bfloat16():
    """bf16 compute on the CPU: the port's plain path vs the JAX mirror,
    atol 0.05 on acc (outputs of O(1); the two round bf16 at the same
    places but sum in other orders, which flips single bf16 ulps)."""
    params, ref_acc, feats, ptype = _jax_params(True, "bfloat16")
    model = _port("bfloat16")
    model.load_jax_params(params)
    acc = _port_acc(model, feats, ptype)
    np.testing.assert_allclose(acc, ref_acc, rtol=0, atol=5e-2)


def test_standard_to_fused_conversion_matches_jax():
    """The port's fused_params_from_standard equals the JAX package's."""
    from lagrangebench_tpu.models.gns import fused_params_from_standard as jax_conv

    params, _, _, _ = _jax_params(False, "float64")
    ours = fused_params_from_standard(params, STEPS)
    theirs = jax.device_get(jax_conv(params, STEPS))
    flat_a = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k]), np.asarray(flat_b[k]))


def test_checkpoint_roundtrip_with_jax(tmp_path):
    """params.npz written by the JAX package loads into the port, and the
    port's params.npz loads back into the JAX package, leaf for leaf."""
    params, ref_acc, feats, ptype = _jax_params(True, "float32")
    jax_dir = str(tmp_path / "jax")
    jax_ckp.save_checkpoint(jax_dir, params, {}, None, {"step": 3, "loss": 1.0})
    loaded, _, _, step = checkpoint.load_checkpoint(jax_dir)
    assert step == 3
    model = _port("float32")
    model.load_jax_params(loaded)
    np.testing.assert_allclose(_port_acc(model, feats, ptype), ref_acc, rtol=0, atol=1e-5)

    port_dir = str(tmp_path / "port")
    checkpoint.save_checkpoint(port_dir, model.jax_params(), {}, {"step": 4, "loss": 0.5})
    back, _, _, step = jax_ckp.load_checkpoint(port_dir)
    assert step == 4
    flat_a = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k], np.float32), flat_b[k])
