"""Port parity: GNS with the standard processor (``models.GNSStandard``, the
JAX package's default ``use_fused_processor=False``) against the JAX GNS,
at 1, 2 and 3 layers per MLP, from one JAX parameter tree.

float64 on both sides: acc within atol 1e-9 (before the models' final
float32 cast), the tolerance of ``tests/test_torch_gns.py``; the gradients
of a loss likewise. The padded slots (fill N) gather row N-1 on both sides
and drop out of the aggregation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.models import GNS as JaxGNS
from lagrangebench_torch.config import Config
from lagrangebench_torch.models import GNS, GNSStandard, build_gns, ensure_fused_params

N, K, DIM, ISL, LATENT, STEPS = 27, 8, 3, 4, 16, 2


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
    ptype[-4:] = -1  # padding wraps to the last embedding row
    return feats, ptype


def _jax_model(blocks, dtype="float64"):
    return JaxGNS(particle_dimension=DIM, latent_size=LATENT, blocks_per_step=blocks,
                  num_mp_steps=STEPS, compute_dtype=dtype)


def _jax_setup(blocks, seed=0):
    """A JAX standard-layout tree (perturbed, float32 leaves as checkpoints
    hold them) and the JAX acc before its final float32 cast."""
    feats, ptype = _features(seed)
    model = _jax_model(blocks)
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    params = model.init(jax.random.PRNGKey(seed), sample)["params"]
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * np.random.default_rng(1).normal(size=x.shape)
                   ).astype(np.float32),
        jax.device_get(params))
    _, inter = model.apply({"params": params}, sample, capture_intermediates=True)
    acc = np.asarray(inter["intermediates"][f"MLP_{2 + 2 * STEPS}"]["__call__"][0])
    return params, acc, feats, ptype, sample, model


def _port(blocks, dtype="float64"):
    return GNSStandard(DIM, node_in=(ISL - 1) * DIM, edge_in=DIM + 1, latent_size=LATENT,
                       blocks_per_step=blocks, num_mp_steps=STEPS, compute_dtype=dtype,
                       device="cpu")


def _acc64(model, feats, ptype):
    """The port's acc before the final float32 cast (the decoder's output)."""
    captured = {}
    handle = model.decoder.register_forward_hook(lambda m, i, o: captured.setdefault("acc", o))
    out = model({k: torch.as_tensor(v) for k, v in feats.items()}, torch.as_tensor(ptype))
    handle.remove()
    return out, captured["acc"]


@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_standard_processor_matches_jax_float64(blocks):
    """acc equal to the JAX standard GNS within 1e-9, the tree read as is;
    the leaves are listed in JAX's flatten order."""
    params, ref, feats, ptype, _, _ = _jax_setup(blocks)
    model = _port(blocks)
    model.load_jax_params(params)
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [leaf[0] for leaf in model.jax_leaves()] == paths
    with torch.no_grad():
        out, acc = _acc64(model, feats, ptype)
    assert out["acc"].dtype == torch.float32
    np.testing.assert_allclose(acc.numpy(), ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_standard_processor_gradients_match_jax(blocks):
    """d(sum acc^2)/d(params) equal to jax.grad of the same loss (float64,
    atol 1e-9 against gradients of O(1)-O(100))."""
    params, _, feats, ptype, sample, jmodel = _jax_setup(blocks)

    def loss(p):
        _, inter = jmodel.apply({"params": p}, sample, capture_intermediates=True)
        return jnp.sum(inter["intermediates"][f"MLP_{2 + 2 * STEPS}"]["__call__"][0] ** 2)

    wide = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    want = {"/".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jax.grad(loss)(wide))[0]}
    model = _port(blocks)
    model.load_jax_params(params)
    model.double()
    _, acc = _acc64(model, feats, ptype)
    (acc**2).sum().backward()
    for path, p, transposed in model.jax_leaves():
        g = p.grad.t() if transposed else p.grad
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-9, atol=1e-9, err_msg=path)


def test_standard_and_fused_layouts_agree():
    """One standard tree through GNSStandard and, converted by
    ensure_fused_params, through the fused GNS (its plain path on the CPU):
    the same acc within 1e-9 in float64; build_gns picks the processor."""
    params, ref, feats, ptype, _, _ = _jax_setup(2)
    cfg = Config({"name": "gns", "fused_processor": True, "num_mlp_layers": 2,
                  "latent_dim": LATENT, "num_mp_steps": STEPS, "input_seq_length": ISL,
                  "magnitude_features": False, "compute_dtype": "float64"})
    meta = {"dim": DIM, "periodic_boundary_conditions": [True] * DIM}
    fused = build_gns(cfg, meta, device="cpu")
    assert isinstance(fused, GNS)
    fused.load_jax_params(ensure_fused_params(params, cfg))
    cfg.fused_processor = False
    standard = build_gns(cfg, meta, device="cpu")
    assert isinstance(standard, GNSStandard)
    standard.load_jax_params(ensure_fused_params(params, cfg))
    with torch.no_grad():
        _, a_std = _acc64(standard, feats, ptype)
        _, a_fused = _acc64(fused, feats, ptype)
    np.testing.assert_allclose(a_std.numpy(), a_fused.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(a_std.numpy(), ref, rtol=0, atol=1e-9)
    cfg.num_mlp_layers = 3
    assert build_gns(cfg, meta, device="cpu").blocks_per_step == 3
    cfg.fused_processor = True
    with pytest.raises(ValueError, match="num_mlp_layers == 2"):
        build_gns(cfg, meta, device="cpu")
    with pytest.raises(ValueError, match="fused-layout"):
        standard.load_jax_params(fused.jax_params())


def test_standard_processor_bfloat16():
    """bf16 compute on the CPU vs the JAX standard GNS in bf16: atol 5e-2 on
    acc (outputs of O(1); the two round bf16 at the same places but sum in
    other orders, which flips single bf16 ulps), as for the fused layout."""
    params, _, feats, ptype, sample, _ = _jax_setup(2)
    ref = np.asarray(_jax_model(2, "bfloat16").apply({"params": params}, sample)["acc"])
    model = _port(2, "bfloat16")
    model.load_jax_params(params)
    with torch.no_grad():
        out, _ = _acc64(model, feats, ptype)
    np.testing.assert_allclose(out["acc"].numpy(), ref, rtol=0, atol=5e-2)
