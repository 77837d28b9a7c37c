"""Port parity: the backward of the fused message-passing step (K4, plain
version) and the autograd Function around K3/K4, against the JAX package:
``jax.vjp`` of its pure-JAX mirror in float64, the Pallas backward kernel
in interpret mode in float32, and its ``custom_vjp`` gradients.

Small sizes: N = 48 receivers, K = 8 slots (30% padded, fill N), F = 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.ops import fused_mp as jax_fmp
from lagrangebench_torch.ops import fused_mp as fmp

N, K, F, FE = 48, 8, 32, 4


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K))
    senders[rng.uniform(size=(N, K)) < 0.3] = N  # padded slots, fill N
    senders[-2:] = N  # receivers with no neighbor at all
    mask = senders < N
    p = {
        name: rng.normal(size=(F, F)) / np.sqrt(F) if name.startswith("w")
        else rng.normal(size=(F,)) * 0.1 + (1.0 if "scale" in name else 0.0)
        for name in fmp.PARAM_NAMES
    }
    enc = {
        "enc_w1": rng.normal(size=(FE, F)) / 2.0,
        "enc_w2": rng.normal(size=(F, F)) / np.sqrt(F),
        "enc_b1": rng.normal(size=(F,)) * 0.1,
        "enc_b2": rng.normal(size=(F,)) * 0.1,
        "enc_ln_scale": 1.0 + 0.1 * rng.normal(size=(F,)),
        "enc_ln_bias": 0.1 * rng.normal(size=(F,)),
    }
    arrays = {
        "e": rng.normal(size=(N, K, F)),
        "raw": rng.normal(size=(N, K, FE)),
        "hs": rng.normal(size=(N, F))[np.minimum(senders, N - 1)],
        "hr": rng.normal(size=(N, F)),
        "h": rng.normal(size=(N, F)),
        "ge": rng.normal(size=(N, K, F)),
        "gh": rng.normal(size=(N, F)),
    }
    arrays = {k: v.astype(dtype) for k, v in arrays.items()}
    arrays["mask"] = mask
    p = {k: v.astype(dtype) for k, v in p.items()}
    enc = {k: v.astype(dtype) for k, v in enc.items()}
    return arrays, p, enc


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _port_grads(arrs, p, enc, use_enc):
    """(de|draw, dhs, dhr, dh, dp, denc) of the port: the plain backward, or
    the autograd Function with the encoder step."""
    t = _t(arrs)
    if not use_enc:
        de, dhs, dhr, dh, dp = fmp.gns_mp_step_bwd_plain(
            t["e"], t["hs"], t["hr"], t["h"], t["mask"], _t(p), t["ge"], t["gh"]
        )
        return de, dhs, dhr, dh, dp, {}
    leaves = {k: v.clone().requires_grad_() for k, v in _t(p).items()}
    eleaves = {k: v.clone().requires_grad_() for k, v in _t(enc).items()}
    ins = {k: t[k].clone().requires_grad_() for k in ("raw", "hs", "hr", "h")}
    e_out, h_out = fmp.gns_mp_step_autograd(
        ins["raw"], ins["hs"], ins["hr"], ins["h"], t["mask"], leaves, eleaves
    )
    torch.autograd.backward([e_out, h_out], [t["ge"], t["gh"]])
    dp = {k: v.grad for k, v in leaves.items() if v.grad is not None}
    denc = {k: v.grad for k, v in eleaves.items()}
    return (ins["raw"].grad, ins["hs"].grad, ins["hr"].grad, ins["h"].grad, dp, denc)


def _jax_vjp(arrs, p, enc, use_enc, step_fn):
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    mask = j["mask"]
    e_in = j["raw"] if use_enc else j["e"]

    def f(e, hs, hr, h, p_, enc_):
        return step_fn(e, hs, hr, h, mask, p_, enc_ if use_enc else None)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    je = {k: jnp.asarray(v) for k, v in enc.items()}
    _, vjp = jax.vjp(f, e_in, j["hs"], j["hr"], j["h"], jp, je)
    return vjp((j["ge"], j["gh"]))


def _compare(port, ref, atol, rtol, use_enc):
    de, dhs, dhr, dh, dp, denc = port
    r_de, r_dhs, r_dhr, r_dh, r_dp, r_denc = ref
    for name, a, b in (("de", de, r_de), ("dhs", dhs, r_dhs), ("dhr", dhr, r_dhr),
                       ("dh", dh, r_dh)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=name)
    for name in fmp.BWD_PARAM_ORDER:
        np.testing.assert_allclose(dp[name].numpy(), np.asarray(r_dp[name]), rtol=rtol,
                                   atol=atol, err_msg=name)
    if use_enc:
        for name in fmp.ENC_PARAM_NAMES:
            np.testing.assert_allclose(denc[name].numpy(), np.asarray(r_denc[name]),
                                       rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("use_enc", [False, True])
def test_plain_bwd_matches_jax_vjp_float64(use_enc):
    """float64: the plain backward (through the encoder with ``enc``) vs
    jax.vjp of gns_mp_step_reference, atol 1e-10."""
    arrs, p, enc = _inputs(0, np.float64)
    port = _port_grads(arrs, p, enc, use_enc)
    ref = _jax_vjp(arrs, p, enc, use_enc, jax_fmp.gns_mp_step_reference)
    _compare(port, ref, atol=1e-10, rtol=0, use_enc=use_enc)


def test_plain_bwd_matches_pallas_interpret_float32():
    """float32: the plain backward vs _gns_mp_step_bwd_pallas(interpret=True),
    rtol = atol = 1e-4 (float32 sums over 48 x 8 rows in another order)."""
    arrs, p, _ = _inputs(1, np.float32)
    t = _t(arrs)
    port = fmp.gns_mp_step_bwd_plain(
        t["e"], t["hs"], t["hr"], t["h"], t["mask"], _t(p), t["ge"], t["gh"]
    )
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    ref = jax_fmp._gns_mp_step_bwd_pallas(
        j["e"], j["hs"], j["hr"], j["h"], j["mask"].astype(jnp.float32),
        {k: jnp.asarray(v) for k, v in p.items()}, (j["ge"], j["gh"]), True, tile=16,
    )
    _compare(port + ({},), ref + ({},), atol=1e-4, rtol=1e-4, use_enc=False)


@pytest.mark.parametrize("use_enc", [False, True])
def test_function_matches_jax_custom_vjp_float32(use_enc):
    """float32: the autograd Function's gradients vs the JAX custom_vjp
    (Pallas forward and backward in interpret mode), rtol = atol = 1e-4."""
    arrs, p, enc = _inputs(2, np.float32)
    t = _t(arrs)
    leaves = {k: v.clone().requires_grad_() for k, v in _t(p).items()}
    eleaves = {k: v.clone().requires_grad_() for k, v in _t(enc).items()}
    ins = {k: t[k].clone().requires_grad_() for k in ("e", "raw", "hs", "hr", "h")}
    e_in = ins["raw"] if use_enc else ins["e"]
    e_out, h_out = fmp.gns_mp_step_autograd(
        e_in, ins["hs"], ins["hr"], ins["h"], t["mask"], leaves, eleaves if use_enc else None
    )
    torch.autograd.backward([e_out, h_out], [t["ge"], t["gh"]])
    port = (e_in.grad, ins["hs"].grad, ins["hr"].grad, ins["h"].grad,
            {k: v.grad for k, v in leaves.items() if v.grad is not None},
            {k: v.grad for k, v in eleaves.items()})

    def step(e, hs, hr, h, mask, p_, enc_):
        return jax_fmp.gns_mp_step(e, hs, hr, h, mask, p_, tile=16, interpret=True, enc=enc_)

    ref = _jax_vjp(arrs, p, enc, use_enc, step)
    _compare(port, ref, atol=1e-4, rtol=1e-4, use_enc=use_enc)


@pytest.mark.parametrize("use_enc", [False, True])
def test_function_gradcheck_float64(use_enc):
    """torch.autograd.gradcheck of the Function on a tiny float64 case."""
    g = torch.Generator().manual_seed(3)
    n, k, f, fe = 5, 3, 6, 2
    p = {name: (torch.randn(f, f, generator=g, dtype=torch.float64) / f**0.5
                if name.startswith("w") else 0.1 * torch.randn(f, generator=g, dtype=torch.float64)
                + (1.0 if "scale" in name else 0.0)) for name in fmp.PARAM_NAMES}
    enc = {"enc_w1": torch.randn(fe, f, generator=g, dtype=torch.float64),
           "enc_w2": torch.randn(f, f, generator=g, dtype=torch.float64) / f**0.5,
           "enc_b1": 0.1 * torch.randn(f, generator=g, dtype=torch.float64),
           "enc_b2": 0.1 * torch.randn(f, generator=g, dtype=torch.float64),
           "enc_ln_scale": torch.ones(f, dtype=torch.float64),
           "enc_ln_bias": torch.zeros(f, dtype=torch.float64)}
    e = torch.randn(n, k, fe if use_enc else f, generator=g, dtype=torch.float64)
    hs = torch.randn(n, k, f, generator=g, dtype=torch.float64)
    hr = torch.randn(n, f, generator=g, dtype=torch.float64)
    h = torch.randn(n, f, generator=g, dtype=torch.float64)
    mask = (torch.rand(n, k, generator=g) < 0.7).to(torch.float32)
    names = list(fmp.BWD_PARAM_ORDER)
    enames = list(fmp.ENC_PARAM_NAMES) if use_enc else []

    def fn(e, hs, hr, h, *params):
        pd = dict(zip(names, params[:len(names)]))
        ed = dict(zip(enames, params[len(names):])) if use_enc else None
        return fmp.gns_mp_step_autograd(e, hs, hr, h, mask, pd, ed)

    inputs = [t.requires_grad_() for t in [e, hs, hr, h] + [p[x] for x in names]
              + [enc[x] for x in enames]]
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("use_enc", [False, True])
def test_padded_slots_get_zero_gradient(use_enc):
    """With no cotangent on padded slots (as after the last step, where e'
    is unused), de and dhs are exactly zero there: the mask removes padded
    messages from agg, so nothing flows back to the clamped gather row."""
    arrs, p, enc = _inputs(4, np.float64)
    arrs["ge"] = np.where(arrs["mask"][..., None], arrs["ge"], 0.0)
    de, dhs, _, _, _, _ = _port_grads(arrs, p, enc, use_enc)
    padded = ~arrs["mask"]
    assert padded.any()
    assert np.all(dhs.detach().numpy()[padded] == 0.0)
    assert np.all(de.detach().numpy()[padded] == 0.0)
