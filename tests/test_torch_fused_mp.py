"""Port parity: the fused message-passing step K3 (plain version) against
the JAX package: its pure-JAX mirror in float64 and the Pallas kernel in
interpret mode in float32, in both variants (plain and encoder-folded),
with padded slots (fill index) and masked rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.ops import fused_mp as jax_fmp
from lagrangebench_torch.ops import fused_mp as fmp

N, K, F, FE = 40, 8, 32, 4


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K))
    senders[rng.uniform(size=(N, K)) < 0.3] = N  # padded slots, fill N
    senders[-3:] = N  # receivers with no neighbor at all
    mask = senders < N
    hs_proj = rng.normal(size=(N, F))
    gath = hs_proj[np.minimum(senders, N - 1)]  # the clamped gather
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
        "hs": gath,
        "hr": rng.normal(size=(N, F)),
        "h": rng.normal(size=(N, F)),
        "mask": mask,
    }
    cast = {k: v.astype(dtype) if v.dtype.kind == "f" else v for k, v in arrays.items()}
    # parameters stay float32 arrays, as in the Flax tree
    p = {k: v.astype(np.float32) for k, v in p.items()}
    enc = {k: v.astype(np.float32) for k, v in enc.items()}
    return cast, p, enc


def _run_port(arrs, p, enc, use_enc):
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    et = {k: torch.as_tensor(v) for k, v in enc.items()} if use_enc else None
    e_in = t["raw"] if use_enc else t["e"]
    e_out, h_out = fmp.gns_mp_step(e_in, t["hs"], t["hr"], t["h"], t["mask"], pt, enc=et)
    return e_out.numpy(), h_out.numpy()


@pytest.mark.parametrize("use_enc", [False, True])
def test_plain_matches_jax_mirror_float64(use_enc):
    """float64: plain version vs gns_mp_step_reference, atol 1e-10."""
    arrs, p, enc = _inputs(0, np.float64)
    e_in = arrs["raw"] if use_enc else arrs["e"]
    ref_e, ref_h = jax_fmp.gns_mp_step_reference(
        jnp.asarray(e_in), jnp.asarray(arrs["hs"]), jnp.asarray(arrs["hr"]),
        jnp.asarray(arrs["h"]), jnp.asarray(arrs["mask"]),
        {k: jnp.asarray(v) for k, v in p.items()},
        enc={k: jnp.asarray(v) for k, v in enc.items()} if use_enc else None,
    )
    e_out, h_out = _run_port(arrs, p, enc, use_enc)
    assert e_out.dtype == np.float64 and h_out.dtype == np.float64
    np.testing.assert_allclose(e_out, np.asarray(ref_e), rtol=0, atol=1e-10)
    np.testing.assert_allclose(h_out, np.asarray(ref_h), rtol=0, atol=1e-10)


@pytest.mark.parametrize("use_enc", [False, True])
def test_plain_matches_pallas_interpret_float32(use_enc):
    """float32: plain version vs the Pallas kernel (interpret=True),
    atol = rtol = 1e-5 (float32 sums in another order)."""
    arrs, p, enc = _inputs(1, np.float32)
    e_in = arrs["raw"] if use_enc else arrs["e"]
    ref_e, ref_h = jax_fmp.gns_mp_step(
        jnp.asarray(e_in), jnp.asarray(arrs["hs"]), jnp.asarray(arrs["hr"]),
        jnp.asarray(arrs["h"]), jnp.asarray(arrs["mask"]),
        {k: jnp.asarray(v) for k, v in p.items()},
        tile=16, interpret=True,
        enc={k: jnp.asarray(v) for k, v in enc.items()} if use_enc else None,
    )
    e_out, h_out = _run_port(arrs, p, enc, use_enc)
    np.testing.assert_allclose(e_out, np.asarray(ref_e), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_out, np.asarray(ref_h), rtol=1e-5, atol=1e-5)


def test_padded_rows_keep_their_edge_latents_finite():
    """Receivers with no valid slot get h' = h + LN(MLP(h)) (agg = 0), and
    every padded slot of e' is finite, as in the JAX step."""
    arrs, p, enc = _inputs(2, np.float64)
    e_out, h_out = _run_port(arrs, p, enc, use_enc=True)
    assert np.isfinite(e_out).all() and np.isfinite(h_out).all()
    agg0 = {k: torch.as_tensor(v) for k, v in arrs.items()}
    agg0["mask"] = torch.zeros_like(agg0["mask"])
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    _, h_nomsg = fmp.gns_mp_step_plain(
        agg0["e"], agg0["hs"], agg0["hr"], agg0["h"], agg0["mask"], pt
    )
    _, h_ref = _run_port(arrs, p, enc, use_enc=False)
    np.testing.assert_allclose(h_ref[-3:], h_nomsg.numpy()[-3:], rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,k,sms,want", [
    (16000, 40, 132, (132, 125)),  # the rollout shape: one block per SM; 1,000 node slices
    (14960, 40, 132, (132, 117)),  # the slot layout's rows at batch 1
    (1, 1, 132, (1, 1)),
    (17, 7, 132, (1, 1)),          # 8 edge slices, 2 node slices: one block each
    (1000, 24, 132, (132, 8)),
    (1000, 1, 132, (8, 8)),
    (16000, 40, 1, (1, 1)),
])
def test_mp_grids(n, k, sms, want):
    """The bf16 kernels' grids: at most one block per SM, and no block whose
    8 warps would not get a 16-row slice each (edge rows for the edge
    kernel, nodes for the node kernel)."""
    assert fmp.mp_grids(n, k, sms) == want


@pytest.mark.parametrize("n", [1, 17, 1000, 16000])
@pytest.mark.parametrize("k", [1, 7, 40])
def test_mp_grids_cover_every_slice(n, k):
    """Each block of the edge grid has work for all 8 warps, or is the
    only block; the node grid likewise; neither exceeds the SMs."""
    for sms in (1, 7, 132):
        edge, node = fmp.mp_grids(n, k, sms)
        edge_slices, node_slices = -(-n * k // 16), -(-n // 16)
        assert 1 <= edge <= sms and 1 <= node <= sms
        assert edge == 1 or (edge - 1) * 8 < edge_slices
        assert node == 1 or (node - 1) * 8 < node_slices


@pytest.mark.parametrize("f", fmp.LATENTS)
@pytest.mark.parametrize("n,grid", [(1, 1), (16000, 132), (1000, 63)])
def test_bwd_partials_floats(n, grid, f):
    """K4's partials at each compiled width: float32, grid x the 13
    gradients; bf16, the node kernel's 64-node blocks of 3 matrices and 4
    vectors, then the edge kernels' blocks of dW2 with 4 vectors and of
    dW_e, which together hold each of the 13 gradients once per block of
    its kernel."""
    per_block = 5 * f * f + 8 * f
    assert fmp.bwd_partials_floats(n, grid, False, f) == grid * per_block
    node_blocks = -(-n // 64)
    got = fmp.bwd_partials_floats(n, grid, True, f)
    assert got == node_blocks * (3 * f * f + 4 * f) + grid * (f * f + 4 * f) + grid * f * f
    assert (3 * f * f + 4 * f) + (f * f + 4 * f) + f * f == per_block
