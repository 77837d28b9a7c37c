"""The fused GNS step past latent width 256 and K5 past H = 256 and R = 64,
on the CPU.

On the card these widths run the wide path (``csrc/mp_wide.cuh``: a
hand-written product per GEMM of the step, then LayerNorm / residual /
K-sum row kernels) and K5's tensor-core design (``csrc/painn_layer.cu``
painn_edge_tc, painn_node_tc; its own CPU tests are in
``test_torch_painn_tc.py``); here the plain versions hold the arithmetic those
kernels repeat, and these tests hold the plain versions and the host half
of the CUDA path (the padding of tensors and weights to 64 ceil(F / 64),
the true-width LayerNorm, the launch plan) against the JAX package:

* the step (plain and encoder-folded) and its VJP at F = 320 and 512, at
  the true width and in the card's padded layout (300 and 480 run at 320
  and 512 on zero-padded tensors), against JAX's fused step and
  ``jax.vjp`` of it, float64;
* the wide path's launch plan for every F from 257 to 1,088 (past the old
  limit of 1,024): its largest block within a block's 227 KB of shared
  memory, its grids, its weight-gradient row ranges, its partials;
* K5's plain version at H = 320, R = 96 and H = 512, R = 20 against JAX's
  ``_layer_kernel`` in Pallas interpret mode, float32;
* GNS-2-320 from JAX weights carried across (``load_jax_params``): its
  forward and one training step's loss and gradients against JAX, float64;
  and the reference checkpoint export and import at F = 320.

Tolerances: float64 comparisons 1e-10 of the largest magnitude of each
compared array (the same float64 sums in other orders); K5 in float32 1e-5
of the largest magnitude (float32 sums of 96 basis terms and 320-640
channel products in other orders); the training loss rtol 1e-12 and its
gradients 1e-9 of the largest magnitude of each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.models import GNS as JaxGNS
from lagrangebench_tpu.models.base import make_model_fns
from lagrangebench_tpu.ops import fused_mp as jax_fmp
from lagrangebench_tpu.ops import painn_msg as jax_painn_msg
from lagrangebench_tpu.train import trainer as jax_trainer
from lagrangebench_torch import compat
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.data.synthetic import make_synthetic_arrays
from lagrangebench_torch.models import GNS, fused_params_from_standard
from lagrangebench_torch.ops import fused_mp as fmp
from lagrangebench_torch.ops import painn_msg
from lagrangebench_torch.train import flat_mse_loss

N, K, FE, DIM, ISL = 24, 5, 4, 3, 4
TOL = 1e-10


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


# ---------------------------------------------------------------------------
# the step and its VJP
# ---------------------------------------------------------------------------

def _inputs(f, seed):
    """Seeded float64 inputs of one step at width f: 30% padded slots, two
    receivers with none, cotangents."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K))
    senders[rng.uniform(size=(N, K)) < 0.3] = N
    senders[-2:] = N
    p = {name: rng.normal(size=(f, f)) / np.sqrt(f) if name.startswith("w")
         else rng.normal(size=(f,)) * 0.1 + (1.0 if "scale" in name else 0.0)
         for name in fmp.PARAM_NAMES}
    enc = {"enc_w1": rng.normal(size=(FE, f)) / 2.0,
           "enc_w2": rng.normal(size=(f, f)) / np.sqrt(f),
           "enc_b1": rng.normal(size=(f,)) * 0.1, "enc_b2": rng.normal(size=(f,)) * 0.1,
           "enc_ln_scale": 1.0 + 0.1 * rng.normal(size=(f,)),
           "enc_ln_bias": 0.1 * rng.normal(size=(f,))}
    arrays = {"e": rng.normal(size=(N, K, f)), "raw": rng.normal(size=(N, K, FE)),
              "hs": rng.normal(size=(N, f))[np.minimum(senders, N - 1)],
              "hr": rng.normal(size=(N, f)), "h": rng.normal(size=(N, f)),
              "ge": rng.normal(size=(N, K, f)), "gh": rng.normal(size=(N, f)),
              "mask": senders < N}
    return arrays, p, enc


def _jax_step(arrs, p, enc, use_enc):
    """JAX's outputs and VJP: ((e', h'), (de|draw, dhs, dhr, dh, dp, denc))."""
    j = {k: jnp.asarray(v) for k, v in arrs.items()}

    def step(e, hs, hr, h, p_, enc_):
        return jax_fmp.gns_mp_step_reference(e, hs, hr, h, j["mask"], p_,
                                             enc_ if use_enc else None)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    je = {k: jnp.asarray(v) for k, v in enc.items()}
    out, vjp = jax.vjp(step, j["raw"] if use_enc else j["e"], j["hs"], j["hr"], j["h"], jp, je)
    return out, vjp((j["ge"], j["gh"]))


# (true width, the width it runs at on the card)
WIDE_CASES = [(320, 320), (512, 512), (300, 320), (480, 512)]


@pytest.mark.parametrize("use_enc", [False, True], ids=["plain_step", "encoder_step"])
@pytest.mark.parametrize("f,width", WIDE_CASES)
def test_wide_step_matches_jax_float64(f, width, use_enc):
    """K3's plain version in the card's layout past 256 (the tensors
    zero-padded to ``kernel_width(f)`` with ``pad_last``, the parameters with
    ``pad_params``, LayerNorm over the true width) against JAX's fused step
    at the true width; the padded channels come out exactly 0; and
    ``at_true_width`` on CPU tensors (its CPU branch: the plain version at
    the true width) gives the same values."""
    assert fmp.kernel_width(f) == width and fmp._design(torch.bfloat16, width) == "wgmma"
    assert fmp._design(torch.float32, width) == "wide"
    arrs, p, enc = _inputs(f, seed=f)
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    te = {k: torch.as_tensor(v) for k, v in enc.items()} if use_enc else None
    first = t["raw"] if use_enc else fmp.pad_last(t["e"], width)
    e_out, h_out = fmp.gns_mp_step(
        first, *(fmp.pad_last(t[k], width) for k in ("hs", "hr", "h")), t["mask"],
        fmp.pad_params(tp, width), fmp.pad_params(te, width) if use_enc else None, latent=f)
    (want_e, want_h), _ = _jax_step(arrs, p, enc, use_enc)
    assert e_out.shape == (N, K, width) and h_out.shape == (N, width)
    assert not e_out[..., f:].any() and not h_out[..., f:].any()
    _close(e_out[..., :f].numpy(), want_e, name="e'")
    _close(h_out[..., :f].numpy(), want_h, name="h'")
    got = fmp.at_true_width("gns_mp_step", t["raw"] if use_enc else t["e"], t["hs"], t["hr"],
                            t["h"], t["mask"], tp, te, latent=f)
    _close(got[0].numpy(), want_e, name="e' (at_true_width)")
    _close(got[1].numpy(), want_h, name="h' (at_true_width)")


@pytest.mark.parametrize("use_enc", [False, True], ids=["plain_step", "encoder_step"])
@pytest.mark.parametrize("f,width", WIDE_CASES)
def test_wide_step_vjp_matches_jax_float64(f, width, use_enc):
    """The autograd Function on padded latents (K4's plain version at the
    padded width; the encoder's plain backward on step 0) against
    ``jax.vjp`` of JAX's fused step at the true width: the outputs, the
    input cotangents and the 13 (19) parameter gradients, which come back
    at the parameters' true width."""
    arrs, p, enc = _inputs(f, seed=f + 1)
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    leaves = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    eleaves = {k: torch.as_tensor(v).requires_grad_() for k, v in enc.items()}
    ins = {k: fmp.pad_last(t[k], width).requires_grad_() for k in ("e", "hs", "hr", "h")}
    ins["raw"] = t["raw"].clone().requires_grad_()
    e_out, h_out = fmp.gns_mp_step_autograd(
        ins["raw"] if use_enc else ins["e"], ins["hs"], ins["hr"], ins["h"], t["mask"], leaves,
        eleaves if use_enc else None, latent=f)
    torch.autograd.backward([e_out, h_out],
                            [fmp.pad_last(t["ge"], width), fmp.pad_last(t["gh"], width)])
    (want_e, want_h), grads = _jax_step(arrs, p, enc, use_enc)
    _close(e_out[..., :f].detach().numpy(), want_e, name="e'")
    _close(h_out[..., :f].detach().numpy(), want_h, name="h'")
    first = ins["raw"].grad if use_enc else ins["e"].grad[..., :f]
    for name, a, b in zip(("de", "dhs", "dhr", "dh"),
                          (first, ins["hs"].grad[..., :f], ins["hr"].grad[..., :f],
                           ins["h"].grad[..., :f]), grads[:4]):
        _close(a.numpy(), b, name=name)
    for name in fmp.BWD_PARAM_ORDER:
        assert leaves[name].grad.shape == leaves[name].shape
        _close(leaves[name].grad.numpy(), grads[4][name], name=name)
    if use_enc:
        for name in fmp.ENC_PARAM_NAMES:
            _close(eleaves[name].grad.numpy(), grads[5][name], name=name)


@pytest.mark.parametrize("f,width", WIDE_CASES)
def test_wide_bwd_plain_padded_matches_jax_float64(f, width):
    """K4's wrapper on CPU tensors in the card's layout (the tensors padded,
    the parameters in the kernel's layout padded with ``pad_params``):
    the input cotangents against ``jax.vjp``, zero past the true width; the
    parameter gradients against JAX's within their first f rows and
    columns, zero past them."""
    arrs, p, enc = _inputs(f, seed=f + 2)
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    kp = fmp.kernel_params({k: torch.as_tensor(v) for k, v in p.items()}, torch.float64, width)
    de, dhs, dhr, dh, dp = fmp.gns_mp_step_bwd(
        *(fmp.pad_last(t[k], width) for k in ("e", "hs", "hr", "h")), t["mask"], kp,
        fmp.pad_last(t["ge"], width), fmp.pad_last(t["gh"], width), latent=f)
    _, grads = _jax_step(arrs, p, enc, False)
    for name, a, b in zip(("de", "dhs", "dhr", "dh"), (de, dhs, dhr, dh), grads[:4]):
        assert a.shape[-1] == width and not a[..., f:].any(), name
        _close(a[..., :f].numpy(), b, name=name)
    for name in fmp.BWD_PARAM_ORDER:
        g = dp[name].clone()
        inner = g[(slice(0, f),) * g.dim()].clone()
        g[(slice(0, f),) * g.dim()] = 0
        assert not g.any(), name
        _close(inner.numpy(), grads[4][name], name=name)


# ---------------------------------------------------------------------------
# the launch plan of the wide path, as plain Python
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1, 1), (17, 7), (16000, 40)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_plan_fits_every_width(n, k, dtype):
    """For every F from 257 to 1,088 (at its card width 64 ceil(F / 64)) on
    a 132-SM card: the largest block's shared memory within 227 KB; the
    product grids cover every edge and node row and every column; the
    weight gradients' row ranges are whole 32-row chunks that cover the
    rows once, in order (``tn_rows``), and fill about two waves (the wgmma
    design's dW_e and dW2: whole 64-row chunks, ``wgmma_tn_rows``, about
    four waves of its 128 x 128 tiles); the row kernels take whole blocks
    of 8 warps; and K4's partials hold each range's F x F partial and each
    warp's four vectors (the wgmma design's edge side: 4 per block of its
    edge-backward kernel)."""
    sms = 132
    tile = fmp.WIDE_TILE if dtype == torch.bfloat16 else 64
    for f in range(257, 1089):
        width = fmp.kernel_width(f)
        assert width % 64 == 0 and f <= width < f + 64
        wgmma = dtype == torch.bfloat16 and width <= fmp.WGMMA_MAX
        assert fmp._design(dtype, width) == ("wgmma" if wgmma else "wide")
        plan = fmp.wide_plan(n, k, width, sms, dtype)
        assert plan["design"] == fmp._design(dtype, width)
        assert plan["smem_bytes"] == fmp.wide_smem_bytes(dtype, width) <= fmp.SMEM_LIMIT
        if wgmma:  # the edge kernel: 64-row tiles, its agg partials, a persistent grid
            assert plan["smem_bytes"] == fmp.wgmma_smem_bytes(width) > fmp.wide_smem_bytes(dtype)
            assert plan["tiles"] * 64 >= n * k > (plan["tiles"] - 1) * 64
            assert plan["slots"] == fmp.wgmma_slots(k) and plan["cluster"] == 2
            assert plan["partials"] == plan["tiles"] * plan["slots"] * width
            assert plan["edge_ctas"] % 2 == 0 and 2 <= plan["edge_ctas"] <= sms
            assert plan["edge_ctas"] <= plan["tiles"] + 1 and plan["edge_stages"] >= 3
            side = -(-width // fmp.WGMMA_TN_TILE)
            assert plan["r_e"] == fmp.wgmma_tn_ranges(n * k, width, sms)
            assert plan["tn_grid"][0] == (side * side, plan["r_e"], 2)
            assert plan["tn_smem"] == fmp.wgmma_tn_smem_bytes() <= fmp.SMEM_LIMIT
            assert plan["p_e"] == 4 * plan["edge_ctas"]
        else:
            assert plan["smem_bytes"] == fmp.wide_smem_bytes(dtype) and "tiles" not in plan
        assert plan["edge_grid"][0] * tile >= n * k and plan["node_grid"][0] * tile >= n
        assert plan["edge_grid"][1] * tile >= width > (plan["edge_grid"][1] - 1) * tile
        edge_tn = ((fmp.wgmma_tn_rows, 64, -(-width // fmp.WGMMA_TN_TILE) ** 2 * 2, 4) if wgmma
                   else (fmp.tn_rows, 32, plan["edge_grid"][1] ** 2, 2))
        for rows, r, (spans_of, chunk, tiles, waves) in (
                (n * k, plan["r_e"], edge_tn),
                (n, plan["r_n"], (fmp.tn_rows, 32, plan["edge_grid"][1] ** 2, 2))):
            assert 1 <= r <= -(-rows // chunk)
            spans = [spans_of(rows, r, i) for i in range(r)]
            assert spans[0][0] == 0 and spans[-1][1] == rows
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert all(lo % chunk == 0 and lo < hi for lo, hi in spans)
            assert tiles * r <= waves * sms + tiles or r == -(-rows // chunk)
        assert plan["p_n"] % plan["row_warps"] == 0 and plan["p_n"] <= 8 * 2 * sms
        assert plan["p_e"] == plan["p_n"] or wgmma
        ints = fmp._wide_plan_ints(plan)
        assert fmp.bwd_partials_floats(n, 1, dtype == torch.bfloat16, width, ints) == (
            (2 * plan["r_e"] + 3 * plan["r_n"]) * width * width
            + (plan["p_e"] + plan["p_n"]) * 4 * width)


def test_wide_smem_bytes():
    """The bf16 product's ring: 3 stages of the largest layout (A @ W^T:
    a 128 x 40 A tile and a 128 x 40 B tile of bf16), 60 KB; float32 two
    16 x 68 tiles. The wgmma edge kernel (bf16, F in (256, 512]): the E and
    R tiles, as many 32 x F weight slabs as fit (at most 6), the LayerNorm
    exchange, the barriers and 1 KB to align, within 232,448 bytes; past
    512 and in float32 the wide path's own."""
    assert fmp.wide_smem_bytes(torch.bfloat16) == 3 * (128 * 40 + 128 * 40) * 2 == 61440
    assert fmp.wide_smem_bytes(torch.float32) == 2 * 16 * 68 * 4
    stages = {320: 6, 384: 5, 448: 4, 512: 3}
    for f, n in stages.items():
        assert fmp.wgmma_stages(f) == n
        want = 2 * 64 * f * 2 + n * 32 * f * 2 + 1024 + (2 * n + 4) * 8 + 1024
        assert fmp.wgmma_smem_bytes(f) == want == fmp.wide_smem_bytes(torch.bfloat16, f)
        assert want <= fmp.SMEM_LIMIT < want + 32 * f * 2 or n == 6
    assert fmp.wgmma_smem_bytes(512) == 231504
    for f in (576, 1024):
        assert fmp.wide_smem_bytes(torch.bfloat16, f) == 61440
    assert fmp.wide_smem_bytes(torch.float32, 512) == 2 * 16 * 68 * 4
    assert [fmp.wgmma_slots(k) for k in (1, 13, 24, 40, 63, 64, 65, 130)] == [
        64, 6, 4, 3, 3, 2, 2, 2]


def test_wide_limits():
    """The widths the card takes: any F from 1 on (the compiled instances to
    256, the wide path above, its row kernels in 1,024-column chunks past
    1,024), K5 any H and R (the tensor-core design past 256 and 64): the
    old limits (F and H 1,024, R 256) are gone and no width raises for
    being wide; device memory is the one limit."""
    assert fmp.kernel_width(257) == 320 and fmp.kernel_width(1024) == 1024
    assert fmp.kernel_width(1025) == fmp.kernel_width(1088) == 1088
    assert fmp.INSTANCES[-1] == 256 and fmp._design(torch.float32, 256) == "tile"
    assert fmp._design(torch.bfloat16, 1088) == fmp._design(torch.float32, 1088) == "wide"
    fmp.check_latent(1024, "fused_mp")
    fmp.check_latent(1088, "fused_mp")
    assert not hasattr(fmp, "MAX_LATENT") and not hasattr(painn_msg, "MAX_HIDDEN")
    assert painn_msg.is_tensor_core(1088, 20) and painn_msg.is_tensor_core(64, 264)
    assert painn_msg.tc_widths(1088, 264, torch.float32) == (1088, 264)


# ---------------------------------------------------------------------------
# K5 at H = 320, R = 96
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,r,dim", [pytest.param(320, 96, 2, id="2"),
                                     pytest.param(320, 96, 3, id="3"),
                                     pytest.param(512, 20, 2, id="512-20-2"),
                                     pytest.param(512, 20, 3, id="512-20-3")])
def test_painn_layer_plain_wide_matches_jax_interpret(h, r, dim):
    """K5's plain version (the gather inside) at H = 320, R = 96 and at
    PaiNN-5-512's H = 512, R = 20 against the JAX package's Pallas layer
    kernel (``_layer_kernel``) in interpret mode on the gathered rows,
    float32: 1e-5 of the largest magnitude."""
    n, k = 20, 6
    rng = np.random.default_rng(dim)
    senders = rng.integers(0, n, size=(n, k))
    senders[rng.uniform(size=(n, k)) < 0.25] = n
    scale = rng.uniform(size=(n, k, 1)) * (senders < n)[..., None]
    phi = np.concatenate([rng.normal(size=(n, k, r)), scale], axis=-1).astype(np.float32)
    packed = rng.normal(size=(n, (2 + dim) * h)).astype(np.float32)
    nd = rng.normal(size=(n, k, dim)).astype(np.float32)
    s = rng.normal(size=(n, h)).astype(np.float32)
    v = rng.normal(size=(n, dim * h)).astype(np.float32)
    p = {"filt_w": rng.normal(size=(r, 3 * h)) / np.sqrt(r),
         "filt_b": rng.normal(size=(3 * h,)) * 0.1,
         "vmix_w": rng.normal(size=(h, 2 * h)) / np.sqrt(h),
         "mix_w1": rng.normal(size=(2 * h, h)) / np.sqrt(2 * h),
         "mix_b1": rng.normal(size=(h,)) * 0.1,
         "mix_w2": rng.normal(size=(h, 3 * h)) / np.sqrt(h),
         "mix_b2": rng.normal(size=(3 * h,)) * 0.1}
    p = {name: x.astype(np.float32) for name, x in p.items()}
    g = packed[np.minimum(senders, n - 1)]
    want = jax_painn_msg.painn_layer(jnp.asarray(g), jnp.asarray(phi), jnp.asarray(nd),
                                     jnp.asarray(s), jnp.asarray(v),
                                     {name: jnp.asarray(x) for name, x in p.items()},
                                     interpret=True)
    sidx = painn_msg.sender_index(torch.as_tensor(senders), n)
    got = painn_msg.painn_layer_plain(torch.as_tensor(packed), sidx, torch.as_tensor(phi),
                                      torch.as_tensor(nd), torch.as_tensor(s), torch.as_tensor(v),
                                      {name: torch.as_tensor(x) for name, x in p.items()})
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a.numpy(), b, 1e-5)


# ---------------------------------------------------------------------------
# GNS-2-320 from JAX weights
# ---------------------------------------------------------------------------

LATENT, MP_STEPS, NG, KG = 320, 2, 40, 8


def _features(seed=0):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, NG, size=(NG, KG)).astype(np.int32)
    senders[rng.uniform(size=(NG, KG)) < 0.3] = NG
    valid = (senders < NG)[..., None]
    rel_disp = np.where(valid, rng.uniform(-1, 1, size=(NG, KG, DIM)), 0.0)
    feats = {
        "vel_hist": rng.normal(size=(NG, (ISL - 1) * DIM)),
        "senders": senders,
        "receivers": np.broadcast_to(np.arange(NG, dtype=np.int32)[:, None], (NG, KG)).copy(),
        "rel_disp": rel_disp,
        "rel_dist": np.linalg.norm(rel_disp, axis=-1, keepdims=True),
    }
    return feats, rng.integers(0, 3, size=NG).astype(np.int32)


def _perturbed(params, seed):
    """Biases off zero and scales off one, so every parameter matters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float64) + 0.05 * rng.normal(size=x.shape),
                        jax.device_get(params))


def _jax_model(fused=True):
    return JaxGNS(particle_dimension=DIM, latent_size=LATENT, num_mp_steps=MP_STEPS,
                  use_fused_processor=fused, compute_dtype="float64")


def _port_model():
    return GNS(DIM, node_in=(ISL - 1) * DIM, edge_in=DIM + 1, latent_size=LATENT,
               num_mp_steps=MP_STEPS, compute_dtype="float64", device="cpu").double()


def _decoder_out(model, feats, ptype):
    seen = {}
    hook = model.decoder.register_forward_hook(lambda m, i, o: seen.update(acc=o))
    with torch.no_grad():
        model({k: torch.as_tensor(v) for k, v in feats.items()}, torch.as_tensor(ptype))
    hook.remove()
    return seen["acc"]


def test_gns320_forward_float64_matches_jax():
    """GNS-2-320's acc before the float32 cast, from JAX-initialised
    weights carried across by ``load_jax_params`` (the weights at their
    true width 320, the card's width too), against JAX's fused GNS: 1e-10
    of the largest magnitude."""
    feats, ptype = _features()
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    jmodel = _jax_model()
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), sample)["params"], 1)
    _, inter = jmodel.apply({"params": params}, sample, capture_intermediates=True)
    want = np.asarray(inter["intermediates"]["MLP_1"]["__call__"][0])
    model = _port_model()
    model.load_jax_params(params)
    assert model.mp_steps[0]["w_e"].shape == (LATENT, LATENT)
    _close(_decoder_out(model, feats, ptype).numpy(), want)


def test_gns320_train_step_loss_and_grads_match_jax():
    """flat_mse_loss of GNS-2-320 and its gradient (the fused processor's
    backward: K4's plain version) against jax.value_and_grad of the JAX
    loss on the same weights and batch, float64: loss rtol 1e-12, each
    gradient 1e-9 of its largest magnitude."""
    n = 64
    splits, metadata = make_synthetic_arrays(n_particles=n, dim=DIM, box=1.0,
                                             seq_len_train=12, seq_len_eval=12, n_trajs=2)
    pos = np.stack([t.transpose(1, 0, 2) for t in splits["train"]])[:, :, :ISL + 1]
    ptype = np.zeros(pos.shape[:2], np.int32)
    ptype[0, :4] = 1  # walls: kinematic, no noise, no loss
    port = case_builder([1.0] * DIM, metadata, ISL, cfg_neighbors={"backend": "auto"},
                        noise_std=3e-4, dtype=torch.float64, device="cpu")
    _, nbrs = port.allocate_eval((pos[0, :, :ISL], ptype[0]))
    draw = torch.as_tensor(np.random.default_rng(2).normal(size=(2, n, ISL - 1, DIM)))
    feats, targets, _ = port.preprocess_batched(None, (pos, ptype), 3e-4, nbrs.broadcast(2), 0,
                                                draw=draw)
    non_kin = ptype == 0
    node_weight = (non_kin / non_kin.sum(1)[:, None]).reshape(-1)
    flat_ptype = ptype.reshape(-1)
    loss_weight = {"acc": 1.0, "vel": 0.0, "pos": 0.0}

    jfeats = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    init, apply = make_model_fns(_jax_model())
    params, state = init(jax.random.PRNGKey(0), (jfeats, jnp.asarray(flat_ptype)))
    params = _perturbed(params, 3)
    jtargets = {k: jnp.asarray(v.numpy()) for k, v in targets.items()}
    (loss_ref, _), grads_ref = jax.value_and_grad(jax_trainer.flat_mse_loss, has_aux=True)(
        params, state, jfeats, jnp.asarray(flat_ptype), jtargets, jnp.asarray(node_weight),
        apply, loss_weight,
    )

    model = _port_model()
    model.load_jax_params(params)
    loss = flat_mse_loss(model, feats, torch.as_tensor(flat_ptype), targets,
                         torch.as_tensor(node_weight), loss_weight)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-12)
    flat_ref = {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
        for path, g in jax.tree_util.tree_flatten_with_path(grads_ref)[0]
    }
    leaves = model.jax_leaves()
    assert [name for name, _, _ in leaves] == list(flat_ref)
    for name, p, transposed in leaves:
        g = p.grad.t() if transposed else p.grad
        _close(g.numpy(), flat_ref[name], 1e-9, name)


def test_gns320_reference_checkpoint_round_trip(tmp_path):
    """The weight carry-over at F = 320: a standard-layout GNS-2-320 tree
    exported as the reference's Haiku checkpoint
    (``compat.save_reference_checkpoint``) and read back
    (``load_reference_checkpoint``) is the same tree, bit for bit; re-laid
    out for the fused processor (``fused_params_from_standard``) it gives
    the port's fused GNS the forward that JAX's standard GNS computes from
    the original tree (1e-10 of the largest magnitude)."""
    feats, ptype = _features(4)
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    jstd = _jax_model(fused=False)
    params = _perturbed(jstd.init(jax.random.PRNGKey(2), sample)["params"], 5)
    _, inter = jstd.apply({"params": params}, sample, capture_intermediates=True)
    want = np.asarray(inter["intermediates"]["MLP_6"]["__call__"][0])  # the decoder
    cfg = {"num_mp_steps": MP_STEPS}
    ckp = str(tmp_path / "ref")
    compat.save_reference_checkpoint(ckp, "gns", params, cfg)
    back, _, _ = compat.load_reference_checkpoint(ckp, "gns", cfg)
    flat = jax.tree_util.tree_flatten_with_path
    got = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat(back)[0]}
    ref = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat(params)[0]}
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    model = _port_model()
    model.load_jax_params(fused_params_from_standard(back, MP_STEPS))
    _close(_decoder_out(model, feats, ptype).numpy(), want)
