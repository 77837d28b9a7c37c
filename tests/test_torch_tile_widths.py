"""The fused GNS step at the wide latent widths F = 192 and 256, on the CPU.

The port's step (plain and encoder-folded, ``gns_mp_step``) and its
gradients (``gns_mp_step_autograd``) against the JAX package's fused step
and its VJP, in float64, at the true width and in the card's padded layout
(widths 160 and 200 run the 192 and 256 instances on zero-padded tensors);
and, as plain Python, the helpers that lay out the bf16 stream design's K4
launch: its plan (grids and the row ranges of the weight-gradient product
kernel), the rows of each range, and its partials; and the edits of the
stream design's timing probe (``experiments/stream_ablation.py``).

On the card these widths run the bf16 stream design (``csrc/mp_stream.cuh``,
``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 17); here the
plain versions hold the arithmetic that the kernels repeat. On the CPU JAX's
``gns_mp_step`` runs its mirror ``gns_mp_step_reference``, which these tests
call. Tolerance: 1e-10 of the largest magnitude of each compared array (the
same float64 sums in other orders).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.ops import fused_mp as jax_fmp
from lagrangebench_torch.experiments import stream_ablation
from lagrangebench_torch.ops import fused_mp as fmp

N, K, FE = 24, 5, 4
TOL = 1e-10


def _close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=name)


def _inputs(f, seed):
    """Seeded float64 inputs of one step at width f: 30% padded slots (the
    clamped gather), two receivers with none, cotangents."""
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


def _port_step(arrs, p, enc, use_enc, width=None, latent=None):
    """The port's outputs and gradients through ``gns_mp_step_autograd``,
    with the tensors zero-padded to ``width`` (the card's layout) when
    given and everything cut back to the true width."""
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    pad = (lambda x: fmp.pad_last(x, width)) if width else (lambda x: x)
    leaves = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    eleaves = {k: torch.as_tensor(v).requires_grad_() for k, v in enc.items()}
    ins = {k: pad(t[k]).requires_grad_() for k in ("e", "hs", "hr", "h")}
    ins["raw"] = t["raw"].clone().requires_grad_()
    e_out, h_out = fmp.gns_mp_step_autograd(
        ins["raw"] if use_enc else ins["e"], ins["hs"], ins["hr"], ins["h"], t["mask"], leaves,
        eleaves if use_enc else None, latent=latent)
    torch.autograd.backward([e_out, h_out], [pad(t["ge"]), pad(t["gh"])])
    f = arrs["hr"].shape[-1]
    grads = (ins["raw" if use_enc else "e"].grad, ins["hs"].grad, ins["hr"].grad, ins["h"].grad)
    if width:  # the padded channels carry exact zeros forward
        assert e_out.shape[-1] == width and not e_out[..., f:].any() and not h_out[..., f:].any()
        grads = (grads[0] if use_enc else grads[0][..., :f],) + tuple(g[..., :f] for g in grads[1:])
    return ((e_out[..., :f].detach(), h_out[..., :f].detach()), grads,
            {k: v.grad for k, v in leaves.items() if v.grad is not None},
            {k: v.grad for k, v in eleaves.items()})


def _compare(port, ref, use_enc):
    (p_out, p_in, p_dp, p_denc), (r_out, r_grads) = port, ref
    for name, a, b in zip(("e'", "h'"), p_out, r_out):
        _close(a.numpy(), b, name)
    for name, a, b in zip(("de", "dhs", "dhr", "dh"), p_in, r_grads[:4]):
        _close(a.detach().numpy(), b, name)
    for name in fmp.BWD_PARAM_ORDER:
        _close(p_dp[name].numpy(), r_grads[4][name], name)
    if use_enc:
        for name in fmp.ENC_PARAM_NAMES:
            _close(p_denc[name].numpy(), r_grads[5][name], name)


@pytest.mark.parametrize("use_enc", [False, True], ids=["plain_step", "encoder_step"])
@pytest.mark.parametrize("f", [192, 256])
def test_step_matches_jax_float64(f, use_enc):
    """K3's plain version (``gns_mp_step`` on CPU tensors) against JAX's
    fused step at F = 192 and 256: e' and h', 1e-10 of the largest value."""
    arrs, p, enc = _inputs(f, seed=f)
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    e_out, h_out = fmp.gns_mp_step(t["raw"] if use_enc else t["e"], t["hs"], t["hr"], t["h"],
                                   t["mask"], {k: torch.as_tensor(v) for k, v in p.items()},
                                   {k: torch.as_tensor(v) for k, v in enc.items()}
                                   if use_enc else None)
    (want_e, want_h), _ = _jax_step(arrs, p, enc, use_enc)
    assert e_out.shape == (N, K, f) and e_out.dtype == torch.float64
    _close(e_out.numpy(), want_e, "e'")
    _close(h_out.numpy(), want_h, "h'")


@pytest.mark.parametrize("use_enc", [False, True], ids=["plain_step", "encoder_step"])
@pytest.mark.parametrize("f", [192, 256])
def test_step_gradients_match_jax_vjp_float64(f, use_enc):
    """The autograd Function (K4's plain version; the encoder's plain
    backward on step 0) against ``jax.vjp`` of JAX's fused step at F = 192
    and 256: the outputs, the input cotangents and the 13 (19) parameter
    gradients, 1e-10 of the largest value of each."""
    arrs, p, enc = _inputs(f, seed=f + 1)
    _compare(_port_step(arrs, p, enc, use_enc), _jax_step(arrs, p, enc, use_enc), use_enc)


@pytest.mark.parametrize("use_enc", [False, True], ids=["plain_step", "encoder_step"])
@pytest.mark.parametrize("f", [160, 200])
def test_padded_step_matches_jax_float64(f, use_enc):
    """The card's layout of the wide instances: latents zero-padded to the
    instance width (160 -> 192, 200 -> 256) through the Function, every
    LayerNorm over the true width, against JAX at the true width: outputs,
    input cotangents and parameter gradients cut back, 1e-10; the padded
    channels of e' and h' exactly zero."""
    width = fmp.kernel_width(f)
    assert width in (192, 256) and fmp._design(torch.bfloat16, width) == "stream"
    arrs, p, enc = _inputs(f, seed=f)
    port = _port_step(arrs, p, enc, use_enc, width=width, latent=f)
    _compare(port, _jax_step(arrs, p, enc, use_enc), use_enc)


# ---------------------------------------------------------------------------
# the stream design's K4 launch plan, as plain Python
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,sms,want", [
    (16000, 40, 132, (132, 125, 30, 1)),  # the rollout shape: 126 product blocks
    (14960, 40, 132, (132, 117, 30, 1)),
    (1000, 24, 132, (132, 8, 28, 2)),
    (333, 24, 132, (63, 3, 28, 2)),
    (1, 1, 132, (1, 1, 1, 1)),
    (16000, 1, 132, (125, 125, 13, 13)),  # K = 1: edge and node rows alike
    (2999, 13, 7, (7, 7, 1, 1)),
    (5, 40, 1, (1, 1, 1, 1)),
])
def test_bwd_stream_plan(n, k, sms, want):
    """(edge grid, node grid, r_e, r_n): the row kernels' grids are
    ``mp_grids``'; every range has rows; the five gradients' ranges take
    about equally many 32-row chunks each, and their 2 (2 r_e + 3 r_n)
    blocks fit one wave of a card with 12 SMs or more."""
    plan = fmp.bwd_stream_plan(n, k, sms)
    assert plan == want
    edge, node, r_e, r_n = plan
    assert (edge, node) == fmp.mp_grids(n, k, sms)
    ce, cn = -(-n * k // 32), -(-n // 32)
    assert 1 <= r_e <= ce and 1 <= r_n <= cn
    if sms >= 12:
        assert 2 * (2 * r_e + 3 * r_n) <= sms
    per = max(-(-ce // r_e), -(-cn // r_n))
    assert per <= max(1, -(-(2 * ce + 3 * cn) // max(1, sms // 2 - 5)))


@pytest.mark.parametrize("rows,ranges", [(1, 1), (31, 1), (33, 2), (640000, 30), (16000, 1),
                                         (1000, 7), (7, 1)])
def test_tn_rows_partition(rows, ranges):
    """The product kernel's fixed split of a gradient's rows: the ranges
    cover [0, rows) in order without overlap, each non-empty and starting on
    a 32-row chunk, their chunk counts within one of each other."""
    spans = [fmp.tn_rows(rows, ranges, r) for r in range(ranges)]
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(lo < hi and lo % 32 == 0 for lo, hi in spans)
    sizes = [-(-(hi - lo) // 32) for lo, hi in spans]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("f", [192, 256])
@pytest.mark.parametrize("n,k", [(16000, 40), (5, 1)])
def test_bwd_partials_floats_stream(f, n, k):
    """The stream design's partials: an F x F partial per row range of the
    five gradients, then the edge and the node kernel's 4 vector sums per
    block, which hold each of the 13 gradients; the other designs' layouts
    stay as they were."""
    plan = fmp.bwd_stream_plan(n, k, 132)
    edge, node, r_e, r_n = plan
    got = fmp.bwd_partials_floats(n, edge, True, f, plan)
    assert got == (2 * r_e + 3 * r_n) * f * f + (edge + node) * 4 * f
    assert got >= 5 * f * f + 8 * f
    assert fmp.bwd_partials_floats(n, 7, False, f) == 7 * (5 * f * f + 8 * f)


@pytest.mark.parametrize("f", [64, 128, 192, 256])
def test_kernel_designs(f):
    """bf16 runs the warp design at 64 and 128 and the stream design at 192
    and 256; float32 the tile design at every instance width."""
    assert fmp._design(torch.bfloat16, f) == ("warp" if f <= 128 else "stream")
    assert fmp._design(torch.float32, f) == "tile"


@pytest.mark.parametrize("name", list(stream_ablation.ABLATIONS))
def test_stream_ablations_apply(tmp_path, name):
    """Each ablation of the timing probe edits the current CUDA sources
    (every one of its patterns matches: ``ablate`` raises otherwise) in a
    copy, and "base" leaves the copy as it was."""
    src = os.path.join(os.path.dirname(os.path.dirname(fmp.__file__)), "csrc")
    shutil.copytree(src, tmp_path / "csrc")
    stream_ablation.ablate(str(tmp_path / "csrc"), name)
    files = ("fused_mp.cu", "fused_mp_bwd.cu", "mp_stream.cuh")
    changed = [f for f in files
               if (tmp_path / "csrc" / f).read_text() != open(os.path.join(src, f)).read()]
    assert bool(changed) == (name != "base")
