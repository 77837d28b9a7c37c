"""K4's wgmma design (bf16, latent widths 257 to 512) on the CPU.

On the card K4 runs there as ``csrc/mp_wgmma_bwd.cuh``: the forward's edge
kernel rematerializes T(relu(first)), x1 and T(agg); the node side runs on
the wide path's launches; one edge-backward kernel per step
(``fused_mp_bwd_edge_wgmma``: LN1's backward, dfirst, de, per-tile dfirst
partials per receiver and per-block vector partials) and one wgmma product
kernel for dW_e and dW2 (``fused_mp_bwd_tn_wgmma``: one float32 partial per
range of whole 64-row chunks). The kernels cannot run here; these tests
hold what surrounds them and the arithmetic they repeat:

* the launch plan at every F from 257 to 512 (``wide_plan``): both
  kernels' shared memory within a block's 227 KB, the ring's stages, the
  tiles, the dhr slots and the partials layout (``bwd_partials_floats``);
* a float64 model of the design's ordered sums at ragged n and K: the
  per-(tile, receiver) partials of sum_K dfirst, summed in tile order as
  ``fused_mp_wide_agg`` sums them, equal the plain K-sum; the vector
  partials (a block's tiles in order, each tile's rows by warp) summed in
  order equal the plain column sums; the weight gradients' range partials
  summed in order equal A^T B;
* K4's plain version at F = 384 and 448 (and 360, 420 padded to them), the
  instance widths no other CPU test holds, against ``jax.vjp`` of JAX's
  fused step, float64.

Tolerances: 1e-10 of the largest magnitude of each compared array (float64
sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.ops import fused_mp as jax_fmp
from lagrangebench_torch.ops import fused_mp as fmp

TOL = 1e-10
SMS = 132


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1, 1), (17, 7), (16000, 40)])
def test_wgmma_bwd_plan_every_width(n, k):
    """At every F from 257 to 512 (card width 64 ceil(F / 64): 320, 384,
    448, 512) in bf16 on a 132-SM card: the design is "wgmma"; the
    edge-backward kernel runs the forward edge kernel's block with the
    consumer warps' running vector sums beside it (2 to 6 weight stages,
    within 232,448 bytes) over 64-row tiles on the same persistent grid,
    with ``wgmma_slots(k)`` dhr partials per tile;
    the weight-gradient kernel's block (4 stages of two 64 x 128 bf16
    slabs) fits, its grid covers the F x F output in 128 x 128 tiles for
    each range and both gradients; and K4's partials are the five
    gradients' range partials, then 4 vector rows per edge-backward block,
    then the node row kernels' warps."""
    for f in range(257, 513):
        w = fmp.kernel_width(f)
        assert w in (320, 384, 448, 512) and fmp._design(torch.bfloat16, w) == "wgmma"
        plan = fmp.wide_plan(n, k, w, SMS, torch.bfloat16)
        stages = plan["edge_stages"]
        assert stages == {320: 6, 384: 5, 448: 4, 512: 3}[w] == fmp.wgmma_stages(w)
        assert fmp.wgmma_smem_bytes(w) == plan["smem_bytes"] <= fmp.SMEM_LIMIT
        bst = {320: 6, 384: 4, 448: 3, 512: 2}[w]
        assert plan["bwd_stages"] == fmp.wgmma_bwd_stages(w) == bst
        assert plan["bwd_smem"] == fmp.wgmma_bwd_smem_bytes(w) == (
            2 * 64 * w * 2 + bst * 32 * w * 2 + 1024 + 8 * 3 * (w // 2) * 4 + (2 * bst + 4) * 8
            + 1024) <= fmp.SMEM_LIMIT < plan["bwd_smem"] + 32 * w * 2 or bst == 6
        assert fmp.wgmma_bwd_smem_bytes(512) == 223296
        tn = fmp.wgmma_tn_smem_bytes()
        assert plan["tn_smem"] == tn == 4 * 2 * 64 * 128 * 2 + 4 * 2 * 8 + 1024 <= fmp.SMEM_LIMIT
        tiles = -(-n * k // 64)
        assert plan["tiles"] == tiles and plan["slots"] == fmp.wgmma_slots(k)
        assert plan["partials"] == tiles * plan["slots"] * w
        ctas = plan["edge_ctas"]
        assert ctas == min(-(-tiles // 2), SMS // 2) * 2 and plan["p_e"] == 4 * ctas
        side = -(-w // 128)
        assert side * 128 >= w > (side - 1) * 128
        assert plan["tn_grid"][0] == (side * side, plan["r_e"], 2)
        assert 1 <= plan["r_e"] <= -(-n * k // 64)
        r_e, r_n, p_e, p_n = fmp._wide_plan_ints(plan)
        assert fmp.bwd_partials_floats(n, 1, True, w, (r_e, r_n, p_e, p_n)) == (
            (2 * r_e + 3 * r_n) * w * w + (p_e + p_n) * 4 * w)
    assert fmp._design(torch.bfloat16, 576) == fmp._design(torch.float32, 512) == "wide"


# ---------------------------------------------------------------------------
# a float64 model of the ordered sums
# ---------------------------------------------------------------------------

RAGGED = [(1, 1), (40, 1), (3, 13), (333, 24), (101, 40), (17, 64), (9, 65), (5, 130)]


def _dhr_partials(dfirst, n, k):
    """The edge-backward kernel's per-(tile, slot) sums of dfirst's rows, as
    its column threads write them: rows of a 64-row tile in order, a new
    slot at each receiver boundary."""
    rows, f = dfirst.shape
    tiles, slots = -(-rows // 64), fmp.wgmma_slots(k)
    part = np.full((tiles, slots, f), np.nan)
    for t in range(tiles):
        m0, last = 64 * t, min(rows - 64 * t, 64) - 1
        rem, slot, s = m0 % k, 0, np.zeros(f)
        for r in range(last + 1):
            s = s + dfirst[m0 + r]
            rem += 1
            if rem == k or r == last:
                part[t, slot] = s
                s = np.zeros(f)
                if rem == k:
                    rem, slot = 0, slot + 1
    return part


def _agg_of(part, n, k):
    """fused_mp_wide_agg: receiver i's partials of the tiles that hold its
    rows, summed in tile order."""
    out = np.zeros((n, part.shape[-1]))
    for i in range(n):
        for t in range(i * k // 64, ((i + 1) * k - 1) // 64 + 1):
            out[i] += part[t, i - (64 * t) // k]
    return out


@pytest.mark.parametrize("n,k", RAGGED)
def test_wgmma_bwd_ordered_sums(n, k):
    """The design's sums, modelled in float64 at ragged n and K (a
    receiver's rows within one tile, across two or three, fewer rows than a
    tile): dhr from the per-tile partials equals the plain sum over K;
    each vector gradient from the per-block, per-warp partials (a block's
    tiles it * grid + block in order, a warp's 16 rows of each) summed in
    block and warp order equals the plain column sum; and dW_e's and dW2's
    range partials (whole 64-row chunks) summed in order equal A^T B."""
    rng = np.random.default_rng(n * 1000 + k)
    f, rows = 24, n * k
    dfirst = rng.normal(size=(rows, f))
    part = _dhr_partials(dfirst, n, k)
    _close(_agg_of(part, n, k), dfirst.reshape(n, k, f).sum(axis=1), name="dhr")

    plan = fmp.wide_plan(n, k, 320, SMS, torch.bfloat16)
    grid, tiles = plan["edge_ctas"], plan["tiles"]
    vec = rng.normal(size=(rows, f))
    vparts = np.zeros((plan["p_e"], f))
    for b in range(grid):
        for t in range(b, tiles, grid):
            for w in range(4):
                lo, hi = 64 * t + 16 * w, min(64 * t + 16 * w + 16, rows)
                if lo < hi:
                    vparts[4 * b + w] += vec[lo:hi].sum(axis=0)
    _close(vparts.sum(axis=0), vec.sum(axis=0), name="vector partials")

    a, g = rng.normal(size=(rows, f)), rng.normal(size=(rows, f))
    r_e = plan["r_e"]
    spans = [fmp.wgmma_tn_rows(rows, r_e, r) for r in range(r_e)]
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(lo % 64 == 0 and lo < hi for lo, hi in spans)
    assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
    total = np.zeros((f, f))
    for lo, hi in spans:
        total += a[lo:hi].T @ g[lo:hi]
    _close(total, a.T @ g, name="range partials")


# ---------------------------------------------------------------------------
# the plain version at the remaining instance widths
# ---------------------------------------------------------------------------

N, K = 24, 5


@pytest.mark.parametrize("f,width", [(384, 384), (448, 448), (360, 384), (420, 448)])
def test_wgmma_widths_bwd_plain_matches_jax_float64(f, width):
    """K4's plain version (its wrapper on CPU tensors) in the card's layout
    at the wgmma design's instances 384 and 448 (360 and 420 zero-padded to
    them) against ``jax.vjp`` of JAX's fused step at the true width: the
    input cotangents, zero past the true width, and the 13 parameter
    gradients within their first f rows and columns, zero past them."""
    assert fmp.kernel_width(f) == width and fmp._design(torch.bfloat16, width) == "wgmma"
    rng = np.random.default_rng(f)
    senders = rng.integers(0, N, size=(N, K))
    senders[rng.uniform(size=(N, K)) < 0.3] = N
    p = {name: rng.normal(size=(f, f)) / np.sqrt(f) if name.startswith("w")
         else rng.normal(size=(f,)) * 0.1 + (1.0 if "scale" in name else 0.0)
         for name in fmp.PARAM_NAMES}
    arrs = {"e": rng.normal(size=(N, K, f)),
            "hs": rng.normal(size=(N, f))[np.minimum(senders, N - 1)],
            "hr": rng.normal(size=(N, f)), "h": rng.normal(size=(N, f)),
            "ge": rng.normal(size=(N, K, f)), "gh": rng.normal(size=(N, f)),
            "mask": senders < N}
    j = {name: jnp.asarray(v) for name, v in arrs.items()}

    def step(e, hs, hr, h, p_):
        return jax_fmp.gns_mp_step_reference(e, hs, hr, h, j["mask"], p_, None)

    _, vjp = jax.vjp(step, j["e"], j["hs"], j["hr"], j["h"],
                     {name: jnp.asarray(v) for name, v in p.items()})
    want = vjp((j["ge"], j["gh"]))
    t = {name: torch.as_tensor(v) for name, v in arrs.items()}
    kp = fmp.kernel_params({name: torch.as_tensor(v) for name, v in p.items()}, torch.float64,
                           width)
    de, dhs, dhr, dh, dp = fmp.gns_mp_step_bwd(
        *(fmp.pad_last(t[name], width) for name in ("e", "hs", "hr", "h")), t["mask"], kp,
        fmp.pad_last(t["ge"], width), fmp.pad_last(t["gh"], width), latent=f)
    for name, a, b in zip(("de", "dhs", "dhr", "dh"), (de, dhs, dhr, dh), want[:4]):
        assert a.shape[-1] == width and not a[..., f:].any(), name
        _close(a[..., :f].numpy(), b, name=name)
    for name in fmp.BWD_PARAM_ORDER:
        g = dp[name].clone()
        inner = g[(slice(0, f),) * g.dim()].clone()
        g[(slice(0, f),) * g.dim()] = 0
        assert not g.any(), name
        _close(inner.numpy(), want[4][name], name=name)
