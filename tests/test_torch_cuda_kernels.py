"""CUDA kernels K1-K9, E1 and E2 against their plain versions, on the card.

Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is false and
run on a machine with a card (``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_kernels.py``; the root conftest imports JAX). float32
comparisons run with TF32 off.
"""

import numpy as np
import pytest
import torch

from chip_smoke import BF16_TIE_WIDTHS
from lagrangebench_torch.experiments import k4_ties
from lagrangebench_torch.ops import fused_mp, neighbors_cuda
from lagrangebench_torch.ops.neighbors import ColumnGrid, neighbor_list

pytestmark = pytest.mark.gpu

# the fused GNS kernels' widths under test: the warp design's instances and
# widths that run padded (32, 96, 100) or on the wider instances (192, 256)
WIDTHS = fused_mp.LATENTS + (32, 96, 100, 192, 256)
# widths whose float32 K4 comparison resolves float32 relu ties as the
# kernel resolved them (``k4_ties.relu_tie_reference``): a reading on the
# card showed a tie there (at 512, N = 2,999, K = 1: one relu(node_first)
# flip at 2.9e-7, the kernel within 1.6e-6 of float64 with it set so); and,
# from chip_smoke.py, the widths whose bf16 K4 comparison takes the
# kernel's rounding of agg (``bf16_tie_check``)
K4_TIE_WIDTHS = (64, 100, 192, 256, 512)
# K6's and K5's hidden widths, and K5's radial-basis widths, under test
HIDDENS = (32, 64, 100, 128, 256)
RBFS = (8, 20, 32)


def _at(name, *args, f):
    """The fused step wrapper ``name`` on the tests' inputs at the true
    width ``f`` (padded to the instance width and sliced back,
    ``fused_mp.at_true_width``)."""
    return fused_mp.at_true_width(name, *args, latent=f)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("cap", [3, 16])
def test_binning_kernel(cuda, cap):
    """K1 (the column table) against its plain version: every output equal."""
    rng = np.random.default_rng(cap)
    grid = ColumnGrid((10, 5), (0.1, 0.2), 50, (True, True, True))
    pos = torch.as_tensor(rng.uniform(0, 1, size=(2, 1500, 3)).astype(np.float32), device=cuda)
    npart = torch.tensor([1500, 1200], dtype=torch.int32, device=cuda)
    got = neighbors_cuda.column_table(pos, npart, grid, cap)
    want = neighbors_cuda.column_table_plain(pos, npart, grid, cap)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("pbc", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_neighbor_scan_kernel(cuda, dim, pbc):
    rng = np.random.default_rng(dim)
    pos = torch.as_tensor(rng.uniform(0, 1, size=(2, 400, dim)), device=cuda)
    nl = neighbor_list(None, [1.0] * dim, 0.12, pbc=[pbc] * dim)
    shell = nl.allocate_shell(pos[0].cpu().numpy(), capacity_boost=1.5)
    before = neighbors_cuda.NEIGHBOR_SCAN.launches
    got = shell.broadcast(2).update(pos, num_particles=torch.tensor([400, 350]))
    assert neighbors_cuda.NEIGHBOR_SCAN.launches == before + 1
    want = shell.broadcast(2).update(pos.cpu(), num_particles=torch.tensor([400, 350]))
    assert torch.equal(got.idx.cpu(), want.idx)
    assert torch.equal(got.did_buffer_overflow.cpu(), want.did_buffer_overflow)


def _fwd_case(cuda, dtype, use_enc, n, k, f=128):
    g = torch.Generator().manual_seed(0)
    p = fused_mp.kernel_params(
        {name: (torch.randn(f, f, generator=g) / f**0.5 if name.startswith("w")
                else 0.1 * torch.randn(f, generator=g)) for name in fused_mp.PARAM_NAMES},
        dtype,
    )
    enc = fused_mp.kernel_params({
        "enc_w1": torch.randn(4, f, generator=g), "enc_w2": torch.randn(f, f, generator=g) / f**0.5,
        "enc_b1": torch.zeros(f), "enc_b2": torch.zeros(f),
        "enc_ln_scale": torch.ones(f), "enc_ln_bias": torch.zeros(f),
    }, dtype) if use_enc else None
    p = {name: v.to(cuda) for name, v in p.items()}
    enc = {name: v.to(cuda) for name, v in enc.items()} if enc else None
    e = torch.randn(n, k, 4 if use_enc else f, generator=g)
    e = (e if use_enc else e.to(dtype)).to(cuda)
    hs = torch.randn(n, k, f, generator=g).to(dtype).to(cuda)
    hr = torch.randn(n, f, generator=g).to(dtype).to(cuda)
    h = torch.randn(n, f, generator=g).to(dtype).to(cuda)
    mask = (torch.rand(n, k, generator=g) < 0.7).to(torch.float32).to(cuda)
    return e, hs, hr, h, mask, p, enc


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_fused_mp_kernel(cuda, dtype, tol, use_enc, f):
    """max |kernel - plain| within 1e-4 (float32) or 0.125 (bf16: outputs of
    a few units, where one bf16 ulp is 1/64..1/32), at each width."""
    args = _fwd_case(cuda, dtype, use_enc, 333, 24, f)
    got = _at("gns_mp_step", *args, f=f)
    want = fused_mp.gns_mp_step_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= tol


# receivers not a multiple of a slice, a block's slices or the SM count;
# edge rows per receiver that leave slices ragged; fewer slices than warps
RAGGED = [(n, k) for n in (1, 17, 1000, 16000) for k in (1, 7, 24, 40)]


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("n,k", RAGGED)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_fused_mp_kernel_ragged(cuda, n, k, dtype, tol, use_enc, f):
    """K3 at ragged shapes, K3's limits; two launches give the same bits."""
    _check_fwd_ragged(cuda, n, k, dtype, tol, use_enc, f)


def _check_fwd_ragged(cuda, n, k, dtype, tol, use_enc, f):
    args = _fwd_case(cuda, dtype, use_enc, n, k, f)
    got = _at("gns_mp_step", *args, f=f)
    again = _at("gns_mp_step", *args, f=f)
    want = fused_mp.gns_mp_step_plain(*args)
    for a, b, c in zip(got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol
        assert torch.equal(a, c)


@pytest.mark.parametrize("f", [0, -1, -64])
def test_fused_kernels_refuse_other_widths(cuda, f):
    """On CUDA tensors every fused GNS wrapper (K3, K4, K8, E2) raises
    ValueError naming the widths the kernels take (from 1 on) for a latent
    width below 1, and launches nothing: there is no fallback to the plain
    version. Past the old limit of 1,024 every width runs
    (``test_fused_kernels_past_1024``)."""
    handles = (fused_mp.FUSED_MP, fused_mp.FUSED_MP_BWD, fused_mp.FUSED_MP_SLOT,
               fused_mp.FUSED_MP_WINDOW)
    before = [h.launches for h in handles]
    match = r"widths from 1 on"
    e, hs, hr, h, mask, p, _ = _fwd_case(cuda, torch.float32, False, 40, 8, 64)
    with pytest.raises(ValueError, match=match):
        fused_mp.gns_mp_step(e, hs, hr, h, mask, p, latent=f)
    with pytest.raises(ValueError, match=match):
        fused_mp.gns_mp_step_bwd(e, hs, hr, h, mask, p, e, h, latent=f)
    with pytest.raises(ValueError, match=match):
        fused_mp.gns_mp_step_slot(*_slot_case(cuda, torch.float32, False, particles=37, f=64),
                                  latent=f)
    with pytest.raises(ValueError, match=match):
        fused_mp.gns_mp_step_window(*_window_case(cuda, torch.float32, particles=200, f=64),
                                    latent=f)
    assert [h.launches for h in handles] == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
def test_fused_kernels_past_1024(cuda, dtype, tol):
    """F = 1,088, past the old limit of 1,024 (the wide path's row kernels
    walk each row in 1,024-column chunks): K3 (plain and encoder step)
    under K3's limits and K4 under the limits and tie rules of
    ``test_fused_mp_bwd_kernel_ragged`` against their plain versions, each
    two launches the same bits; and a GNS-2-1088 forward on the card
    launches K3 and gives finite accelerations."""
    from lagrangebench_torch.models.gns import GNS

    f = 1088
    assert fused_mp._design(dtype, f) == "wide"
    for use_enc in (False, True):
        _check_fwd_ragged(cuda, 141, 13, dtype, tol, use_enc, f)
    before = fused_mp.FUSED_MP_BWD.launches
    _check_bwd_ragged(cuda, 141, 13, dtype, f)
    assert fused_mp.FUSED_MP_BWD.launches >= before + 2
    g = torch.Generator().manual_seed(0)
    n, k = 40, 8
    rel_disp = torch.randn(n, k, 3, generator=g)
    feats = {"vel_hist": torch.randn(n, 15, generator=g),
             "senders": torch.randint(0, n + 1, (n, k), generator=g, dtype=torch.int32),
             "receivers": torch.arange(n, dtype=torch.int32)[:, None].expand(n, k),
             "rel_disp": rel_disp, "rel_dist": rel_disp.norm(dim=-1, keepdim=True)}
    model = GNS(3, node_in=15, edge_in=4, latent_size=f, num_mp_steps=2, device=cuda)
    before = fused_mp.FUSED_MP.launches
    with torch.no_grad():
        acc = model({name: v.to(cuda) for name, v in feats.items()},
                    torch.zeros(n, dtype=torch.int32, device=cuda))["acc"]
    assert fused_mp.FUSED_MP.launches == before + 1 and bool(torch.isfinite(acc).all())


# the wide path (csrc/mp_wide.cuh, F > 256): a width that runs padded (257),
# one that is not a multiple of its 128-column output tile (320), and
# GNS-10-512's
WIDER = (257, 320, 512)


@pytest.mark.parametrize("f", WIDER)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
def test_fused_kernels_past_256(cuda, dtype, tol, f):
    """Past F = 256 every fused GNS wrapper launches its kernel and holds
    to its plain version under K3's limits (bf16 at 320 and 512: the wgmma
    design): K3 (plain and encoder step), K8 (plain and encoder step) on a
    slot graph, E2 on the probe's windows (and E2 equal to K3 on the decoded
    gather), each two launches the same bits;
    and a GNS-2-F forward on the card launches K3 and gives finite
    accelerations."""
    from lagrangebench_torch.models.gns import GNS

    for use_enc in (False, True):
        _check_fwd_ragged(cuda, 333, 24, dtype, tol, use_enc, f)
        args = _slot_case(cuda, dtype, use_enc, particles=600, f=f)
        handle = fused_mp.FUSED_MP_SLOT_ENC if use_enc else fused_mp.FUSED_MP_SLOT
        before = handle.launches
        got = _at("gns_mp_step_slot", *args, f=f)
        assert handle.launches == before + 1
        again = _at("gns_mp_step_slot", *args, f=f)
        want = fused_mp.gns_mp_step_slot_plain(*args)
        for a, b, c in zip(got, want, again):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert float((a.float() - b.float()).abs().max()) <= tol
            assert torch.equal(a, c)
    args = _window_case(cuda, dtype, particles=1000, f=f)
    e, cand, w0s, wsub, hs_ext, hr, h, p = args
    got = _at("gns_mp_step_window", *args, f=f)
    again = _at("gns_mp_step_window", *args, f=f)
    want = fused_mp.gns_mp_step_window_plain(*args)
    for a, b, c in zip(got, want, again):
        assert float((a.float() - b.float()).abs().max()) <= tol
        assert torch.equal(a, c)
    rows, mask = fused_mp.window_sender_rows(cand, w0s, wsub)
    hs_g = torch.where(mask[..., None], hs_ext[rows], 0).to(dtype).contiguous()
    k3 = _at("gns_mp_step", e, hs_g, hr, h, mask.to(torch.float32), p, f=f)
    for a, b in zip(got, k3):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(0)
    n, k = 40, 8
    rel_disp = torch.randn(n, k, 3, generator=g)
    feats = {"vel_hist": torch.randn(n, 15, generator=g),
             "senders": torch.randint(0, n + 1, (n, k), generator=g, dtype=torch.int32),
             "receivers": torch.arange(n, dtype=torch.int32)[:, None].expand(n, k),
             "rel_disp": rel_disp, "rel_dist": rel_disp.norm(dim=-1, keepdim=True)}
    model = GNS(3, node_in=15, edge_in=4, latent_size=f, num_mp_steps=2, device=cuda)
    before = fused_mp.FUSED_MP.launches
    with torch.no_grad():
        acc = model({name: v.to(cuda) for name, v in feats.items()},
                    torch.zeros(n, dtype=torch.int32, device=cuda))["acc"]
    assert fused_mp.FUSED_MP.launches == before + 1 and bool(torch.isfinite(acc).all())


def _bwd_case(cuda, dtype, use_enc, n=333, k=24, f=128):
    g = torch.Generator().manual_seed(1)
    p = {name: (torch.randn(f, f, generator=g) / f**0.5 if name.startswith("w")
                else 0.1 * torch.randn(f, generator=g) + (1.0 if "scale" in name else 0.0))
         for name in fused_mp.PARAM_NAMES}
    enc = {"enc_w1": torch.randn(4, f, generator=g), "enc_w2": torch.randn(f, f, generator=g) / f**0.5,
           "enc_b1": torch.zeros(f), "enc_b2": torch.zeros(f),
           "enc_ln_scale": torch.ones(f), "enc_ln_bias": torch.zeros(f)}
    e = torch.randn(n, k, 4 if use_enc else f, generator=g)
    t = {"e": e if use_enc else e.to(dtype)}
    for name, shape in (("hs", (n, k, f)), ("hr", (n, f)), ("h", (n, f)), ("ge", (n, k, f)),
                        ("gh", (n, f))):
        t[name] = torch.randn(*shape, generator=g).to(dtype)
    t["mask"] = (torch.rand(n, k, generator=g) < 0.7).to(torch.float32)
    t = {name: v.to(cuda) for name, v in t.items()}
    p = {name: v.to(cuda) for name, v in p.items()}
    enc = {name: v.to(cuda) for name, v in enc.items()} if use_enc else None
    return t, p, enc


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_fused_mp_bwd_kernel(cuda, monkeypatch, dtype, tol, use_enc, f):
    """K4 through the autograd Function against the same Function with the
    plain backward: max error relative to the largest magnitude within 1e-4
    (float32, TF32 off) or 1e-2 (bf16 outputs); the float32 weight
    gradients of the step within 1e-4 (float32) or 1e-3 (bf16 operands).
    The encoder's weight gradients come from its plain backward, which
    rounds them through bf16 as the JAX mirror does: the bf16 tolerance.
    At ``BF16_TIE_WIDTHS`` in bf16 the step's outputs and weight gradients
    are held, within the same limits, to the plain version with its sums
    in float64 fed the kernel's bf16 rounding of agg, and the kernel's agg
    to the float64 sum within 1e-4 in the 2-norm
    (``chip_smoke.bf16_tie_check``): where agg lies within float32 noise
    of a bf16 rounding midpoint, each sum order rounds it its own way. At
    F = 192 the H100 read 1.43e-2 on bn1's gradient against the float32
    plain version: one element of receiver 104's agg (float32 sums within
    4e-6 of the float64 one) rounded the other way and moved
    node_first[104, 177] from 1.07e-2 to -2.19e-3 in the kernel; fed the
    kernel's T(agg), the float64-summed version reads the kernel within the
    float32 plain version's own distance from it
    (``experiments/k4_ties.py``)."""
    t, p, enc = _bwd_case(cuda, dtype, use_enc, f=f)
    width = fused_mp.kernel_width(f)  # the model's form: latents padded to the instance
    t = {name: v if name == "mask" or (name == "e" and use_enc) else fused_mp.pad_last(v, width)
         for name, v in t.items()}
    calls, real = [], fused_mp.gns_mp_step_bwd

    def recording(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    def grads():
        leaves = {name: v.clone().requires_grad_() for name, v in p.items()}
        eleaves = {name: v.clone().requires_grad_() for name, v in enc.items()} if enc else None
        ins = {name: t[name].clone().requires_grad_() for name in ("hs", "hr", "h")}
        e_out, h_out = fused_mp.gns_mp_step_autograd(
            t["e"], ins["hs"], ins["hr"], ins["h"], t["mask"], leaves, eleaves, latent=f)
        torch.autograd.backward([e_out, h_out], [t["ge"], t["gh"]])
        outs = {name: v.grad for name, v in ins.items()}
        weights = {name: v.grad for name, v in leaves.items() if v.grad is not None}
        if eleaves:
            weights.update({name: v.grad for name, v in eleaves.items()})
        return outs, weights

    monkeypatch.setattr(fused_mp, "gns_mp_step_bwd", recording)
    before = fused_mp.FUSED_MP_BWD.launches
    got = grads()
    assert fused_mp.FUSED_MP_BWD.launches == before + 1
    monkeypatch.setattr(fused_mp, "gns_mp_step_bwd", fused_mp.gns_mp_step_bwd_plain)
    want = grads()
    if dtype == torch.bfloat16 and f in BF16_TIE_WIDTHS:
        import chip_smoke

        args = [a.detach() if isinstance(a, torch.Tensor) else a for a in calls[0]]
        monkeypatch.setattr(fused_mp, "gns_mp_step_bwd", real)
        agg_err, errs, _ = chip_smoke.bf16_tie_check(args[:5], args[5], args[6:8], _rel_err)
        assert agg_err <= 1e-4 and errs["nf_outside"] == 0
        for names, limit in ((("de", "dhs", "dhr", "dh"), tol), (fused_mp.BWD_PARAM_ORDER, 1e-3)):
            for n in names:
                assert errs[n] <= limit, (n, errs[n])
        for name in (n for n in want[1] if n.startswith("enc_")):
            assert _rel_err(got[1][name], want[1][name]) <= tol, name
        return
    for name in got[0]:
        assert got[0][name].dtype == dtype
        assert _rel_err(got[0][name], want[0][name]) <= tol, name
    for name in want[1]:
        wtol = tol if name.startswith("enc_") else (1e-4 if dtype == torch.float32 else 1e-3)
        assert got[1][name].dtype == torch.float32
        assert _rel_err(got[1][name], want[1][name]) <= wtol, name


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mp_bwd_kernel_is_deterministic(cuda, dtype, f):
    """Two launches on the same inputs give bit-identical outputs and
    weight gradients (no float atomics decide a summation order)."""
    t, p, _ = _bwd_case(cuda, dtype, False, n=2000, k=40, f=f)
    kp = fused_mp.kernel_params(p, dtype)
    args = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], kp, t["ge"], t["gh"])
    a = _at("gns_mp_step_bwd", *args, f=f)
    b = _at("gns_mp_step_bwd", *args, f=f)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    for name in fused_mp.BWD_PARAM_ORDER:
        assert torch.equal(a[4][name], b[4][name]), name


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("n,k", RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mp_bwd_kernel_ragged(cuda, n, k, dtype, f):
    """K4 at ragged shapes (so at every grid from 1 block to one per SM)
    against its plain version: outputs within 1e-4 of the largest magnitude
    (float32) or 1e-2 in the 2-norm (bf16, see chip_smoke.K4_TOL), weight
    gradients within 1e-4 of the largest magnitude (float32) or 5e-3 in the
    2-norm (bf16: the two versions sum agg, dx1 and dfirst in other orders,
    and where a bf16 rounding of T(agg), T(dx1) or T(dfirst) falls on the
    other side of a tie, a term moves by a bf16 ulp or a ReLU of the node
    path flips; one flip moves a node weight's gradient by ~1 / sqrt(N F)
    in the 2-norm, and the H100 read up to 1.3e-3 at N = 1 and 16,000); and
    two launches give the same bits. At F in ``K4_TIE_WIDTHS`` the float32
    outputs and weight gradients are held, within the same limits, to the
    plain version in float64 with its relu ties resolved as the kernel
    resolved them (``k4_ties.relu_tie_reference``): the H100 read up to
    3.2e-2 on the weight gradients against the float32 plain version at N
    = 16,000 (F = 64 to 256, K = 1 to 40); at F = 100 and 192, K = 24, a
    relu(node_first) tie of the kernel's (100), relu(first) ties of both
    versions and a node tie of the float32 plain version's own (192)
    separate them from the float64 one (``experiments/k4_ties.py``). At F
    in ``BF16_TIE_WIDTHS`` the bf16 weight gradients are held within this
    limit to the plain version with its sums in float64 fed the kernel's
    T(agg), and its agg to the float64 sum within 1e-4 in the 2-norm
    (``chip_smoke.bf16_tie_check``; against the float32 plain version the
    H100 read 1.28e-2 on W_nh at N = 1,000, K = 24, F = 192)."""
    _check_bwd_ragged(cuda, n, k, dtype, f)


def _check_bwd_ragged(cuda, n, k, dtype, f):
    t, p, _ = _bwd_case(cuda, dtype, False, n=n, k=k, f=f)
    kp = fused_mp.kernel_params(p, dtype)
    args = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], kp, t["ge"], t["gh"])
    got = _at("gns_mp_step_bwd", *args, f=f)
    again = _at("gns_mp_step_bwd", *args, f=f)
    want = fused_mp.gns_mp_step_bwd_plain(*args)
    if dtype == torch.float32 and f in K4_TIE_WIDTHS:
        want = k4_ties.relu_tie_reference(args, got)[0]
    for x, y, z in zip(got[:4], want[:4], again[:4]):
        assert x.dtype == dtype and x.shape == y.shape and torch.equal(x, z)
        if dtype == torch.float32:
            assert _rel_err(x, y) <= 1e-4
        else:
            assert float((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)) <= 1e-2
    for name in fused_mp.BWD_PARAM_ORDER:
        assert torch.equal(got[4][name], again[4][name]), name
    if dtype == torch.bfloat16 and f in BF16_TIE_WIDTHS:
        import chip_smoke

        def l2(x, y):
            return float((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30))

        agg_err, errs, _ = chip_smoke.bf16_tie_check(args[:5], args[5], args[6:], l2)
        assert agg_err <= 1e-4 and errs["nf_outside"] == 0
        for name in fused_mp.BWD_PARAM_ORDER:
            assert errs[name] <= 5e-3, (name, errs[name])
        return
    for name in fused_mp.BWD_PARAM_ORDER:
        x, y = got[4][name], want[4][name]
        if dtype == torch.float32:
            assert _rel_err(x, y) <= 1e-4, name
        else:
            assert float((x - y).norm() / y.norm().clamp_min(1e-30)) <= 5e-3, name


# the wide instances (bf16: the stream design; float32: the tile design) at
# receiver counts that are not a multiple of a slice (16), of a block's 128
# rows or of the SMs, with K from 1 to 40: slices that straddle receivers,
# warps and blocks left without a slice, ragged weight-gradient ranges
WIDE = (192, 256)
WIDE_RAGGED = [(n, k) for n in (5, 141, 2999) for k in (1, 13, 40)]


@pytest.mark.parametrize("f", WIDE)
@pytest.mark.parametrize("n,k", WIDE_RAGGED)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_wide_fused_mp_kernel_ragged(cuda, n, k, dtype, tol, use_enc, f):
    """K3 (plain and encoder step) at F = 192 and 256 at ragged shapes, K3's
    limits; two launches give the same bits."""
    _check_fwd_ragged(cuda, n, k, dtype, tol, use_enc, f)


@pytest.mark.parametrize("f", WIDE)
@pytest.mark.parametrize("n,k", WIDE_RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_fused_mp_bwd_kernel_ragged(cuda, n, k, dtype, f):
    """K4 at F = 192 and 256 at ragged shapes under the limits and tie rules
    of ``test_fused_mp_bwd_kernel_ragged``; its outputs and weight
    gradients are the same bits over two launches."""
    _check_bwd_ragged(cuda, n, k, dtype, f)


@pytest.mark.parametrize("f", WIDER)
@pytest.mark.parametrize("n,k", WIDE_RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wider_fused_mp_bwd_kernel_ragged(cuda, n, k, dtype, f):
    """K4 on the wide path (F > 256) at ragged shapes (receivers not a
    multiple of the row kernels' 8 warps or of a product's 128-row tile,
    ragged 32-row weight-gradient ranges) under the limits and tie rules of
    ``test_fused_mp_bwd_kernel_ragged``; its outputs and weight gradients
    are the same bits over two launches."""
    _check_bwd_ragged(cuda, n, k, dtype, f)


# the wgmma design (bf16, F in (256, 512]): K from 1 to past two 64-row
# tiles, fewer edge rows than one tile, ragged last tiles
WGMMA_F = (320, 512)
WGMMA_RAGGED = [(1, 1), (40, 1), (3, 13), (333, 24), (101, 40), (17, 64), (9, 65), (5, 130)]


@pytest.mark.parametrize("f", WGMMA_F)
@pytest.mark.parametrize("n,k", WGMMA_RAGGED)
@pytest.mark.parametrize("use_enc", [False, True], ids=["plain_step", "encoder_step"])
def test_wgmma_fused_mp_kernel_ragged(cuda, n, k, use_enc, f):
    """K3 (plain and encoder step) on the wgmma design at K in {1, 13, 24,
    40, 64, 65, 130} (a receiver's rows within one 64-row tile, across two,
    or across three), with fewer edge rows than a tile and ragged last
    tiles: K3's bf16 limit against its plain version, and two launches the
    same bits."""
    assert fused_mp._design(torch.bfloat16, f) == "wgmma"
    _check_fwd_ragged(cuda, n, k, torch.bfloat16, 0.125, use_enc, f)


# K4's wgmma design: every instance width, K from 1 to past two 64-row
# tiles, fewer edge rows than a tile, more tiles than the persistent grid
WGMMA_BWD_F = (320, 384, 448, 512)
WGMMA_BWD_RAGGED = [(1, 1), (40, 1), (3, 13), (101, 40), (9, 65), (5, 130), (2999, 13)]


@pytest.mark.parametrize("f", WGMMA_BWD_F)
@pytest.mark.parametrize("n,k", WGMMA_BWD_RAGGED)
def test_wgmma_fused_mp_bwd_kernel_ragged(cuda, n, k, f):
    """K4 on the wgmma design (the edge-backward kernel and the wgmma
    weight-gradient kernel, ``csrc/mp_wgmma_bwd.cuh``) at ragged shapes,
    under the limits and tie rule of ``test_fused_mp_bwd_kernel_ragged``
    (every instance width is in ``BF16_TIE_WIDTHS``: held to the plain
    version summed in float64 and fed the kernel's T(agg)); its outputs and
    weight gradients are the same bits over two launches."""
    assert fused_mp._design(torch.bfloat16, f) == "wgmma" and f in BF16_TIE_WIDTHS
    _check_bwd_ragged(cuda, n, k, torch.bfloat16, f)


@pytest.mark.parametrize("f", WGMMA_BWD_F)
@pytest.mark.parametrize("n,k", [(333, 24), (101, 40), (9, 65), (1, 1)])
def test_wgmma_k4_rematerializes_k3_bits(cuda, n, k, f):
    """K4 rematerializes the forward through K3's own edge kernel: its
    T(relu(first)) and agg (check-only outputs ``first_out``, ``agg_out``)
    equal K3's on the same inputs bit for bit, so T(agg) does too, and both
    hold to the plain version's T(relu(first)) under K3's bf16 limit."""
    bf16 = torch.bfloat16
    t, p, _ = _bwd_case(cuda, bf16, False, n=n, k=k, f=f)
    kp = fused_mp.kernel_params(p, bf16)
    fwd = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], kp)
    first3 = torch.empty((n, k, f), dtype=bf16, device=cuda)
    agg3 = torch.empty((n, f), dtype=torch.float32, device=cuda)
    fused_mp.gns_mp_step(*fwd, latent=f, first_out=first3, agg_out=agg3)
    first4, agg4 = torch.empty_like(first3), torch.empty_like(agg3)
    before = fused_mp.FUSED_MP_BWD.launches
    fused_mp.gns_mp_step_bwd(*fwd, t["ge"], t["gh"], latent=f, agg_out=agg4, first_out=first4)
    assert fused_mp.FUSED_MP_BWD.launches == before + 1
    assert torch.equal(first3, first4) and torch.equal(agg3, agg4)
    assert torch.equal(agg3.to(bf16), agg4.to(bf16))
    acc = torch.float32
    first = (t["e"].to(acc) @ kp["w_e"].to(acc) + t["hs"].to(acc) + t["hr"].to(acc)[:, None]
             + kp["b1"])
    assert float((torch.relu(first) - first4.float()).abs().max()) <= 0.125


def _painn_case(cuda, dtype, dim, n=203, k=24, fused=False, seed=None, h=128, r=20):
    """Random K5 / K6 inputs at H = h (R = r for K5) with padded slots.
    K5's: packed (n, (2 + dim) H) node rows and an int32 (n, k) sender
    index that repeats rows and points padded slots (scale 0) at row n - 1."""
    from lagrangebench_torch.ops import painn_msg

    g = torch.Generator().manual_seed(dim + 10 * fused if seed is None else seed)
    mask = (torch.rand(n, k, generator=g) < 0.8).to(torch.float32)
    nd = torch.randn(n, k, dim, generator=g)
    if fused:
        senders = torch.randint(0, n, (n, k), generator=g)
        senders[:, k // 2] = senders[:, 0]  # a repeated sender row
        senders = torch.where(mask > 0, senders, n)
        phi = torch.cat([torch.rand(n, k, r, generator=g),
                         torch.rand(n, k, 1, generator=g) * mask[..., None]], dim=-1)
        t = {"packed": torch.randn(n, (2 + dim) * h, generator=g), "phi": phi, "nd": nd,
             "s": torch.randn(n, h, generator=g), "v": torch.randn(n, dim * h, generator=g)}
        p = {"filt_w": torch.randn(r, 3 * h, generator=g) / r**0.5,
             "filt_b": 0.1 * torch.randn(3 * h, generator=g),
             "vmix_w": torch.randn(h, 2 * h, generator=g) / h**0.5,
             "mix_w1": torch.randn(2 * h, h, generator=g) / (2 * h) ** 0.5,
             "mix_b1": 0.1 * torch.randn(h, generator=g),
             "mix_w2": torch.randn(h, 3 * h, generator=g) / h**0.5,
             "mix_b2": 0.1 * torch.randn(3 * h, generator=g)}
        p = {name: v.to(cuda) for name, v in p.items()}
        p["sidx"] = painn_msg.sender_index(senders, n).to(cuda)
    else:
        t = {"g": torch.randn(n, k, (3 + dim) * h, generator=g),
             "wij": torch.randn(n, k, 3 * h, generator=g) * mask[..., None], "nd": nd}
        p = None
    return {name: v.to(dtype).to(cuda) for name, v in t.items()}, p


def _layer_args(t, p):
    """(packed, sidx, phi, nd, s, v, params) of K5 from :func:`_painn_case`."""
    params = {name: v for name, v in p.items() if name != "sidx"}
    return (t["packed"], p["sidx"], t["phi"], t["nd"], t["s"], t["v"], params)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("h", HIDDENS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("dim", [2, 3])
def test_painn_msg_kernel(cuda, dtype, tol, dim, h):
    """K6 against its plain version: float32 outputs from the same inputs,
    max error relative to the largest magnitude within 1e-5 (both sum in
    float32, in other orders), at each hidden width."""
    from lagrangebench_torch.ops import painn_msg

    t, _ = _painn_case(cuda, dtype, dim, h=h)
    before = painn_msg.PAINN_MSG.launches
    got = painn_msg.painn_message(t["g"], t["wij"], t["nd"], h)
    assert painn_msg.PAINN_MSG.launches == before + 1
    want = painn_msg.painn_message_plain(t["g"], t["wij"], t["nd"], h)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= tol


@pytest.mark.parametrize("h,r", [(h, r) for h in HIDDENS for r in RBFS])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dim", [2, 3])
def test_painn_layer_kernel(cuda, dtype, tol, dim, h, r):
    """K5 against its plain version, max error relative to the largest
    magnitude: 1e-4 in float32 (TF32 off), 2e-2 in bf16 (outputs rounded
    to bf16, whose ulp is 2^-8 of a value; a sum in another order can move
    s1, v1_d, ts or z across a rounding boundary before the next product).
    The relative 2-norm within 1e-3 in both: such moves are rare (these
    random inputs read up to ~3e-4 in bf16), while a kernel that skipped one
    of those roundings would move every value it feeds by up to half an
    ulp. chip_smoke.py holds K5 to 1e-4 on the model's own inputs. At each
    hidden width H and radial-basis width R."""
    from lagrangebench_torch.ops import painn_msg

    t, p = _painn_case(cuda, dtype, dim, fused=True, h=h, r=r)
    args = _layer_args(t, p)
    before = painn_msg.PAINN_LAYER.launches
    got = painn_msg.painn_layer(*args)
    assert painn_msg.PAINN_LAYER.launches == before + 1
    want = painn_msg.painn_layer_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _rel(a, b) <= tol
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-3


@pytest.mark.parametrize("h,r", [(320, 96), (320, 128), (512, 96), (512, 128), (128, 96),
                                 (1024, 20), (512, 20), (1088, 20), (64, 264), (320, 600)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dim", [2, 3])
def test_painn_layer_kernel_wide(cuda, dtype, tol, dim, h, r):
    """K5's tensor-core design (H > 256 or R > 64) against its plain version
    under the limits of ``test_painn_layer_kernel``, at ragged receivers
    (203: not a multiple of its tile), past the old limits too (H = 1,088, R
    = 264; R = 600, whose filter rows no longer fit a block in either dtype
    and stream from device memory); H, R or dim outside what the kernels
    take (below 1; dim 4) raises ValueError and launches nothing."""
    from lagrangebench_torch.ops import painn_msg

    t, p = _painn_case(cuda, dtype, dim, fused=True, h=h, r=r)
    args = _layer_args(t, p)
    before = painn_msg.PAINN_LAYER.launches
    got = painn_msg.painn_layer(*args)
    assert painn_msg.PAINN_LAYER.launches == before + 1
    want = painn_msg.painn_layer_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _rel(a, b) <= tol
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-3
    t, p = _painn_case(cuda, dtype, dim, n=20, k=4, fused=True, h=h, r=r)
    args = list(_layer_args(t, p))
    args[3] = torch.zeros(*args[3].shape[:-1], 4, dtype=args[3].dtype, device=cuda)
    with pytest.raises(ValueError, match=r"dim 4 \(needs 2 or 3\)"):
        painn_msg.painn_layer_kernel(*args)
    assert painn_msg.PAINN_LAYER.launches == before + 1


K5_RAGGED = [(n, k) for n in (1, 37, 16000) for k in (1, 40)]


@pytest.mark.parametrize("n,k", K5_RAGGED)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_painn_layer_kernel_ragged(cuda, n, k, dim, dtype):
    """K5 with the gather inside at ragged shapes (a last tile of 1-15
    receivers, one slot, the rollout's 16,000 x 40) against its plain
    version: float32 (TF32 off) within 1e-4 of the largest magnitude; bf16
    as test_painn_layer_kernel holds these random inputs, within 1e-3 in
    the relative 2-norm and 2e-2 of the largest magnitude. On them a sum in
    another order moves a rounded s1, v1_d, ts or z across a bf16 rounding
    boundary often enough to read ~2e-4 in the 2-norm at 16,000 receivers;
    chip_smoke.py holds K5 to 2e-4 on the model's own inputs, against its
    plain version summed in float64."""
    from lagrangebench_torch.ops import painn_msg

    t, p = _painn_case(cuda, dtype, dim, n=n, k=k, fused=True, seed=n + k + dim)
    args = _layer_args(t, p)
    got = painn_msg.painn_layer_kernel(*args)
    want = painn_msg.painn_layer_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.float32:
            assert _rel(a, b) <= 1e-4
        else:
            assert _rel(a, b) <= 2e-2
            assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_painn_layer_kernel_halo_rows(cuda, dtype):
    """K5 with a source table of M = 3N rows (a slab and its two halo slabs
    under spatial sharding; senders in [0, 3N], the fill clamped to row
    3N - 1) against its plain version: float32 (TF32 off) within 1e-4 of
    the largest magnitude; bf16 within 1e-3 in the relative 2-norm."""
    from lagrangebench_torch.ops import painn_msg

    t, p = _painn_case(cuda, dtype, 3, fused=True, seed=7)
    n, k = t["phi"].shape[:2]
    g = torch.Generator().manual_seed(8)
    h = t["s"].shape[-1]
    packed = torch.randn(3 * n, 5 * h, generator=g).to(dtype).to(cuda)
    senders = torch.randint(0, 3 * n, (n, k), generator=g)
    senders = torch.where(t["phi"][..., -1].cpu() > 0, senders, 3 * n)
    p["sidx"] = painn_msg.sender_index(senders, 3 * n).to(cuda)
    args = (packed,) + _layer_args(t, p)[1:]
    got = painn_msg.painn_layer_kernel(*args)
    want = painn_msg.painn_layer_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if dtype == torch.float32:
            assert _rel(a, b) <= 1e-4
        else:
            assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-3


K5_TC_RAGGED = [(n, k) for n in (1, 37, 16000) for k in (1, 40)]


def _k5_gate(got, want, dtype):
    """float32 (TF32 off) within 1e-4 of the largest magnitude; bf16 within
    2e-2 of it and 1e-3 in the relative 2-norm (test_painn_layer_kernel)."""
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.float32:
            assert _rel(a, b) <= 1e-4
        else:
            assert _rel(a, b) <= 2e-2
            assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-3


@pytest.mark.parametrize("n,k", K5_TC_RAGGED)
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_painn_layer_kernel_tc_ragged(cuda, n, k, dim, dtype):
    """K5's tensor-core design at H = 512, R = 20 (PaiNN-5-512's) at ragged
    shapes: a last edge block of 1-31 receivers and node tile of 1-63, one
    slot (one n8 tile of edges, 7 of it padding), the rollout's 16,000 x
    40; under test_painn_layer_kernel_ragged's limits."""
    from lagrangebench_torch.ops import painn_msg

    t, p = _painn_case(cuda, dtype, dim, n=n, k=k, fused=True, seed=n + k + dim, h=512, r=20)
    args = _layer_args(t, p)
    before = painn_msg.PAINN_LAYER.launches
    got = painn_msg.painn_layer_kernel(*args)
    assert painn_msg.PAINN_LAYER.launches == before + 1
    want = painn_msg.painn_layer_plain(*args)
    torch.cuda.synchronize()
    _k5_gate(got, want, dtype)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_painn_layer_kernel_tc_halo_rows(cuda, dtype, dim):
    """K5's tensor-core design at H = 512 with a source table of M = 3N rows
    (senders in [0, 3N], the fill clamped to row 3N - 1) against its plain
    version under test_painn_layer_kernel_ragged's limits."""
    from lagrangebench_torch.ops import painn_msg

    t, p = _painn_case(cuda, dtype, dim, fused=True, seed=17, h=512, r=20)
    n, k = t["phi"].shape[:2]
    g = torch.Generator().manual_seed(18)
    packed = torch.randn(3 * n, (2 + dim) * 512, generator=g).to(dtype).to(cuda)
    senders = torch.randint(0, 3 * n, (n, k), generator=g)
    senders = torch.where(t["phi"][..., -1].cpu() > 0, senders, 3 * n)
    p["sidx"] = painn_msg.sender_index(senders, 3 * n).to(cuda)
    args = (packed,) + _layer_args(t, p)[1:]
    got = painn_msg.painn_layer_kernel(*args)
    want = painn_msg.painn_layer_plain(*args)
    torch.cuda.synchronize()
    _k5_gate(got, want, dtype)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_painn_layer_kernel_tc_repeats_bits(cuda, dtype, dim):
    """Two launches of K5's tensor-core design (H = 512, R = 20) on the same
    inputs give the same bits: no atomics, every output written by one
    thread in a fixed order."""
    from lagrangebench_torch.ops import painn_msg

    t, p = _painn_case(cuda, dtype, dim, n=2000, k=40, fused=True, seed=23, h=512, r=20)
    args = _layer_args(t, p)
    first = painn_msg.painn_layer_kernel(*args)
    second = painn_msg.painn_layer_kernel(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_painn_layer_kernel_gradients(cuda):
    """The autograd Function around K5: gradients (rematerialized through
    the plain version, packed's through the gather) equal those of the
    plain version itself. packed's gradient sums the rows of every slot
    that gathered it, in float32 with atomics in either backward, in other
    orders: within 1e-5 of its largest magnitude."""
    from lagrangebench_torch.ops import painn_msg

    t, p = _painn_case(cuda, torch.float32, 3, fused=True)
    packed, sidx, _, nd, _, _, params = _layer_args(t, p)
    names = ("packed", "phi", "s", "v")
    ins = {name: t[name].clone().requires_grad_() for name in names}
    leaves = {name: v.clone().requires_grad_() for name, v in params.items()}
    out = painn_msg.painn_layer(ins["packed"], sidx, ins["phi"], nd, ins["s"], ins["v"], leaves)
    grads = torch.autograd.grad(sum(o.sum() for o in out), [*ins.values(), *leaves.values()])
    ins2 = {name: t[name].clone().requires_grad_() for name in names}
    leaves2 = {name: v.clone().requires_grad_() for name, v in params.items()}
    out2 = painn_msg.painn_layer_plain(ins2["packed"], sidx, ins2["phi"], nd, ins2["s"],
                                       ins2["v"], leaves2)
    want = torch.autograd.grad(sum(o.sum() for o in out2), [*ins2.values(), *leaves2.values()])
    assert _rel(grads[0], want[0]) <= 1e-5
    for a, b in zip(grads[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pbc", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_neighbor_scan_geometry_kernel(cuda, dim, pbc):
    """K9 through a batched update: senders and flags equal the plain
    version's exactly, the geometry within 1e-6 (both round alike: no FMA
    contraction, correctly rounded sqrt)."""
    rng = np.random.default_rng(dim + 7)
    pos = torch.as_tensor(rng.uniform(0, 1, size=(2, 400, dim)), device=cuda)
    nl = neighbor_list(None, [1.0] * dim, 0.12, pbc=[pbc] * dim, emit_geometry=True)
    shell = nl.allocate_shell(pos[0].cpu().numpy(), capacity_boost=1.5)
    before = neighbors_cuda.NEIGHBOR_SCAN_GEOMETRY.launches
    got = shell.broadcast(2).update(pos, num_particles=torch.tensor([400, 350]))
    assert neighbors_cuda.NEIGHBOR_SCAN_GEOMETRY.launches == before + 1
    want = shell.broadcast(2).update(pos.cpu(), num_particles=torch.tensor([400, 350]))
    assert torch.equal(got.idx.cpu(), want.idx)
    assert torch.equal(got.did_buffer_overflow.cpu(), want.did_buffer_overflow)
    for key in ("rel_disp", "rel_dist"):
        assert float((got.aux[key].cpu() - want.aux[key]).abs().max()) <= 1e-6


@pytest.mark.parametrize("pbc", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_slot_scan_kernel(cuda, dim, pbc):
    """K7 through a slot update: the candidate matrix, the maps and the flag
    equal the plain version's exactly, the geometry within 1e-6."""
    rng = np.random.default_rng(dim + 11)
    pos = torch.as_tensor(rng.uniform(0, 1, size=(500, dim)), device=cuda)
    nl = neighbor_list(None, [1.0] * dim, 0.12, pbc=[pbc] * dim, format="slot")
    shell = nl.allocate_shell(pos.cpu().numpy(), capacity_boost=1.5)
    before = neighbors_cuda.SLOT_SCAN.launches
    got = shell.update(pos, num_particles=470)
    assert neighbors_cuda.SLOT_SCAN.launches == before + 1
    want = shell.update(pos.cpu(), num_particles=470)
    assert torch.equal(got.idx.cpu(), want.idx)
    assert torch.equal(got.did_buffer_overflow.cpu(), want.did_buffer_overflow)
    for key in ("slot_to_particle", "particle_to_slot", "bases"):
        assert torch.equal(got.aux[key].cpu(), want.aux[key]), key
    for key in ("rel_disp", "rel_dist"):
        assert float((got.aux[key].cpu() - want.aux[key]).abs().max()) <= 1e-6


SCAN_CASES = ["chunked", "empty_columns", "single"]
_SCAN_HANDLES = {"senders": "NEIGHBOR_SCAN", "geometry": "NEIGHBOR_SCAN_GEOMETRY",
                 "slot": "SLOT_SCAN"}


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("emit", ["senders", "geometry", "slot"])
@pytest.mark.parametrize("pbc", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_scan_kernels_edge_cases(cuda, monkeypatch, dim, pbc, emit, case):
    """K2, K9 and K7 through an update against the plain versions: ids,
    maps and flags exactly, the geometry within 1e-6. ``chunked`` cuts the
    stage budget so that one stencil column is staged at a time (chunk 1 <
    S, the path of a column capacity past the budget); ``empty_columns``
    packs the particles into a corner of the box; ``single`` is one
    particle."""
    rng = np.random.default_rng(dim + 2 * pbc + 5 * SCAN_CASES.index(case))
    if case == "single":
        pos_np = rng.uniform(0, 1, size=(1, dim))
    else:
        pos_np = rng.uniform(0, 0.4 if case == "empty_columns" else 1.0, size=(300, dim))
    n = len(pos_np)
    chunks = []
    real_chunk = neighbors_cuda.scan_chunk

    def scan_chunk(cap, n_steps):
        chunks.append((real_chunk(cap, n_steps), n_steps))
        return chunks[-1][0]

    monkeypatch.setattr(neighbors_cuda, "scan_chunk", scan_chunk)
    if case == "chunked":
        monkeypatch.setattr(neighbors_cuda, "SCAN_SMEM_TARGET", 1)
    kw = {"geometry": {"emit_geometry": True}, "slot": {"format": "slot"}}.get(emit, {})
    nl = neighbor_list(None, [1.0] * dim, 0.12, pbc=[pbc] * dim, **kw)
    shell = nl.allocate_shell(pos_np, capacity_boost=1.5)
    if emit == "slot":
        pos, npart = torch.as_tensor(pos_np), max(n - 20, 1)
    else:
        shell = shell.broadcast(2)
        pos = torch.as_tensor(np.stack([pos_np, pos_np[::-1].copy()]))
        npart = torch.tensor([n, max(n - n // 3, 1)])
    handle = getattr(neighbors_cuda, _SCAN_HANDLES[emit])
    before = handle.launches
    got = shell.update(pos.to(cuda), num_particles=npart)
    assert handle.launches == before + 1
    if case == "chunked":
        assert chunks[-1][0] < chunks[-1][1]
    want = shell.update(pos, num_particles=npart)
    assert torch.equal(got.idx.cpu(), want.idx)
    assert torch.equal(got.did_buffer_overflow.cpu(), want.did_buffer_overflow)
    for key, value in (want.aux or {}).items():
        if key in ("rel_disp", "rel_dist"):
            assert float((got.aux[key].cpu() - value).abs().max()) <= 1e-6, key
        else:
            assert torch.equal(got.aux[key].cpu(), value), key


def _slot_case(cuda, dtype, use_enc, seed=0, particles=600, f=128):
    """A 3D slot graph and seeded K8 inputs on the card, latent width f."""
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    nl = neighbor_list(None, [1.0] * 3, 0.15, format="slot").allocate(
        torch.as_tensor(rng.uniform(0, 1, size=(particles, 3))))
    cand, bases = nl.idx.to(cuda), nl.aux["bases"].to(cuda)
    n, k = cand.shape
    p = fused_mp.kernel_params(
        {name: (torch.randn(f, f, generator=g) / f**0.5 if name.startswith("w")
                else 0.1 * torch.randn(f, generator=g)) for name in fused_mp.PARAM_NAMES},
        dtype,
    )
    enc = fused_mp.kernel_params({
        "enc_w1": torch.randn(4, f, generator=g), "enc_w2": torch.randn(f, f, generator=g) / f**0.5,
        "enc_b1": torch.zeros(f), "enc_b2": torch.zeros(f),
        "enc_ln_scale": torch.ones(f), "enc_ln_bias": torch.zeros(f),
    }, dtype) if use_enc else None
    p = {name: v.to(cuda) for name, v in p.items()}
    enc = {name: v.to(cuda) for name, v in enc.items()} if enc else None
    e = torch.randn(n, k, 4 if use_enc else f, generator=g)
    e = (e if use_enc else e.to(dtype)).to(cuda)
    hs, hr, h = (torch.randn(n, f, generator=g).to(dtype).to(cuda) for _ in range(3))
    return e, cand, bases, hs, hr, h, p, enc


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("particles", [600, 37, 5000])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_fused_mp_slot_kernel(cuda, dtype, tol, use_enc, particles, f):
    """K8 vs its plain version: max |kernel - plain| within K3's limits,
    1e-4 (float32) and 0.125 (bf16), on slot graphs of 37 to 5,000
    particles, at each compiled width."""
    args = _slot_case(cuda, dtype, use_enc, particles=particles, f=f)
    handle = fused_mp.FUSED_MP_SLOT_ENC if use_enc else fused_mp.FUSED_MP_SLOT
    before = handle.launches
    got = _at("gns_mp_step_slot", *args, f=f)
    assert handle.launches == before + 1
    want = fused_mp.gns_mp_step_slot_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol


def test_fused_mp_slot_kernel_gradients(cuda):
    """The autograd Function around K8: gradients (rematerialized through
    the plain version) equal those of the plain version itself, float32."""
    e, cand, bases, hs, hr, h, p, _ = _slot_case(cuda, torch.float32, False, seed=1)
    ins = [t.clone().requires_grad_() for t in (e, hs, hr, h)]
    used = {name: p[name] for name in fused_mp.BWD_PARAM_ORDER}  # not w_s, w_r
    leaves = {name: v.clone().requires_grad_() for name, v in used.items()}
    out = fused_mp.gns_mp_step_slot_autograd(ins[0], cand, bases, *ins[1:], leaves)
    grads = torch.autograd.grad(sum(o.sum() for o in out), [*ins, *leaves.values()])
    ins2 = [t.clone().requires_grad_() for t in (e, hs, hr, h)]
    leaves2 = {name: v.clone().requires_grad_() for name, v in used.items()}
    out2 = fused_mp.gns_mp_step_slot_plain(ins2[0], cand, bases, *ins2[1:], leaves2)
    want = torch.autograd.grad(sum(o.sum() for o in out2), [*ins2, *leaves2.values()])
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_kernel(cuda, dtype, transposed, reps):
    """E1 vs its plain version, equal in every form: dtype, (R, K) or
    transposed (K, R) index, the gather or the float32 sum of ``reps``."""
    from lagrangebench_torch.ops import row_gather

    rng = np.random.default_rng(reps)
    h = torch.as_tensor(rng.normal(size=(300, 128)), dtype=dtype, device=cuda)
    idx = rng.integers(0, 300, size=(257, 24)).astype(np.int32)
    idx = torch.as_tensor(idx.T.copy() if transposed else idx, device=cuda)
    before = row_gather.ROW_GATHER.launches
    got = row_gather.row_gather(h, idx, transposed=transposed, reps=reps)
    assert row_gather.ROW_GATHER.launches == before + 1
    want = row_gather.row_gather_plain(h, idx, transposed=transposed, reps=reps)
    assert got.shape == want.shape == (257, 24, 128) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,dtype", [((64,), torch.float32), ((500, 7), torch.float32),
                                         ((500, 7), torch.bfloat16)])
@pytest.mark.parametrize("width", [8, 256, 1024])
def test_row_gather_kernel_shapes(cuda, shape, dtype, width):
    """E1 on a flat index and on rows narrower and wider than a warp's 32
    vectors of 16 bytes, equal to the plain version."""
    from lagrangebench_torch.ops import row_gather

    rng = np.random.default_rng(width)
    h = torch.as_tensor(rng.normal(size=(100, width)), dtype=dtype, device=cuda)
    idx = torch.as_tensor(rng.integers(0, 100, size=shape).astype(np.int32), device=cuda)
    for reps in (1, 24):
        got = row_gather.row_gather(h, idx, reps=reps)
        assert torch.equal(got, row_gather.row_gather_plain(h, idx, reps=reps))


def _window_case(cuda, dtype, seed=0, particles=1000, f=128):
    """A reduced windowed structure in 3D and seeded E2 inputs on the card,
    latent width f."""
    from lagrangebench_torch.experiments import window_select

    n_rows, n_ext, ext_idx, cand, w0s, _, wsub = window_select.build_structure(
        particles, 3, 24, 1.45 * 0.1, seed=seed)
    g = torch.Generator().manual_seed(seed)
    p = fused_mp.kernel_params(window_select.init_step_params(f, g), dtype)
    p = {name: v.to(cuda) for name, v in p.items()}
    e = torch.randn(n_rows, 24, f, generator=g).to(dtype).to(cuda)
    hr, h, hs = (torch.randn(n_rows, f, generator=g).to(dtype).to(cuda) for _ in range(3))
    hs_ext = hs[torch.as_tensor(ext_idx, device=cuda)]
    return (e, torch.as_tensor(cand, device=cuda), torch.as_tensor(w0s, device=cuda), wsub,
            hs_ext, hr, h, p)


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("particles", [1000, 200])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
def test_fused_mp_window_kernel(cuda, dtype, tol, particles, f):
    """E2 vs its plain version: max |kernel - plain| within K3's limits,
    1e-4 (float32) and 0.125 (bf16); and E2 equal to K3 on the decoded,
    masked gather (the same arithmetic row for row); at each compiled
    width."""
    args = _window_case(cuda, dtype, particles=particles, f=f)
    e, cand, w0s, wsub, hs_ext, hr, h, p = args
    before = fused_mp.FUSED_MP_WINDOW.launches
    got = _at("gns_mp_step_window", *args, f=f)
    assert fused_mp.FUSED_MP_WINDOW.launches == before + 1
    want = fused_mp.gns_mp_step_window_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol
    rows, mask = fused_mp.window_sender_rows(cand, w0s, wsub)
    hs_g = torch.where(mask[..., None], hs_ext[rows], 0).to(dtype).contiguous()
    k3 = _at("gns_mp_step", e, hs_g, hr, h, mask.to(torch.float32), p, f=f)
    for a, b in zip(got, k3):
        assert torch.equal(a, b)
