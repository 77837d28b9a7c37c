"""CUDA kernels K1-K9, E1 and E2 against their plain versions, on the card.

Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is false and
run on a machine with a card (``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_kernels.py``; the root conftest imports JAX). float32
comparisons run with TF32 off.
"""

import numpy as np
import pytest
import torch

from lagrangebench_torch.ops import fused_mp, neighbors_cuda
from lagrangebench_torch.ops.neighbors import ColumnGrid, neighbor_list

pytestmark = pytest.mark.gpu


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


def _fwd_case(cuda, dtype, use_enc, n, k):
    g = torch.Generator().manual_seed(0)
    f = fused_mp.LATENT
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_fused_mp_kernel(cuda, dtype, tol, use_enc):
    """max |kernel - plain| within 1e-4 (float32) or 0.125 (bf16: outputs of
    a few units, where one bf16 ulp is 1/64..1/32)."""
    args = _fwd_case(cuda, dtype, use_enc, 333, 24)
    got = fused_mp.gns_mp_step(*args)
    want = fused_mp.gns_mp_step_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= tol


# receivers not a multiple of a slice, a block's slices or the SM count;
# edge rows per receiver that leave slices ragged; fewer slices than warps
RAGGED = [(n, k) for n in (1, 17, 1000, 16000) for k in (1, 7, 24, 40)]


@pytest.mark.parametrize("n,k", RAGGED)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_fused_mp_kernel_ragged(cuda, n, k, dtype, tol, use_enc):
    """K3 at ragged shapes, K3's limits; two launches give the same bits."""
    args = _fwd_case(cuda, dtype, use_enc, n, k)
    got = fused_mp.gns_mp_step(*args)
    again = fused_mp.gns_mp_step(*args)
    want = fused_mp.gns_mp_step_plain(*args)
    for a, b, c in zip(got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol
        assert torch.equal(a, c)


def _bwd_case(cuda, dtype, use_enc, n=333, k=24):
    g = torch.Generator().manual_seed(1)
    f = fused_mp.LATENT
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_fused_mp_bwd_kernel(cuda, monkeypatch, dtype, tol, use_enc):
    """K4 through the autograd Function against the same Function with the
    plain backward: max error relative to the largest magnitude within 1e-4
    (float32, TF32 off) or 1e-2 (bf16 outputs); the float32 weight
    gradients of the step within 1e-4 (float32) or 1e-3 (bf16 operands).
    The encoder's weight gradients come from its plain backward, which
    rounds them through bf16 as the JAX mirror does: the bf16 tolerance."""
    t, p, enc = _bwd_case(cuda, dtype, use_enc)

    def grads():
        leaves = {name: v.clone().requires_grad_() for name, v in p.items()}
        eleaves = {name: v.clone().requires_grad_() for name, v in enc.items()} if enc else None
        ins = {name: t[name].clone().requires_grad_() for name in ("hs", "hr", "h")}
        e_out, h_out = fused_mp.gns_mp_step_autograd(
            t["e"], ins["hs"], ins["hr"], ins["h"], t["mask"], leaves, eleaves)
        torch.autograd.backward([e_out, h_out], [t["ge"], t["gh"]])
        outs = {name: v.grad for name, v in ins.items()}
        weights = {name: v.grad for name, v in leaves.items() if v.grad is not None}
        if eleaves:
            weights.update({name: v.grad for name, v in eleaves.items()})
        return outs, weights

    before = fused_mp.FUSED_MP_BWD.launches
    got = grads()
    assert fused_mp.FUSED_MP_BWD.launches == before + 1
    monkeypatch.setattr(fused_mp, "gns_mp_step_bwd", fused_mp.gns_mp_step_bwd_plain)
    want = grads()
    for name in got[0]:
        assert got[0][name].dtype == dtype
        assert _rel_err(got[0][name], want[0][name]) <= tol, name
    for name in want[1]:
        wtol = tol if name.startswith("enc_") else (1e-4 if dtype == torch.float32 else 1e-3)
        assert got[1][name].dtype == torch.float32
        assert _rel_err(got[1][name], want[1][name]) <= wtol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mp_bwd_kernel_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give bit-identical outputs and
    weight gradients (no float atomics decide a summation order)."""
    t, p, _ = _bwd_case(cuda, dtype, False, n=2000, k=40)
    kp = fused_mp.kernel_params(p, dtype)
    args = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], kp, t["ge"], t["gh"])
    a = fused_mp.gns_mp_step_bwd(*args)
    b = fused_mp.gns_mp_step_bwd(*args)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    for name in fused_mp.BWD_PARAM_ORDER:
        assert torch.equal(a[4][name], b[4][name]), name


@pytest.mark.parametrize("n,k", RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mp_bwd_kernel_ragged(cuda, n, k, dtype):
    """K4 at ragged shapes (so at every grid from 1 block to one per SM)
    against its plain version: outputs within 1e-4 of the largest magnitude
    (float32) or 1e-2 in the 2-norm (bf16, see chip_smoke.K4_TOL), weight
    gradients within 1e-4 of the largest magnitude (float32) or 5e-3 in the
    2-norm (bf16: the two versions sum agg, dx1 and dfirst in other orders,
    and where a bf16 rounding of T(agg), T(dx1) or T(dfirst) falls on the
    other side of a tie, a term moves by a bf16 ulp or a ReLU of the node
    path flips; one flip moves a node weight's gradient by ~1 / sqrt(N F)
    in the 2-norm, and the H100 read up to 1.3e-3 at N = 1 and 16,000); and
    two launches give the same bits."""
    t, p, _ = _bwd_case(cuda, dtype, False, n=n, k=k)
    kp = fused_mp.kernel_params(p, dtype)
    args = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], kp, t["ge"], t["gh"])
    got = fused_mp.gns_mp_step_bwd(*args)
    again = fused_mp.gns_mp_step_bwd(*args)
    want = fused_mp.gns_mp_step_bwd_plain(*args)
    for x, y, z in zip(got[:4], want[:4], again[:4]):
        assert x.dtype == dtype and x.shape == y.shape and torch.equal(x, z)
        if dtype == torch.float32:
            assert _rel_err(x, y) <= 1e-4
        else:
            assert float((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30)) <= 1e-2
    for name in fused_mp.BWD_PARAM_ORDER:
        assert torch.equal(got[4][name], again[4][name]), name
        x, y = got[4][name], want[4][name]
        if dtype == torch.float32:
            assert _rel_err(x, y) <= 1e-4, name
        else:
            assert float((x - y).norm() / y.norm().clamp_min(1e-30)) <= 5e-3, name


def _painn_case(cuda, dtype, dim, n=203, k=24, fused=False, seed=None):
    """Random K5 / K6 inputs at H = 128 (R = 20 for K5) with padded slots.
    K5's: packed (n, (2 + dim) H) node rows and an int32 (n, k) sender
    index that repeats rows and points padded slots (scale 0) at row n - 1."""
    from lagrangebench_torch.ops import painn_msg

    g = torch.Generator().manual_seed(dim + 10 * fused if seed is None else seed)
    h = painn_msg.HIDDEN
    mask = (torch.rand(n, k, generator=g) < 0.8).to(torch.float32)
    nd = torch.randn(n, k, dim, generator=g)
    if fused:
        r = painn_msg.N_RBF
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("dim", [2, 3])
def test_painn_msg_kernel(cuda, dtype, tol, dim):
    """K6 against its plain version: float32 outputs from the same inputs,
    max error relative to the largest magnitude within 1e-5 (both sum in
    float32, in other orders)."""
    from lagrangebench_torch.ops import painn_msg

    t, _ = _painn_case(cuda, dtype, dim)
    before = painn_msg.PAINN_MSG.launches
    got = painn_msg.painn_message(t["g"], t["wij"], t["nd"], painn_msg.HIDDEN)
    assert painn_msg.PAINN_MSG.launches == before + 1
    want = painn_msg.painn_message_plain(t["g"], t["wij"], t["nd"], painn_msg.HIDDEN)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _rel(a, b) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dim", [2, 3])
def test_painn_layer_kernel(cuda, dtype, tol, dim):
    """K5 against its plain version, max error relative to the largest
    magnitude: 1e-4 in float32 (TF32 off), 2e-2 in bf16 (outputs rounded
    to bf16, whose ulp is 2^-8 of a value; a sum in another order can move
    s1, v1_d, ts or z across a rounding boundary before the next product).
    The relative 2-norm within 1e-3 in both: such moves are rare (these
    random inputs read up to ~3e-4 in bf16), while a kernel that skipped one
    of those roundings would move every value it feeds by up to half an
    ulp. chip_smoke.py holds K5 to 1e-4 on the model's own inputs."""
    from lagrangebench_torch.ops import painn_msg

    t, p = _painn_case(cuda, dtype, dim, fused=True)
    args = _layer_args(t, p)
    before = painn_msg.PAINN_LAYER.launches
    got = painn_msg.painn_layer(*args)
    assert painn_msg.PAINN_LAYER.launches == before + 1
    want = painn_msg.painn_layer_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert _rel(a, b) <= tol
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= 1e-3


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
    chip_smoke.py holds K5 to 1e-4 on the model's own inputs."""
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


def _slot_case(cuda, dtype, use_enc, seed=0, particles=600):
    """A 3D slot graph and seeded K8 inputs on the card."""
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    nl = neighbor_list(None, [1.0] * 3, 0.15, format="slot").allocate(
        torch.as_tensor(rng.uniform(0, 1, size=(particles, 3))))
    cand, bases = nl.idx.to(cuda), nl.aux["bases"].to(cuda)
    n, k = cand.shape
    f = fused_mp.LATENT
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


@pytest.mark.parametrize("particles", [600, 37, 5000])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_fused_mp_slot_kernel(cuda, dtype, tol, use_enc, particles):
    """K8 vs its plain version: max |kernel - plain| within K3's limits,
    1e-4 (float32) and 0.125 (bf16), on slot graphs of 37 to 5,000
    particles."""
    args = _slot_case(cuda, dtype, use_enc, particles=particles)
    handle = fused_mp.FUSED_MP_SLOT_ENC if use_enc else fused_mp.FUSED_MP_SLOT
    before = handle.launches
    got = fused_mp.gns_mp_step_slot(*args)
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


def _window_case(cuda, dtype, seed=0, particles=1000):
    """A reduced windowed structure in 3D and seeded E2 inputs on the card."""
    from lagrangebench_torch.experiments import window_select

    n_rows, n_ext, ext_idx, cand, w0s, _, wsub = window_select.build_structure(
        particles, 3, 24, 1.45 * 0.1, seed=seed)
    g = torch.Generator().manual_seed(seed)
    f = fused_mp.LATENT
    p = fused_mp.kernel_params(window_select.init_step_params(f, g), dtype)
    p = {name: v.to(cuda) for name, v in p.items()}
    e = torch.randn(n_rows, 24, f, generator=g).to(dtype).to(cuda)
    hr, h, hs = (torch.randn(n_rows, f, generator=g).to(dtype).to(cuda) for _ in range(3))
    hs_ext = hs[torch.as_tensor(ext_idx, device=cuda)]
    return (e, torch.as_tensor(cand, device=cuda), torch.as_tensor(w0s, device=cuda), wsub,
            hs_ext, hr, h, p)


@pytest.mark.parametrize("particles", [1000, 200])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
def test_fused_mp_window_kernel(cuda, dtype, tol, particles):
    """E2 vs its plain version: max |kernel - plain| within K3's limits,
    1e-4 (float32) and 0.125 (bf16); and E2 equal to K3 on the decoded,
    masked gather (the same arithmetic row for row)."""
    args = _window_case(cuda, dtype, particles=particles)
    e, cand, w0s, wsub, hs_ext, hr, h, p = args
    before = fused_mp.FUSED_MP_WINDOW.launches
    got = fused_mp.gns_mp_step_window(*args)
    assert fused_mp.FUSED_MP_WINDOW.launches == before + 1
    want = fused_mp.gns_mp_step_window_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol
    rows, mask = fused_mp.window_sender_rows(cand, w0s, wsub)
    hs_g = torch.where(mask[..., None], hs_ext[rows], 0).to(dtype).contiguous()
    k3 = fused_mp.gns_mp_step(e, hs_g, hr, h, mask.to(torch.float32), p)
    for a, b in zip(got, k3):
        assert torch.equal(a, b)
