"""CUDA kernels K1-K4 against their plain versions, on the card.

Marked ``gpu``: they skip where ``torch.cuda.is_available()`` is false and
run on a machine with a card (``python -m pytest --noconftest -m gpu
tests/test_torch_cuda_kernels.py``; the root conftest imports JAX). float32
comparisons run with TF32 off.
"""

import numpy as np
import pytest
import torch

from lagrangebench_torch.ops import fused_mp, neighbors_cuda
from lagrangebench_torch.ops.neighbors import neighbor_list

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
    rng = np.random.default_rng(cap)
    cid = torch.as_tensor(rng.integers(0, 51, size=3000).astype(np.int32), device=cuda)
    got = neighbors_cuda.binning(cid, 50, cap)
    want = neighbors_cuda.binning_plain(cid, 50, cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.125)])
@pytest.mark.parametrize("use_enc", [False, True])
def test_fused_mp_kernel(cuda, dtype, tol, use_enc):
    """max |kernel - plain| within 1e-4 (float32) or 0.125 (bf16: outputs of
    a few units, where one bf16 ulp is 1/64..1/32)."""
    g = torch.Generator().manual_seed(0)
    n, k, f = 333, 24, fused_mp.LATENT
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
    got = fused_mp.gns_mp_step(e, hs, hr, h, mask, p, enc)
    want = fused_mp.gns_mp_step_plain(e, hs, hr, h, mask, p, enc)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= tol


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
