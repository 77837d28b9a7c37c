"""``experiments/k4_ties.py`` on the CPU at small sizes: its seeded inputs
are the K4 GPU tests' own, its float64 references agree with the plain
version, and its tie reference leaves a tie-free case alone."""

import pytest
import torch

from lagrangebench_torch.experiments import k4_ties
from lagrangebench_torch.ops import fused_mp
from tests.test_torch_cuda_kernels import _bwd_case

CPU = torch.device("cpu")


def _rel(x, y):
    return float((x.double() - y.double()).abs().max()) / float(y.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inputs_are_the_gpu_tests_case(dtype):
    """The seeded step equals ``_bwd_case``'s (no encoder), bit for bit."""
    got = k4_ties.inputs(CPU, dtype, n=20, k=6, f=100)
    t, p, _ = _bwd_case(CPU, dtype, False, n=20, k=6, f=100)
    want = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], fused_mp.kernel_params(p, dtype),
            t["ge"], t["gh"])
    for a, b in zip(got, want):
        if isinstance(a, dict):
            assert all(torch.equal(a[name], b[name]) for name in b)
        else:
            assert torch.equal(a, b)


def test_float64_references_agree_with_the_plain_version():
    """``plain64`` on float32 inputs is the plain version on float64 ones
    but for its float32 roundings (1e-6), fed the float64 agg's own
    rounding it is itself in bf16 (exactly), and ``relu_preactivations``'
    agg on float64 inputs is the plain step's (1e-12)."""
    args = k4_ties.inputs(CPU, torch.float32, n=30, k=8, f=64)
    a64 = [t.double() for t in args[:5]] + [{k: v.double() for k, v in args[5].items()}]
    want = fused_mp.gns_mp_step_bwd_plain(*a64, *[t.double() for t in args[6:]])
    got = k4_ties.plain64(args)
    assert max(_rel(got[4][n], want[4][n]) for n in fused_mp.BWD_PARAM_ORDER) <= 1e-6
    b = k4_ties.inputs(CPU, torch.bfloat16, n=30, k=8, f=64)
    agg = k4_ties.relu_preactivations(b)[2]
    fed, own = k4_ties.plain64(b, aggc=agg), k4_ties.plain64(b)
    assert all(torch.equal(fed[4][n], own[4][n]) for n in fused_mp.BWD_PARAM_ORDER)
    e, hs, hr, h, mask, p = a64[:6]
    first = e @ p["w_e"] + hs + hr[:, None] + p["b1"]
    x1 = torch.relu(first) @ p["w2"] + p["b2"]
    m = fused_mp._layernorm(x1, p["ln1_scale"], p["ln1_bias"])
    assert _rel(k4_ties.relu_preactivations(a64)[2], (m * mask[..., None]).sum(1)) <= 1e-12


def test_relu_tie_reference_keeps_a_tie_free_case():
    """With the plain version's own float32 outputs as the "kernel" the tie
    reference flips nothing and sits within float32 noise of them."""
    args = k4_ties.inputs(CPU, torch.float32, n=40, k=8, f=64)
    got = fused_mp.gns_mp_step_bwd_plain(*args)
    ref, _, flips = k4_ties.relu_tie_reference(args, got)
    assert flips == []
    assert max(_rel(x, y) for x, y in zip(got[:4], ref[:4])) <= 1e-5
    assert max(_rel(got[4][n], ref[4][n]) for n in fused_mp.BWD_PARAM_ORDER) <= 1e-5


def test_main_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        k4_ties.main(["--device", "cpu"])
