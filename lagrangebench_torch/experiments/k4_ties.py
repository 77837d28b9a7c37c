"""K4's relu and rounding ties: where the kernel and its plain version part,
and why, on the seeded inputs of the K4 GPU tests.

    python -m lagrangebench_torch.experiments.k4_ties [--device cuda]
        [--bf16 F:N:K ...] [--float32 F:N:K ...]

Both versions of K4 (``csrc/fused_mp_bwd.cu`` and
``ops.fused_mp.gns_mp_step_bwd_plain``) compute one step's backward with
float32 sums. Where a sum lands within its rounding noise of a point where
the function jumps, each sum order decides the jump its own way:

- bf16 (F = 192, N = 333, K = 24: ``test_fused_mp_bwd_kernel``): agg is
  rounded to bf16 before its product, and an element of agg within float32
  noise of a rounding midpoint rounds to either neighbour; one bf16 ulp of
  a large agg element moves node_first by ~1e-2 and can flip its relu.
  Printed: each weight gradient of the kernel and of the float32 plain
  version against the plain version with its sums in float64, and of the
  kernel against that version fed the kernel's own T(agg) (``agg_out``,
  ``aggc``); the kernel's agg against the float64 sum; the elements of
  T(agg) that round apart; the relu(node_first) flips they cause.
- float32 (F = 100 and 192, N = 16,000, K = 24:
  ``test_fused_mp_bwd_kernel_ragged``): a relu input within float32 noise
  of 0 (``TIE`` of its largest magnitude). Printed: the weight gradients of
  the kernel and of the float32 plain version against the plain version in
  float64, raw and with every tie set as the kernel's outputs show it
  (``relu_tie_reference``), and the ties so set.
- ``--bf16 F:N:K`` and ``--float32 F:N:K`` analyse the GPU tests' seeded
  case of that width and shape instead (``test_fused_mp_bwd_kernel_ragged``
  and its wide-path counterpart take N, K from their ragged lists); a bf16
  F runs padded to its kernel width, a float32 F is a multiple of 64. On
  the wide path (F > 256) the bf16 case also prints where the kernel's own
  relu(node_first) decisions, handed out with ``relu_out``, part from
  float64 at its T(agg), and feeds them to the float64 reference.

Prints one JSON object. Needs a card (K4 has no CPU mode).
"""

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from ..ops import fused_mp
from ..utils import resolve_device

TIE = 1e-6  # a relu input within this share of its largest magnitude is a tie


def inputs(device, dtype, n=333, k=24, f=128, seed=1):
    """The K4 GPU tests' seeded step (``_bwd_case`` without the encoder):
    (e, hs, hr, h, mask, p, ge, gh), ``p`` in the kernel's layout."""
    g = torch.Generator().manual_seed(seed)
    p = {name: (torch.randn(f, f, generator=g) / f**0.5 if name.startswith("w")
                else 0.1 * torch.randn(f, generator=g) + (1.0 if "scale" in name else 0.0))
         for name in fused_mp.PARAM_NAMES}
    torch.randn(4, f, generator=g)  # the tests' encoder draws, kept for the same stream
    torch.randn(f, f, generator=g)
    t = {"e": torch.randn(n, k, f, generator=g).to(dtype)}
    for name, shape in (("hs", (n, k, f)), ("hr", (n, f)), ("h", (n, f)), ("ge", (n, k, f)),
                        ("gh", (n, f))):
        t[name] = torch.randn(*shape, generator=g).to(dtype)
    t["mask"] = (torch.rand(n, k, generator=g) < 0.7).to(torch.float32)
    t = {name: v.to(device) for name, v in t.items()}
    kp = {name: v.to(device) for name, v in fused_mp.kernel_params(p, dtype).items()}
    return (t["e"], t["hs"], t["hr"], t["h"], t["mask"], kp, t["ge"], t["gh"])


def relu_preactivations(args, aggc=None):
    """(first, node_first) of K4's inputs in float64 with the plain
    version's roundings to the compute dtype (relu(first) and agg; ``aggc``
    the rounded agg to use instead), and the float64 agg."""
    e, hs, hr, h, mask, p = args[:6]
    cdt, d = e.dtype, torch.float64
    p = {name: v.to(d) for name, v in p.items()}

    def c(x):
        return x.to(cdt).to(d)

    first = c(e) @ c(p["w_e"]) + hs.to(d) + hr.to(d)[:, None] + p["b1"]
    x1 = c(torch.relu(first)) @ c(p["w2"]) + p["b2"]
    xhat = (x1 - x1.mean(-1, keepdim=True)) * torch.rsqrt(
        x1.var(-1, unbiased=False, keepdim=True) + 1e-5)
    agg = ((xhat * p["ln1_scale"] + p["ln1_bias"]) * mask.to(d)[..., None]).sum(1)
    aggc = c(agg) if aggc is None else c(aggc)
    node_first = c(h) @ c(p["w_nh"]) + aggc @ c(p["w_na"]) + p["bn1"]
    return first, node_first, agg


def plain64(args, **kw):
    """The plain version with every sum in float64 and the roundings of the
    inputs' compute dtype (float64 inputs: the float64 function)."""
    real = fused_mp._acc_dtype
    fused_mp._acc_dtype = lambda cdt: torch.float64
    try:
        return fused_mp.gns_mp_step_bwd_plain(*args, **kw)
    finally:
        fused_mp._acc_dtype = real


def relu_tie_reference(args, got, tie=TIE):
    """The plain version in float64 on float32 inputs ``args`` with each
    relu tie (an input within ``tie`` of its largest magnitude) set as the
    kernel's outputs ``got`` show it: an edge tie (first) from its dhs (=
    dfirst, 0 where the relu is off); a receiver's node_first ties by the
    flip of one or all of them, or none, whose float64 outputs of that
    receiver alone match the kernel's de, dhs, dhr and dh best (they depend
    on no other receiver). Returns (outputs and gradients as the plain
    version returns them, the count of edge ties, the node flips as
    (receiver, feature, float64 node_first))."""
    a64 = [t.double() for t in args[:5]]
    g64 = [t.double() for t in args[6:8]]
    p64 = {name: v.double() for name, v in args[5].items()}
    first, nf, _ = relu_preactivations(args)
    edge_ties = first.abs() <= tie * first.abs().max()
    edge_on = torch.where(edge_ties, got[1] != 0, first > 0)
    del first
    node_on = nf > 0
    ties = torch.nonzero(nf.abs() <= tie * nf.abs().max()).tolist()
    tops = [float(x.abs().max()) for x in got[:4]]
    flips = []
    for i in sorted({i for i, _ in ties}):
        sub, gsub = [t[i:i + 1] for t in a64], [t[i:i + 1] for t in g64]

        def out_err(on):
            outs = fused_mp.gns_mp_step_bwd_plain(*sub, p64, *gsub,
                                                  relu_masks=(edge_on[i:i + 1], on[None]))
            return max(float((x[i].double() - y[0]).abs().max()) / top
                       for x, y, top in zip(got[:4], outs[:4], tops))

        feats = [j for r, j in ties if r == i]
        best, best_err, chosen = node_on[i], out_err(node_on[i]), []
        for flip in [[j] for j in feats] + ([feats] if len(feats) > 1 else []):
            on = node_on[i].clone()
            on[flip] = ~on[flip]
            err = out_err(on)
            if err < best_err:
                best, best_err, chosen = on, err, flip
        node_on[i] = best
        flips += [(i, j, float(nf[i, j])) for j in chosen]
    ref = fused_mp.gns_mp_step_bwd_plain(*a64, p64, *g64, relu_masks=(edge_on, node_on))
    return ref, int(edge_ties.sum()), flips


def _rel(x, y):
    return float((x.double() - y.double()).abs().max()) / max(float(y.double().abs().max()),
                                                             1e-30)


def _grads(got, want):
    return {name: float(f"{_rel(got[4][name], want[4][name]):.3g}")
            for name in fused_mp.BWD_PARAM_ORDER}


def bf16_case(device, f=192, n=333, k=24):
    """The bf16 case at F = ``f``, N = ``n``, K = ``k`` (see the module
    docstring); ``f`` need not be an instance width (the tensors are padded
    to ``kernel_width(f)`` for the launch and cut back)."""
    args = inputs(device, torch.bfloat16, n=n, k=k, f=f)
    n, width = args[0].shape[0], fused_mp.kernel_width(f)
    wide = width > fused_mp.INSTANCES[-1]  # the wide path (either wide design)
    agg_k = torch.empty((n, width), dtype=torch.float32, device=device)
    relu_k = torch.empty((n, width), dtype=torch.bfloat16, device=device) if wide else None
    padded = [t if i in (4, 5) else fused_mp.pad_last(t, width).contiguous()
              for i, t in enumerate(args)]
    got = fused_mp.gns_mp_step_bwd(*padded, latent=f, agg_out=agg_k, relu_out=relu_k)
    del padded
    got = tuple(o[..., :f] for o in got[:4]) + (
        {name: v[(slice(0, f),) * v.dim()] for name, v in got[4].items()},)
    agg_k = agg_k[:, :f].contiguous()
    plain = fused_mp.gns_mp_step_bwd_plain(*args)
    _, nf_exact, agg = relu_preactivations(args)
    _, nf_kernel, _ = relu_preactivations(args, aggc=agg_k)
    masks = None if relu_k is None else (None, relu_k[:, :f] > 0)
    exact, fed = plain64(args), plain64(args, aggc=agg_k, relu_masks=masks)
    apart = agg_k.to(torch.bfloat16) != agg.to(torch.bfloat16)
    flips = torch.nonzero((nf_kernel > 0) != (nf_exact > 0)).tolist()
    out = {
        "kernel vs float64 sums": _grads(got, exact),
        "float32 plain vs float64 sums": _grads(plain, exact),
        "kernel vs float64 sums fed the kernel's T(agg)"
        + (" and relu(node_first)" if wide else ""): _grads(got, fed),
        "kernel's agg vs float64 sum, max abs": float((agg_k.double() - agg).abs().max()),
        "T(agg) elements rounded apart (kernel vs float64)": int(apart.sum()),
        "of": apart.numel(),
        "relu(node_first) flips from them (receiver, feature, float64, kernel's T(agg))": [
            (i, j, float(f"{float(nf_exact[i, j]):.4g}"), float(f"{float(nf_kernel[i, j]):.4g}"))
            for i, j in flips],
        "kernel's agg vs float64 sum at those receivers, max abs": [
            float(f"{float((agg_k[i].double() - agg[i]).abs().max()):.3g}") for i, _ in flips],
    }
    if wide:  # the kernel's own relu(node_first) decisions at its T(agg)
        own = torch.nonzero(masks[1] != (nf_kernel > 0)).tolist()
        out["wide path: the kernel's relu(node_first) apart from float64 at its T(agg) "
            "(receiver, feature, float64 node_first, its largest)"] = [
            (i, j, float(f"{float(nf_kernel[i, j]):.4g}"),
             float(f"{float(nf_kernel.abs().max()):.4g}")) for i, j in own]
    return out


def f32_case(device, f, n=16000, k=24):
    """The float32 case at F = ``f``, N = ``n``, K = ``k`` (see the module
    docstring)."""
    args = inputs(device, torch.float32, n=n, k=k, f=f)
    got = fused_mp.at_true_width("gns_mp_step_bwd", *args, latent=f)
    plain = fused_mp.gns_mp_step_bwd_plain(*args)
    raw = fused_mp.gns_mp_step_bwd_plain(*[t.double() for t in args[:5]],
                                         {k: v.double() for k, v in args[5].items()},
                                         *[t.double() for t in args[6:]])
    ref, edge_ties, flips = relu_tie_reference(args, got)
    edge_off = int(((got[1] != 0) != (raw[1] != 0)).sum())
    plain_off = int(((plain[1] != 0) != (raw[1] != 0)).sum())
    return {
        "kernel vs float64": _grads(got, raw),
        "float32 plain vs float64": _grads(plain, raw),
        "kernel vs float64 with the ties set as the kernel set them": _grads(got, ref),
        "kernel outputs vs that, max rel": float(
            f"{max(_rel(x, y) for x, y in zip(got[:4], ref[:4])):.3g}"),
        "relu(first) ties": edge_ties,
        "relu(first) set apart from float64: kernel, float32 plain": [edge_off, plain_off],
        "relu(node_first) flips of the kernel (receiver, feature, float64)": flips,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default); K4 has no CPU mode")
    ap.add_argument("--bf16", nargs="*", default=None, metavar="F:N:K",
                    help="bf16 cases to analyse (default 192:333:24)")
    ap.add_argument("--float32", nargs="*", default=None, metavar="F:N:K",
                    help="float32 cases to analyse (default 100:16000:24 192:16000:24)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("k4_ties needs a CUDA device: K4 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": torch.cuda.get_device_name(0)}
    given = args.bf16 is not None or args.float32 is not None
    for spec in args.bf16 or ([] if given else ["192:333:24"]):
        f, n, k = (int(x) for x in spec.split(":"))
        out[f"bf16 F = {f}" + (f", N = {n}, K = {k}" if given else "")] = bf16_case(
            device, f, n, k)
        torch.cuda.empty_cache()
    for spec in args.float32 or ([] if given else ["100:16000:24", "192:16000:24"]):
        f, n, k = (int(x) for x in spec.split(":"))
        out[f"float32 F = {f}" + (f", N = {n}, K = {k}" if given else "")] = f32_case(
            device, f, n, k)
        torch.cuda.empty_cache()
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
