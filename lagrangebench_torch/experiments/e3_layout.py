"""The steerable tensor product's layout and contraction order on the
card: the engine's stacked chunks, weights first, against the stacked
chunks with the Clebsch-Gordan contraction first and against the JAX
package's per-m parts.

One gated message product of SEGNN-10-64, the first block of a layer:
x = [sender, receiver, edge] features "32x0e+32x1o+32x0e+32x1o+1x1o+1x0e",
y = the lmax-1 spherical harmonics of the edge vectors, output
"32x0e+32x1o" behind 32 gates, float32, on ``--edges`` edge slots
(default 640,000 = batch 2 x 8,000 particles x 40 slots), from one seeded
weight set:

- stacked: ``models.e3.O3TensorProductGate`` as SEGNN runs it: (..., 2l+1,
  mul) chunks, the x groups of one irrep side by side, one GEMM per x
  irrep (weights first), then the CG contraction of its output with y;
- paths_first: the same chunks in the JAX package's order: per path type
  the CG contraction of x with y into a block (..., 2l+1, channels), the
  blocks of an output irrep concatenated, one GEMM;
- per_m: the JAX package's algorithm on per-m (E, mul) parts: the
  contraction unrolled over the nonzero CG entries as elementwise
  products, channels concatenated over paths, one GEMM per output
  component.

Prints one JSON line per layout: ms per call of the forward and of the
forward and backward (``profiling.call_ms``: device time on the card), and
the largest difference of its output from the stacked layout's; then the
card's ten kernels of longest device time in one call of each.

    python -m lagrangebench_torch.experiments.e3_layout [--edges E] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.e3 import (IrrepsArray, O3TensorProductGate, clebsch_gordan, gate,
                         spherical_harmonics_fn)
from ..models.e3.tensor import _enumerate_paths
from ..models.utils import silu
from ..profiling import call_ms
from ..utils import resolve_device

X_IRREPS = "32x0e+32x1o+32x0e+32x1o+1x1o+1x0e"
Y_IRREPS = "1x0e+1x1o"
OUT_IRREPS = "32x0e+32x1o"


def per_m_forward(tp, x_parts: List[List[torch.Tensor]],
                  y_parts: List[List[torch.Tensor]], n_gates: int) -> List[List[torch.Tensor]]:
    """The gated product on per-m parts (one (E, mul) tensor per group and
    component), with the weights of ``tp`` (an ``O3TensorProduct``)."""
    out = []
    for k, g_out in enumerate(tp.output_irreps):
        paths = _enumerate_paths(tp.irreps_x, tp.irreps_y, g_out.ir)
        use_bias = g_out.ir.l == 0 and g_out.ir.p == 1
        fan_in = sum(tp.irreps_x[i].mul * tp.irreps_y[j].mul for i, j in paths) + int(use_bias)
        per_p: List[List[torch.Tensor]] = [[] for _ in range(g_out.ir.dim)]
        for i, j in paths:
            cg = clebsch_gordan(tp.irreps_x[i].ir.l, tp.irreps_y[j].ir.l, g_out.ir.l)
            for p in range(g_out.ir.dim):
                acc = None
                for m in range(cg.shape[0]):
                    for n in range(cg.shape[1]):
                        c = float(cg[m, n, p])
                        if abs(c) > 1e-12:
                            term = x_parts[i][m] * (c * y_parts[j][n])
                            acc = term if acc is None else acc + term
                per_p[p].append(acc if acc is not None else torch.zeros_like(x_parts[i][0]))
        w = torch.cat([tp.weights[f"w_{k}_{i}_{j}"] for i, j in paths], dim=0)
        group = []
        for p in range(g_out.ir.dim):
            o = (torch.cat(per_p[p], dim=-1) @ w) * (1.0 / np.sqrt(fan_in))
            group.append(o + tp.weights[f"b_{k}"] if use_bias else o)
        out.append(group)
    gates = torch.sigmoid(out[0][0])
    scalars = [silu(out[1][0])]
    vectors = [v * gates for v in out[2]]
    return [scalars, vectors]


def paths_first_forward(tp, x: IrrepsArray, y: IrrepsArray, n_gates: int) -> torch.Tensor:
    """The gated product on stacked chunks, contraction first: per path
    type a block, the blocks of an output irrep concatenated, one GEMM."""
    xs, ys = x.chunks(), y.chunks()
    xr = {ir: torch.cat([xs[i] for i in idx], dim=-1) for ir, idx in tp.x_by_ir.items()}
    chunks = []
    for ir_out, groups in tp.outputs.items():
        blocks, ws = [], []
        for ir, types in tp.types.items():
            for j, o_ir, cg in types:
                if o_ir != ir_out:
                    continue
                d1, d2, d3 = cg.shape
                c = torch.as_tensor(cg.transpose(1, 2, 0).reshape(d2, d3 * d1),
                                    dtype=x.array.dtype, device=x.array.device)
                m = (ys[j][..., 0] @ c).unflatten(-1, (d3, d1))
                block = m[..., :, :1] * xr[ir][..., :1, :]
                for mm in range(1, d1):
                    block = block + m[..., :, mm:mm + 1] * xr[ir][..., mm:mm + 1, :]
                blocks.append(block)
                ws.append(torch.cat([torch.cat([tp.weights[f"w_{k}_{i}_{j}"]
                                                for i in tp.x_by_ir[ir]], dim=0)
                                     for k, _, _ in groups], dim=1))
        o = torch.cat(blocks, dim=-1) @ torch.cat(ws, dim=0)
        start = 0
        for k, alpha, use_bias in groups:
            mul = tp.output_irreps[k].mul
            ok = o[..., start:start + mul] * alpha
            start += mul
            chunks.append(ok + tp.weights[f"b_{k}"] if use_bias else ok)
    return gate(IrrepsArray.from_chunks(tp.output_irreps, chunks), n_gates).array


def _parts(irreps, flat: torch.Tensor) -> List[List[torch.Tensor]]:
    """Per-m parts (contiguous) of an m-major flat array."""
    return [[c[..., m, :].contiguous().requires_grad_(flat.requires_grad)
             for m in range(c.shape[-2])] for c in IrrepsArray(irreps, flat).chunks()]


def _top_kernels(fn, n=10) -> Dict[str, float]:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0)
        if dev > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3, ev.key[:90]))
    return {name: round(ms, 4) for ms, name in sorted(rows, reverse=True)[:n]}


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--edges", type=int, default=2 * 8000 * 40)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv or [])
    device = resolve_device(device or args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    mod = O3TensorProductGate(X_IRREPS, Y_IRREPS, OUT_IRREPS, generator=gen).to(device)
    e = args.edges
    x = torch.randn(e, IrrepsArray(X_IRREPS, torch.zeros(1, 260)).irreps.dim, generator=gen)
    y = spherical_harmonics_fn(1)(torch.randn(e, 3, generator=gen))
    x, y = x.to(device).requires_grad_(), y.to(device)
    x_parts, y_parts = _parts(X_IRREPS, x.detach().requires_grad_()), _parts(Y_IRREPS, y)
    cot = torch.randn(e, 128, generator=gen).to(device)

    def stacked():
        return mod(IrrepsArray(X_IRREPS, x), IrrepsArray(Y_IRREPS, y)).array

    def paths_first():
        return paths_first_forward(mod.tp, IrrepsArray(X_IRREPS, x), IrrepsArray(Y_IRREPS, y),
                                   mod.n_gates)

    def per_m():
        s, v = per_m_forward(mod.tp, x_parts, y_parts, mod.n_gates)
        return torch.cat(s + v, dim=-1)

    results = {}
    want = None
    layouts = (("stacked", stacked), ("paths_first", paths_first), ("per_m", per_m))
    for name, fn in layouts:
        with torch.no_grad():
            out = fn()
            want = out if want is None else want
            fwd = call_ms(fn, device, iters=10)

        def fwd_bwd():
            (fn() * cot).sum().backward()

        both = call_ms(fwd_bwd, device, iters=5)
        results[name] = {"layout": name, "edges": e, "fwd_ms": fwd, "fwd_bwd_ms": both,
                         "max_abs_diff": float((out - want).abs().max()),
                         "device": str(device)}
        print(json.dumps(results[name]), flush=True)
    if device.type == "cuda":
        for name, fn in layouts:
            with torch.no_grad():
                print(json.dumps({f"{name}_top_kernels_ms": _top_kernels(fn)}), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
