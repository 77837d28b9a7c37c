"""Parametrized tensor product and gated nonlinearity.

Counterpart of ``lagrangebench_tpu/models/e3/tensor.py``, on the stacked
``(..., 2l+1, mul)`` chunks of ``IrrepsArray``. The product is

    out_k[p, w] = alpha_k sum_{paths (i, j)} sum_{m, n, u}
                  C[m, n, p] x_i[m, u] y_j[n] W_kij[u, w]  (+ b_k on 0e)

and both contractions are linear, so the port takes the weights first:

* one GEMM per x irrep: the x groups of that irrep side by side (the
  message's sender, receiver and edge vectors are one (..., 3, 65) chunk
  in SEGNN-10-64) times the weights of every path type (x irrep, y group)
  and output group that reads them, z = x @ W, in ``compute_dtype``;
* per path type, the Clebsch-Gordan contraction of z with the attributes
  y: a scale where y is a scalar (C(l, 0, l) is diagonal), a broadcast
  product where x is a scalar, else 2l+1 broadcast multiply-adds of the
  small per-row matrix M[p, m] = sum_n C[m, n, p] y[n]; an einsum for the
  general ``mul_y > 1`` case; summed over the path types of each output
  irrep, each product added in the kernel that makes it (``addcmul``).

The JAX package contracts C first (per-m FMAs on (E, mul) parts, which
keep the TPU's (8, 128) tiles full) and multiplies the weights last; both
orders give the same function. On the card the weights-first order
writes about half the bytes: z is narrower than the concatenated path
tensor (``experiments/e3_layout.py`` times the three orders). The output
is rounded to float32 as JAX's ``preferred_element_type=float32`` rounds
its dot (a float64 compute dtype computes in float64 and rounds there).
The scale by 1/sqrt(fan-in) is folded into the weights, except for a
float64 compute dtype: there it and the bias add follow the rounding, in
float64, as in the JAX package under x64 (whose NumPy-scalar scale
promotes the float32 dot). bf16 casts x and the weights (JAX casts the CG
products) and runs its GEMMs on the tensor cores with float32 accumulation
and output.

Normalization follows the "element" scheme: every output group divides by
sqrt(fan-in), where fan-in counts mul_x * mul_y over its paths (+1 for the
bias); biases on 0e outputs only; unreachable outputs are float32 zeros;
weights are standard normal, biases zero (the Flax initializers). The
parameters keep the JAX names and shapes: ``w_{k_out}_{i}_{j}`` (mul_x *
mul_y, mul_out) and ``b_{k_out}`` (mul_out,).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import silu
from .basis import clebsch_gordan
from .irreps import Irrep, Irreps, IrrepsArray, MulIrrep

_SCALAR = Irrep(0, 1)


def _enumerate_paths(irreps_x: Irreps, irreps_y: Irreps, ir_out: Irrep) -> List[Tuple[int, int]]:
    """Indices of (x-group, y-group) pairs that can reach ir_out."""
    paths = []
    for i, gx in enumerate(irreps_x):
        for j, gy in enumerate(irreps_y):
            if ir_out in gx.ir * gy.ir:
                paths.append((i, j))
    return paths


class _Bfloat16Dot(torch.autograd.Function):
    """a @ w of bf16 operands with float32 accumulation and a float32
    result: one tensor-core GEMM on CUDA (``torch.mm``'s ``out_dtype``,
    which has no derivative of its own), the same products in float32 on
    the CPU. The gradients are XLA's for JAX's bf16 dot: float32 dots of
    the float32 cotangent and the other operand, rounded to bf16."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        if a.is_cuda:
            return torch.mm(a, w, out_dtype=torch.float32)
        return a.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        ga = (g @ w.float().t()).to(a.dtype) if ctx.needs_input_grad[0] else None
        gw = (a.float().t() @ g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return ga, gw


def _dot(a: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """a (..., K) @ w (K, M) in ``cdt``; bf16 returns float32."""
    a2, w2 = a.to(cdt).reshape(-1, a.shape[-1]), w.to(cdt)
    o = _Bfloat16Dot.apply(a2, w2) if cdt == torch.bfloat16 else a2 @ w2
    return o.reshape(tuple(a.shape[:-1]) + (w.shape[-1],))


class O3TensorProduct(nn.Module):
    """Linear parametrized tensor product x (x)_CG^W y -> output_irreps.

    With ``irreps_y=None`` (and y=None at call time) it is an equivariant
    linear layer (y = scalar 1). ``compute_dtype`` is the dtype of the
    weight contraction ("float32", "bfloat16" or "float64"); parameters
    are float32.
    """

    def __init__(self, irreps_x, irreps_y, output_irreps, biases: bool = True,
                 compute_dtype: str = "float32", generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        ix = self.irreps_x = Irreps(irreps_x)
        iy = self.irreps_y = Irreps("1x0e") if irreps_y is None else Irreps(irreps_y)
        self.output_irreps = Irreps(output_irreps)
        self.compute_dtype = getattr(torch, compute_dtype)
        self.scale_dtype = torch.promote_types(self.compute_dtype, torch.float32)
        # 1/sqrt(fan-in) scales the weights, except in float64, where it
        # follows the rounding to float32 as in JAX
        self.fold_alpha = self.compute_dtype != torch.float64
        # x groups by irrep, in order of first appearance
        self.x_by_ir: Dict[Irrep, List[int]] = {}
        for i, g in enumerate(ix):
            self.x_by_ir.setdefault(g.ir, []).append(i)
        self.weights = nn.ParameterDict()
        # per distinct output irrep: the output groups (k, alpha, bias) that
        # share its path types
        self.outputs: Dict[Irrep, List[Tuple[int, float, bool]]] = {}
        for k, g_out in enumerate(self.output_irreps):
            paths = _enumerate_paths(ix, iy, g_out.ir)
            use_bias = biases and g_out.ir == _SCALAR
            fan_in = sum(ix[i].mul * iy[j].mul for i, j in paths) + int(use_bias)
            if fan_in == 0:
                continue  # unreachable output: zeros
            for i, j in paths:
                shape = (ix[i].mul * iy[j].mul, g_out.mul)
                self.weights[f"w_{k}_{i}_{j}"] = nn.Parameter(torch.randn(shape, generator=gen))
            if use_bias:
                self.weights[f"b_{k}"] = nn.Parameter(torch.zeros(g_out.mul))
            self.outputs.setdefault(g_out.ir, []).append((k, 1.0 / np.sqrt(fan_in), use_bias))
        # path types (x irrep, y group j, output irrep) with their CG
        # tensors, grouped by x irrep: the columns of that irrep's GEMM
        self.types: Dict[Irrep, List[Tuple[int, Irrep, np.ndarray]]] = {
            ir: [(j, ir_out, clebsch_gordan(ir.l, gy.ir.l, ir_out.l))
                 for ir_out in self.outputs for j, gy in enumerate(iy) if ir_out in ir * gy.ir]
            for ir in self.x_by_ir}
        self._consts: Dict = {}

    def _const(self, key, make, dtype, device) -> torch.Tensor:
        """A CG-derived constant as a tensor of ``dtype`` on ``device``."""
        key = key + (dtype, device)
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(np.array(make()), dtype=dtype, device=device)
        return self._consts[key]

    def _weights(self, ir: Irrep) -> torch.Tensor:
        """The GEMM weights of x irrep ``ir``: rows the channels of its x
        groups, columns per path type the output groups of its irrep (for
        ``mul_y > 1``: (mul_x, mul_y * columns), y channel major)."""
        cols = []
        for j, ir_out, _ in self.types[ir]:
            mul_y = self.irreps_y[j].mul
            w = torch.cat([torch.cat([self.weights[f"w_{k}_{i}_{j}"].unflatten(0, (-1, mul_y))
                                      for i in self.x_by_ir[ir]], dim=0)
                           * (alpha if self.fold_alpha else 1.0)
                           for k, alpha, _ in self.outputs[ir_out]], dim=-1)
            cols.append(w.flatten(1))
        return torch.cat(cols, dim=-1)

    def _contract(self, key, z: torch.Tensor, yc: torch.Tensor, cg: np.ndarray,
                  acc: Optional[torch.Tensor]) -> torch.Tensor:
        """``acc`` (None: zeros) plus one path type's (..., d3, columns)
        contribution from its GEMM output z (..., d1, [mul_y *] columns) and
        the y chunk; each product term is added in the same kernel
        (``torch.addcmul``)."""
        d1, d2, d3 = cg.shape
        rt = torch.promote_types(z.dtype, yc.dtype)
        z, yc = z.to(rt), yc.to(rt)

        def fma(acc, a, b):
            return a * b if acc is None else torch.addcmul(acc, a, b)

        if yc.shape[-1] > 1:  # general y: (..., d1, mul_y, columns)
            c = self._const(key, lambda: cg, rt, z.device)
            out = torch.einsum("...mvw,...nv,mnp->...pw", z.unflatten(-1, (yc.shape[-1], -1)),
                               yc, c)
            return out if acc is None else acc + out
        y = yc[..., 0]  # (..., d2)
        if d2 == 1 and np.allclose(cg[:, 0, :], np.diag(np.diag(cg[:, 0, :])), rtol=0,
                                   atol=1e-12):
            # y scalar: C[m, 0, p] is diagonal, a scale of z
            diag = self._const(key, lambda: np.diag(cg[:, 0, :])[:, None], rt, z.device)
            return fma(acc, z, y[..., None] * diag)
        # M[..., p, m] = sum_n C[m, n, p] y[..., n]; acc + M @ z
        c = self._const(key, lambda: cg.transpose(1, 2, 0).reshape(d2, d3 * d1), rt, z.device)
        m = (y @ c).unflatten(-1, (d3, d1))
        for mm in range(d1):
            acc = fma(acc, m[..., :, mm:mm + 1], z[..., mm:mm + 1, :])
        return acc

    def forward(self, x: IrrepsArray, y: Optional[IrrepsArray] = None) -> IrrepsArray:
        if y is None:
            y = IrrepsArray("1x0e", torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                                               device=x.chunks()[0].device))
        assert x.irreps == self.irreps_x and y.irreps == self.irreps_y, (
            f"built for {self.irreps_x} x {self.irreps_y}, called with {x.irreps} x {y.irreps}")
        xs, ys = x.chunks(), y.chunks()
        sums: Dict[Irrep, torch.Tensor] = {}
        for ir, idx in self.x_by_ir.items():
            if not self.types[ir]:
                continue
            xr = xs[idx[0]] if len(idx) == 1 else torch.cat([xs[i] for i in idx], dim=-1)
            z = _dot(xr, self._weights(ir), self.compute_dtype)
            # split, not sliced: one concatenation in the backward
            widths = [self.irreps_y[j].mul * sum(self.output_irreps[k].mul
                                                 for k, _, _ in self.outputs[ir_out])
                      for j, ir_out, _ in self.types[ir]]
            for (j, ir_out, cg), zt in zip(self.types[ir], z.split(widths, dim=-1)):
                sums[ir_out] = self._contract((ir, j, ir_out), zt, ys[j], cg, sums.get(ir_out))
        out: List[Optional[torch.Tensor]] = [None] * len(self.output_irreps)
        for ir_out, groups in self.outputs.items():
            o = sums[ir_out].to(torch.float32).to(self.scale_dtype)
            parts = o.split([self.output_irreps[k].mul for k, _, _ in groups], dim=-1)
            for (k, alpha, use_bias), ok in zip(groups, parts):
                ok = ok if self.fold_alpha else ok * alpha
                out[k] = ok + self.weights[f"b_{k}"] if use_bias else ok
        lead = x.shape[:-1]
        for k, g in enumerate(self.output_irreps):
            if out[k] is None:
                out[k] = torch.zeros(lead + (g.ir.dim, g.mul), dtype=torch.float32,
                                     device=xs[0].device)
        return IrrepsArray.from_chunks(self.output_irreps, out)

    def named_leaves(self, prefix: str):
        """(JAX path, parameter, transposed) of every weight and bias."""
        return [(f"{prefix}/{name}", p, False) for name, p in self.weights.items()]


def gate(z: IrrepsArray, n_gates: int, scalar_activation: Callable = silu,
         gate_activation: Callable = torch.sigmoid) -> IrrepsArray:
    """Gated nonlinearity (Weiler et al. 2018).

    Layout convention: the FIRST group of `z` holds the `n_gates` gating
    scalars (one per non-scalar irrep channel, in group order); remaining
    scalar groups pass through `scalar_activation`; each non-scalar channel
    is multiplied by its activated gate.
    """
    chunks = z.chunks()
    first = z.irreps[0]
    assert first.ir == _SCALAR and first.mul == n_gates, (
        f"first group must hold the {n_gates} gates, got {first}")
    muls = [g.mul for g in z.irreps[1:] if g.ir.l > 0]
    assert sum(muls) == n_gates, f"gate count mismatch: {sum(muls)} channels, {n_gates} gates"
    gates = iter(gate_activation(chunks[0]).split(muls, dim=-1))  # (..., 1, mul) each
    out = [scalar_activation(c) if g.ir.l == 0 else c * next(gates)
           for g, c in zip(z.irreps[1:], chunks[1:])]
    return IrrepsArray.from_chunks(Irreps(z.irreps[1:]), out)


class O3TensorProductGate(nn.Module):
    """Gated tensor product: TP to (gates + output), then gate."""

    def __init__(self, irreps_x, irreps_y, output_irreps, biases: bool = True,
                 scalar_activation: Callable = silu, gate_activation: Callable = torch.sigmoid,
                 compute_dtype: str = "float32", generator: Optional[torch.Generator] = None):
        super().__init__()
        output_irreps = Irreps(output_irreps)
        self.n_gates = sum(g.mul for g in output_irreps if g.ir.l > 0)
        self.scalar_activation, self.gate_activation = scalar_activation, gate_activation
        tp_irreps = output_irreps if self.n_gates == 0 else \
            Irreps([MulIrrep(self.n_gates, _SCALAR)]) + output_irreps
        self.tp = O3TensorProduct(irreps_x, irreps_y, tp_irreps, biases=biases,
                                  compute_dtype=compute_dtype, generator=generator)

    def forward(self, x: IrrepsArray, y: Optional[IrrepsArray] = None) -> IrrepsArray:
        z = self.tp(x, y)
        if self.n_gates == 0:  # all-scalar output: plain activation
            return z.map_chunks(self.scalar_activation)
        return gate(z, self.n_gates, self.scalar_activation, self.gate_activation)

    def named_leaves(self, prefix: str):
        return self.tp.named_leaves(f"{prefix}/O3TensorProduct_0")
