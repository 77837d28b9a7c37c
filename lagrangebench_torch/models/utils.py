"""Model building blocks: Flax-equivalent Dense, LinearXav, LayerNorm, MLP,
MLPXav, the leaves of their JAX parameter trees, and the 2D-to-3D lift of
the features (SEGNN).

The JAX models run ``flax.linen.Dense(dtype=cdt)`` and
``LayerNorm(dtype=cdt)`` with float32 parameters. The modules here keep the
parameters in float32 and reproduce those numerics at call time:

* Dense casts input, weight and bias to the compute dtype, multiplies with
  float32 accumulation (float64 in float64) and adds the bias in the
  compute dtype;
* LayerNorm takes its statistics in at least float32 with Flax's fast
  variance ``E[x^2] - E[x]^2`` (clipped at 0) and eps 1e-5, and returns the
  compute dtype.

``nn.Linear`` stores (out, in) weights; the Flax kernels are (in, out), and
``models.gns`` transposes them when it carries weights across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in a's dtype with float32 accumulation for 16-bit types.

    On CUDA the bf16 product runs as one bf16 GEMM (float32 accumulation in
    the library); on the CPU it is taken in float32 and rounded once.
    """
    if a.dtype in (torch.bfloat16, torch.float16) and not a.is_cuda:
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b


class _GatherRows(torch.autograd.Function):
    """``src[idx]`` whose backward sums the row gradients in float32 with
    ``index_add_`` and rounds once to ``src``'s dtype (the default backward,
    an ``index_put_`` accumulating in the compute dtype, is orders of
    magnitude slower on CUDA for bf16 rows with many repeats)."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = src.shape, src.dtype
        return src[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        acc = torch.promote_types(ctx.dtype, torch.float32)
        out = torch.zeros(ctx.shape, dtype=acc, device=grad.device)
        out.index_add_(0, idx.reshape(-1), grad.reshape(-1, ctx.shape[-1]).to(acc))
        return out.to(ctx.dtype), None


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``src[idx]`` of a (N, F) tensor for an integer index array;
    differentiable in ``src`` (see ``_GatherRows``)."""
    return _GatherRows.apply(src, idx)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's lecun_normal: truncated normal in (-2, 2) std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` with the numerics of ``flax.linen.Dense(dtype=cdt)``
    (lecun-normal weights, zero bias)."""

    def __init__(self, in_features: int, out_features: int, generator=None,
                 use_bias: bool = True):
        super().__init__(in_features, out_features, bias=use_bias)
        gen = generator if generator is not None else torch.Generator()
        self.init_weight(gen)
        if use_bias:
            with torch.no_grad():
                self.bias.zero_()

    def init_weight(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, generator)

    def forward(self, x: torch.Tensor, cdt: Optional[torch.dtype] = None) -> torch.Tensor:
        cdt = cdt or x.dtype
        y = matmul(x.to(cdt), self.weight.to(cdt).t())
        return y if self.bias is None else y + self.bias.to(cdt)


class LinearXav(Dense):
    """The JAX package's ``LinearXav``: a Dense layer with Flax's
    ``xavier_uniform`` weights (uniform in +-sqrt(6 / (fan_in + fan_out)))."""

    def init_weight(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight, generator=generator)


def silu(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


class MLPXav(nn.Module):
    """The JAX package's ``MLPXav``: ``LinearXav`` layers of
    ``output_sizes`` with SiLU between them (and after the last one with
    ``activate_final``)."""

    def __init__(self, in_size: int, output_sizes, activate_final: bool = False,
                 generator=None):
        super().__init__()
        sizes = [in_size] + list(output_sizes)
        self.layers = nn.ModuleList(
            LinearXav(sizes[i], sizes[i + 1], generator=generator)
            for i in range(len(output_sizes))
        )
        self.activate_final = activate_final

    def forward(self, x: torch.Tensor, cdt: Optional[torch.dtype] = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, cdt)
            if i < len(self.layers) - 1 or self.activate_final:
                x = silu(x)
        return x


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(epsilon=1e-5, dtype=cdt)`` numerics."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, cdt: Optional[torch.dtype] = None) -> torch.Tensor:
        cdt = cdt or x.dtype
        stat = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(stat)
        mean = xs.mean(dim=-1, keepdim=True)
        var = torch.clamp((xs * xs).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.to(stat)
        return ((xs - mean) * mul + self.bias.to(stat)).to(cdt)


class MLP(nn.Module):
    """ReLU MLP of ``num_hidden_layers`` Dense layers (the last one to
    ``output_size``), optionally LayerNorm-terminated; the JAX package's
    ``MLP`` with its Flax numerics."""

    def __init__(self, in_size: int, latent_size: int, output_size: int,
                 num_hidden_layers: int = 2, layer_norm: bool = True,
                 generator=None):
        super().__init__()
        widths = [latent_size] * (num_hidden_layers - 1) + [output_size]
        sizes = [in_size] + widths
        self.layers = nn.ModuleList(
            Dense(sizes[i], sizes[i + 1], generator=generator)
            for i in range(len(widths))
        )
        self.norm = LayerNorm(output_size) if layer_norm else None

    def forward(self, x: torch.Tensor, cdt: Optional[torch.dtype] = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, cdt)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        if self.norm is not None:
            x = self.norm(x, cdt)
        return x


def dense_leaves(prefix: str, layer: Dense):
    """(JAX path, parameter, transposed) of a Dense layer's kernel and bias."""
    out = [(f"{prefix}/kernel", layer.weight, True)]
    if layer.bias is not None:
        out.append((f"{prefix}/bias", layer.bias, False))
    return out


def mlp_leaves(prefix: str, mlp: nn.Module):
    """The leaves of an ``MLP`` or ``MLPXav``: Dense_0, Dense_1, ... and
    the LayerNorm an ``MLP`` ends with."""
    out = []
    for i, layer in enumerate(mlp.layers):
        out += dense_leaves(f"{prefix}/Dense_{i}", layer)
    if getattr(mlp, "norm", None) is not None:
        out += [(f"{prefix}/LayerNorm_0/scale", mlp.norm.scale, False),
                (f"{prefix}/LayerNorm_0/bias", mlp.norm.bias, False)]
    return out


def features_2d_to_3d(features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Lift 2D vector features to 3D by zero-padding the z component:
    ``vel_hist`` (N, n_vels * 2), ``rel_disp`` (N, K, 2), ``force`` (N, 2)
    and ``bound`` (N, 2 * 2), which becomes two 3-vectors (N, 6)."""

    def pad(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x.new_zeros(tuple(x.shape[:-1]) + (1,))], dim=-1)

    out = dict(features)
    n = features["vel_hist"].shape[0]
    out["vel_hist"] = pad(features["vel_hist"].reshape(n, -1, 2)).reshape(n, -1)
    out["rel_disp"] = pad(features["rel_disp"])
    if "force" in features:
        out["force"] = pad(features["force"])
    if "bound" in features:
        out["bound"] = pad(features["bound"].reshape(n, 2, 2)).reshape(n, 6)
    return out
