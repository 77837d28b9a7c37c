"""Model building blocks: Flax-equivalent Dense, LayerNorm and MLP.

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


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Flax's lecun_normal: truncated normal in (-2, 2) std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` with the numerics of ``flax.linen.Dense(dtype=cdt)``."""

    def __init__(self, in_features: int, out_features: int, generator=None):
        super().__init__(in_features, out_features)
        gen = generator if generator is not None else torch.Generator()
        lecun_normal_(self.weight, in_features, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, cdt: Optional[torch.dtype] = None) -> torch.Tensor:
        cdt = cdt or x.dtype
        y = matmul(x.to(cdt), self.weight.to(cdt).t())
        return y + self.bias.to(cdt)


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

    def load_flax(self, tree: Dict) -> None:
        """Copy a Flax MLP subtree ({"Dense_i": {kernel, bias}, "LayerNorm_0"})."""
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                d = tree[f"Dense_{i}"]
                layer.weight.copy_(torch.as_tensor(d["kernel"]).t())
                layer.bias.copy_(torch.as_tensor(d["bias"]))
            if self.norm is not None:
                self.norm.scale.copy_(torch.as_tensor(tree["LayerNorm_0"]["scale"]))
                self.norm.bias.copy_(torch.as_tensor(tree["LayerNorm_0"]["bias"]))

    def flax_tree(self) -> Dict:
        """This MLP's parameters as a Flax subtree of numpy arrays."""
        tree = {
            f"Dense_{i}": {
                "kernel": layer.weight.detach().t().cpu().numpy(),
                "bias": layer.bias.detach().cpu().numpy(),
            }
            for i, layer in enumerate(self.layers)
        }
        if self.norm is not None:
            tree["LayerNorm_0"] = {
                "scale": self.norm.scale.detach().cpu().numpy(),
                "bias": self.norm.bias.detach().cpu().numpy(),
            }
        return tree
