"""Fused GNS message-passing step (K3), dense (N, K) layout.

Counterpart of ``lagrangebench_tpu/ops/fused_mp.py`` (forward). One call
computes, per receiver,

    first    = e @ W_e + hs_gath + hr_proj (broadcast over K) + b1
    messages = LayerNorm(relu(first) @ W2 + b2)
    e'       = e + messages
    agg      = sum_K messages * mask
    h'       = h + LayerNorm(relu(h @ W_nh + agg @ W_na + bn1) @ W_n2 + bn2)

and on the first step (``enc``) the edge encoder
``e = LayerNorm(relu(raw @ enc_w1 + enc_b1) @ enc_w2 + enc_b2)`` runs
first, on the raw (N, K, dim+1) edge features. The sender projection
``hs_gath = hs_proj[senders]`` is gathered outside, as in the JAX model.

``gns_mp_step`` launches the CUDA kernel (``csrc/fused_mp.cu``) for CUDA
tensors and runs ``gns_mp_step_plain`` for CPU tensors. The plain version
keeps the kernel's casts: products of compute-dtype operands accumulate in
float32 (float64 when the compute dtype is float64), relu(first) and agg
are cast to the compute dtype before their products, LayerNorm runs in the
accumulation dtype with eps 1e-5.

Weights are (in, out) matrices, as in the JAX parameter tree.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .build import Kernel, stream

PARAM_NAMES = (
    "w_s", "w_r",  # node-level sender/receiver projections (applied outside)
    "w_e", "b1", "w2", "b2", "ln1_scale", "ln1_bias",
    "w_nh", "w_na", "bn1", "wn2", "bn2", "ln2_scale", "ln2_bias",
)
ENC_PARAM_NAMES = (
    "enc_w1", "enc_b1", "enc_w2", "enc_b2", "enc_ln_scale", "enc_ln_bias",
)
_KERNEL_WEIGHTS = ("w_e", "w2", "w_nh", "w_na", "wn2")
_KERNEL_VECTORS = ("b1", "b2", "ln1_scale", "ln1_bias", "bn1", "bn2",
                   "ln2_scale", "ln2_bias")
LATENT = 128  # the kernel's compiled width

_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
FUSED_MP = Kernel(
    "fused_mp", "fused_mp", "lbt_fused_mp", _ARGTYPES,
    replaces="lagrangebench_tpu/ops/fused_mp.py:177",
)
FUSED_MP_ENC = Kernel(
    "fused_mp_enc", "fused_mp", "lbt_fused_mp", _ARGTYPES,
    replaces="lagrangebench_tpu/ops/fused_mp.py:177",
)


def _acc_dtype(cdt: torch.dtype) -> torch.dtype:
    return torch.float64 if cdt == torch.float64 else torch.float32


def _layernorm(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale.to(x.dtype) + bias.to(x.dtype)


def _dot(a: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """a @ w with operands rounded to ``cdt`` and the sum in float32/64."""
    acc = _acc_dtype(cdt)
    return a.to(cdt).to(acc) @ w.to(cdt).to(acc)


def encode_edges_plain(raw: torch.Tensor, enc: Dict[str, torch.Tensor],
                       cdt: torch.dtype) -> torch.Tensor:
    """Edge-encoder MLP on raw edge features: LN(relu(raw@W1+b1)@W2+b2)."""
    acc = _acc_dtype(cdt)
    x = _dot(raw, enc["enc_w1"], cdt) + enc["enc_b1"].to(acc)
    x = torch.relu(x)
    x = _dot(x, enc["enc_w2"], cdt) + enc["enc_b2"].to(acc)
    return _layernorm(x, enc["enc_ln_scale"], enc["enc_ln_bias"]).to(cdt)


def gns_mp_step_plain(
    e: torch.Tensor,
    hs_gath: torch.Tensor,
    hr_proj: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    p: Dict[str, torch.Tensor],
    enc: Optional[Dict[str, torch.Tensor]] = None,
):
    """Plain PyTorch version of the fused step (same math, same casts).

    e (N, K, F) edge latents, or raw (N, K, Fe) features with ``enc``;
    hs_gath (N, K, F); hr_proj (N, F); h (N, F); mask (N, K).
    Returns (e' (N, K, F), h' (N, F)) in the compute dtype of hs_gath / h.
    """
    cdt = hs_gath.dtype
    acc = _acc_dtype(cdt)
    if enc is not None:
        e = encode_edges_plain(e, enc, cdt)
    e = e.to(cdt)
    first = _dot(e, p["w_e"], cdt) + hs_gath.to(acc)
    first = first + hr_proj.to(acc)[:, None, :] + p["b1"].to(acc)
    x = _dot(torch.relu(first), p["w2"], cdt) + p["b2"].to(acc)
    messages = _layernorm(x, p["ln1_scale"], p["ln1_bias"])
    e_out = (e.to(acc) + messages).to(cdt)

    agg = torch.sum(messages * mask[..., None].to(acc), dim=1)
    node_first = _dot(h, p["w_nh"], cdt) + _dot(agg, p["w_na"], cdt)
    y = _dot(torch.relu(node_first + p["bn1"].to(acc)), p["wn2"], cdt)
    y = y + p["bn2"].to(acc)
    h_out = h.to(acc) + _layernorm(y, p["ln2_scale"], p["ln2_bias"])
    return e_out, h_out.to(h.dtype)


def gns_mp_step(
    e: torch.Tensor,
    hs_gath: torch.Tensor,
    hr_proj: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    p: Dict[str, torch.Tensor],
    enc: Optional[Dict[str, torch.Tensor]] = None,
):
    """K3: the fused step; the CUDA kernel on CUDA tensors, else the plain
    version. See :func:`gns_mp_step_plain` for shapes.

    On CUDA the compute dtype (of hs_gath, hr_proj, h, and e unless
    ``enc``) is bfloat16 or float32, the latent width is 128, weights are
    (in, out) in the compute dtype and vectors float32 (``kernel_params``
    converts a parameter dict once).
    """
    if not hs_gath.is_cuda:
        return gns_mp_step_plain(e, hs_gath, hr_proj, h, mask, p, enc)
    cdt = hs_gath.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_mp kernel: compute dtype {cdt} not supported")
    n, k, f = hs_gath.shape
    if f != LATENT:
        raise ValueError(f"fused_mp kernel: latent width {f} != {LATENT}")
    if hr_proj.shape != (n, f) or h.shape != (n, f) or mask.shape != (n, k):
        raise ValueError("fused_mp kernel: inconsistent shapes")
    if hr_proj.dtype != cdt or h.dtype != cdt:
        raise ValueError("fused_mp kernel: hs_gath, hr_proj and h must share a dtype")
    if enc is None:
        if e.shape != (n, k, f) or e.dtype != cdt:
            raise ValueError("fused_mp kernel: e must be (N, K, F) in the compute dtype")
    elif e.shape[:2] != (n, k) or e.dtype != torch.float32:
        raise ValueError("fused_mp kernel: raw edge features must be (N, K, Fe) float32")
    mask = mask if mask.dtype == torch.float32 else mask.to(torch.float32)
    tensors = [e, hs_gath, hr_proj, h, mask]
    if any(not t.is_cuda or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_mp kernel: inputs must be contiguous CUDA tensors")

    e_out = torch.empty((n, k, f), dtype=cdt, device=h.device)
    h_out = torch.empty_like(h)
    params = [_checked(p[name], cdt, (f, f)) for name in _KERNEL_WEIGHTS]
    params += [_checked(p[name], torch.float32, (f,)) for name in _KERNEL_VECTORS]
    if enc is not None:
        fe = e.shape[-1]
        params += [
            _checked(enc["enc_w1"], cdt, (fe, f)),
            _checked(enc["enc_w2"], cdt, (f, f)),
        ] + [
            _checked(enc[name], torch.float32, (f,))
            for name in ("enc_b1", "enc_b2", "enc_ln_scale", "enc_ln_bias")
        ]
    else:
        fe = 0
    ptrs = [t.data_ptr() for t in tensors + [e_out, h_out] + params]
    ptrs += [0] * (26 - len(ptrs))
    arr = (ctypes.c_void_p * 26)(*ptrs)
    kernel = FUSED_MP_ENC if enc is not None else FUSED_MP
    kernel(ctypes.cast(arr, ctypes.c_void_p), n, k, fe, f,
           int(cdt == torch.bfloat16), int(enc is not None), stream())
    return e_out, h_out


def _checked(t: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"fused_mp kernel: parameter {tuple(t.shape)} {t.dtype}, "
            f"expected contiguous {tuple(shape)} {dtype}"
        )
    if not t.is_cuda:
        raise ValueError("fused_mp kernel: parameters must be CUDA tensors")
    return t


def kernel_params(p: Dict[str, torch.Tensor], cdt: torch.dtype) -> Dict[str, torch.Tensor]:
    """A parameter dict in the layout the kernel takes: matrices in the
    compute dtype, vectors in float32, all contiguous."""
    return {
        name: (v.to(cdt) if v.dim() == 2 else v.to(torch.float32)).detach().contiguous()
        for name, v in p.items()
    }
