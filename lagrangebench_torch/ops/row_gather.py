"""Row gather ``out = h[idx]`` (E1), the probe of the sender gather.

Counterpart of the seven Pallas kernels of
``scripts/experiments/gather_variants.py``. They compute one function in
the TPU's different tilings: ``jnp.take`` of whole rows (``:69``), one
index column at a time (``:107``), ``take_along_axis`` (``:159``), a grid
over K (``:229``), from the transposed ``(K, R)`` index (``:291``), a flat
``(N,)`` index (``:353``), and the sum of repeated gathers (``:375``). The
port computes that function with one kernel (``csrc/row_gather.cu``):

    out[r, k] = sum_{j < reps} h[idx[r, k]]    (reps = 1: the gather itself)

with ``idx`` of shape (R,), (R, K), or (K, R) when ``transposed``; the
output is (R, F) or (R, K, F) in the dtype of ``h``. For ``reps > 1`` the
sum runs in float32 in j order and is rounded once, as the probe's float32
loop adds.

``row_gather`` launches the kernel for CUDA tensors and runs
``row_gather_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .build import Kernel

ROW_GATHER = Kernel(
    "row_gather", "row_gather", "lbt_row_gather",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="scripts/experiments/gather_variants.py:69",
)


def row_gather_plain(h: torch.Tensor, idx: torch.Tensor, *, transposed: bool = False,
                     reps: int = 1) -> torch.Tensor:
    """Plain PyTorch version of E1 (see the module docstring)."""
    if transposed:
        idx = idx.t()
    rows = h[idx.long()]
    if reps == 1:
        return rows
    acc = torch.zeros(rows.shape, dtype=torch.float32, device=h.device)
    rows = rows.float()
    for _ in range(reps):
        acc += rows
    return acc.to(h.dtype)


def row_gather(h: torch.Tensor, idx: torch.Tensor, *, transposed: bool = False,
               reps: int = 1) -> torch.Tensor:
    """E1: the kernel on CUDA tensors, else the plain version.

    On CUDA, ``h`` (N, F) is bfloat16 or float32 with rows a multiple of 16
    bytes, ``idx`` int32 with every index in [0, N) (the kernel does not
    check: a check would cost a device-to-host sync), both contiguous.
    """
    if not h.is_cuda:
        return row_gather_plain(h, idx, transposed=transposed, reps=reps)
    if h.dtype not in (torch.bfloat16, torch.float32) or h.dim() != 2:
        raise ValueError(f"row_gather kernel: h must be (N, F) bf16 or float32, got "
                         f"{tuple(h.shape)} {h.dtype}")
    n, f = h.shape
    if (f * h.element_size()) % 16:
        raise ValueError(f"row_gather kernel: rows of {f * h.element_size()} bytes are not "
                         "a multiple of 16")
    if idx.dtype != torch.int32 or idx.dim() not in (1, 2) or (transposed and idx.dim() != 2):
        raise ValueError("row_gather kernel: idx must be int32, (R,), (R, K) or (K, R) "
                         "when transposed")
    if reps < 1:
        raise ValueError(f"row_gather kernel: reps must be >= 1, got {reps}")
    if not idx.is_cuda or not h.is_contiguous() or not idx.is_contiguous():
        raise ValueError("row_gather kernel: inputs must be contiguous CUDA tensors")
    if idx.dim() == 1:
        r, k = idx.shape[0], 1
        shape = (r, f)
    else:
        k, r = idx.shape if transposed else (idx.shape[1], idx.shape[0])
        shape = (r, k, f)
    out = torch.empty(shape, dtype=h.dtype, device=h.device)
    ROW_GATHER(ctypes.c_void_p(h.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
               ctypes.c_void_p(out.data_ptr()), n, r, k, f, int(transposed), reps,
               int(h.dtype == torch.bfloat16), device=h.device)
    return out
