"""Wrappers of the neighbor-search kernels K1 (binning) and K2 (scan).

Counterpart of ``lagrangebench_tpu/ops/neighbors_pallas.py`` (dense format).
Each wrapper launches its CUDA kernel (``csrc/binning.cu``,
``csrc/neighbor_scan.cu``) for CUDA tensors and runs the plain PyTorch
version beside it for CPU tensors; there is no other fallback. The plain
versions compute the same function with the same float32 rounding, so the
two agree exactly.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from .build import Kernel, ptr, stream

BINNING = Kernel(
    "binning", "binning", "lbt_binning",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    replaces="lagrangebench_tpu/ops/neighbors_pallas.py:333",
)
NEIGHBOR_SCAN = Kernel(
    "neighbor_scan", "neighbor_scan", "lbt_neighbor_scan",
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
       ctypes.c_void_p],
    replaces="lagrangebench_tpu/ops/neighbors_pallas.py:65",
)

#: shared memory one scan block may use for its stencil stage: all S
#: columns when they fit, else as many whole columns as fit
SCAN_SMEM_TARGET = 96 * 1024
#: the card's per-block limit (H100: 227 KB)
SCAN_SMEM_MAX = 227 * 1024
_BIN_TILE = 256


def scan_smem_bytes(cap: int, dim: int, chunk: int) -> int:
    """Shared memory of one scan block (the sum csrc/neighbor_scan.cu uses)."""
    return (dim * chunk * cap + chunk * cap + cap) * 4


def scan_chunk(cap: int, dim: int, n_steps: int) -> int:
    """Stencil columns staged at once; 0 when even one does not fit."""
    if scan_smem_bytes(cap, dim, 1) > SCAN_SMEM_MAX:
        return 0
    for chunk in range(n_steps, 0, -1):
        if scan_smem_bytes(cap, dim, chunk) <= SCAN_SMEM_TARGET:
            return chunk
    return 1


# ---------------------------------------------------------------------------
# K1: binning
# ---------------------------------------------------------------------------


def binning_plain(cid: torch.Tensor, num_cells: int, cap: int):
    """Stable rank of each id among earlier equal ids -> (slots, max_occ).

    ``cid`` (m,) int32 in [0, num_cells]; ``num_cells`` marks "not binned".
    slot = cid*cap + rank, or num_cells*cap past capacity / when not binned.
    max_occ (1,) int32 is the largest count of any id below num_cells.
    """
    cid = cid.long()
    valid = (cid >= 0) & (cid < num_cells)
    key = torch.where(valid, cid, torch.full_like(cid, num_cells))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=num_cells + 1)
    starts = torch.cumsum(counts, 0) - counts
    ks = key[order]
    rank = torch.empty_like(cid)
    rank[order] = torch.arange(cid.numel(), device=cid.device) - starts[ks]
    sentinel = num_cells * cap
    slots = torch.where(valid & (rank < cap), key * cap + rank, sentinel)
    max_occ = counts[:num_cells].max().reshape(1) if num_cells else counts[:1] * 0
    return slots.to(torch.int32), max_occ.to(torch.int32)


def binning(cid: torch.Tensor, num_cells: int, cap: int):
    """K1. See :func:`binning_plain` for the function computed."""
    if cid.dtype != torch.int32 or cid.dim() != 1 or not cid.is_contiguous():
        raise ValueError("binning: cid must be a contiguous 1-D int32 tensor")
    if not cid.is_cuda:
        return binning_plain(cid, num_cells, cap)
    m = cid.numel()
    n_tiles = -(-m // _BIN_TILE)
    slots = torch.empty(m, dtype=torch.int32, device=cid.device)
    tile_counts = torch.zeros(n_tiles * num_cells, dtype=torch.int32, device=cid.device)
    max_occ = torch.zeros(1, dtype=torch.int32, device=cid.device)
    BINNING(ptr(cid), m, num_cells, cap, ptr(slots), ptr(tile_counts),
            ptr(max_occ), stream())
    return slots, max_occ


# ---------------------------------------------------------------------------
# K2: neighbor scan
# ---------------------------------------------------------------------------


def _scan_consts(cutoff: float, box: Sequence[float]):
    """float32 constants exactly as the TPU kernel rounds them."""
    cutoff2 = float(np.float32(float(cutoff) ** 2))
    box32 = [float(np.float32(b)) for b in box]
    inv32 = [float(np.float32(1.0 / float(b))) for b in box]
    return cutoff2, box32, inv32


def neighbor_scan_plain(
    pos: torch.Tensor,
    idx: torch.Tensor,
    bases: torch.Tensor,
    *,
    n_cols: int,
    k_cap: int,
    n: int,
    cutoff: float,
    box: Sequence[float],
    pbc: Sequence[bool],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed senders per receiver column -> (out (Q, C, K), row_max (Q,)).

    pos (B*(n_cols+1), C, dim) float32, idx (B*(n_cols+1), C) int32,
    bases (B*n_cols, S) int32 flat table rows per stencil step; Q = B*n_cols.
    """
    rows, cap, dim = pos.shape
    bsz = rows // (n_cols + 1)
    q = bsz * n_cols
    s = bases.shape[1]
    cutoff2, box32, inv32 = _scan_consts(cutoff, box)
    recv = pos.view(bsz, n_cols + 1, cap, dim)[:, :n_cols].reshape(q, cap, dim)
    flat = bases.reshape(-1).long()
    cand = pos[flat].view(q, s * cap, dim)
    cand_idx = idx[flat].view(q, s * cap)

    dist2 = None
    for d in range(dim):
        diff = recv[:, :, None, d] - cand[:, None, :, d]  # (Q, C, S*C)
        if pbc[d]:
            diff = diff - box32[d] * torch.floor(diff * inv32[d] + 0.5)
        sq = diff * diff
        dist2 = sq if dist2 is None else dist2 + sq
    recv_valid = recv[:, :, 0] < 1e8  # (Q, C)
    mask = (dist2 <= cutoff2) & (cand_idx < n)[:, None, :] & recv_valid[..., None]
    slot = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    counts = mask.sum(-1)
    keep = mask & (slot < k_cap)

    out = torch.full((q, cap, k_cap + 1), n, dtype=torch.int32, device=pos.device)
    src = cand_idx[:, None, :].expand(q, cap, s * cap)
    out.scatter_(2, torch.where(keep, slot, k_cap).long(), src.to(torch.int32))
    out = out[..., :k_cap].contiguous()
    row_max = counts.max(dim=1).values.to(torch.int32)
    return out, row_max


def neighbor_scan(
    pos: torch.Tensor,
    idx: torch.Tensor,
    bases: torch.Tensor,
    *,
    n_cols: int,
    k_cap: int,
    n: int,
    cutoff: float,
    box: Sequence[float],
    pbc: Sequence[bool],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2. See :func:`neighbor_scan_plain` for the function computed."""
    if pos.dtype != torch.float32 or pos.dim() != 3 or not pos.is_contiguous():
        raise ValueError("neighbor_scan: pos must be contiguous float32 (rows, C, dim)")
    rows, cap, dim = pos.shape
    if idx.shape != (rows, cap) or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("neighbor_scan: idx must be contiguous int32 (rows, C)")
    if rows % (n_cols + 1) or bases.dtype != torch.int32 or not bases.is_contiguous():
        raise ValueError("neighbor_scan: bad bases or table row count")
    if bases.shape[0] != rows // (n_cols + 1) * n_cols:
        raise ValueError("neighbor_scan: bases must have B*n_cols rows")
    kw = dict(n_cols=n_cols, k_cap=k_cap, n=n, cutoff=cutoff, box=box, pbc=pbc)
    if not pos.is_cuda:
        return neighbor_scan_plain(pos, idx, bases, **kw)
    if not (idx.is_cuda and bases.is_cuda):
        raise ValueError("neighbor_scan: all inputs must be on one CUDA device")
    s = bases.shape[1]
    chunk = scan_chunk(cap, dim, s)
    if chunk == 0:
        raise ValueError(
            f"neighbor_scan: column capacity {cap} exceeds one block's shared memory"
        )
    q = bases.shape[0]
    out = torch.empty((q, cap, k_cap), dtype=torch.int32, device=pos.device)
    row_max = torch.empty(q, dtype=torch.int32, device=pos.device)
    cutoff2, box32, inv32 = _scan_consts(cutoff, box)
    box_c = (ctypes.c_float * dim)(*box32)
    inv_c = (ctypes.c_float * dim)(*inv32)
    pbc_c = (ctypes.c_int32 * dim)(*[int(bool(p)) for p in pbc])
    NEIGHBOR_SCAN(
        ptr(pos), ptr(idx), ptr(bases), ptr(out), ptr(row_max),
        q, n_cols, cap, s, dim, k_cap, n, chunk, cutoff2,
        ctypes.cast(box_c, ctypes.c_void_p), ctypes.cast(inv_c, ctypes.c_void_p),
        ctypes.cast(pbc_c, ctypes.c_void_p), stream(),
    )
    return out, row_max
