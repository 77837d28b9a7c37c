"""Wrappers of the neighbor-search kernels: K1 (binning) and the column-stencil
scan with its three payloads, K2 (sender ids), K9 (sender ids and the edge
geometry) and K7 (the slot-space graph).

Counterpart of ``lagrangebench_tpu/ops/neighbors_pallas.py``. Each wrapper
launches its CUDA kernel (``csrc/binning.cu``, ``csrc/neighbor_scan.cu``)
for CUDA tensors and runs the plain PyTorch version beside it for CPU
tensors; there is no other fallback. The plain versions compute the same
function with the same float32 rounding, so the two agree exactly.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .build import Kernel, ptr

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
_EMIT_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 4
)
NEIGHBOR_SCAN_GEOMETRY = Kernel(
    "neighbor_scan_geometry", "neighbor_scan", "lbt_neighbor_scan_emit", _EMIT_ARGTYPES,
    replaces="lagrangebench_tpu/ops/neighbors_pallas.py:65",
)
SLOT_SCAN = Kernel(
    "slot_scan", "neighbor_scan", "lbt_neighbor_scan_emit", _EMIT_ARGTYPES,
    replaces="lagrangebench_tpu/ops/neighbors_pallas.py:65",
)
_EMIT_GEOMETRY, _EMIT_SLOT = 1, 2  # the kernel's Emit values

#: shared memory one scan block may use for its stencil stage: all S
#: columns when they fit (9 columns of up to 330 slots in 3D), else as many
#: whole columns as fit; four 512-thread blocks of this size share an SM
SCAN_SMEM_TARGET = 48 * 1024
#: the card's per-block limit (H100: 227 KB)
SCAN_SMEM_MAX = 227 * 1024
_BIN_TILE = 256


def scan_smem_bytes(cap: int, chunk: int) -> int:
    """Shared memory of one scan block (the sum csrc/neighbor_scan.cu uses):
    a 16-byte record per staged candidate, a count per receiver and per
    staged stencil column."""
    return 16 * chunk * cap + 4 * cap + 4 * chunk


def scan_chunk(cap: int, n_steps: int) -> int:
    """Stencil columns staged at once; 0 when even one does not fit."""
    if scan_smem_bytes(cap, 1) > SCAN_SMEM_MAX:
        return 0
    for chunk in range(n_steps, 0, -1):
        if scan_smem_bytes(cap, chunk) <= SCAN_SMEM_TARGET:
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
            ptr(max_occ), device=cid.device)
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
    hits = _scan_hits(pos, idx, bases, n_cols, n, cutoff, box, pbc)
    out = _pack(hits, hits.cand_idx[:, None, :], k_cap, n)
    return out, hits.row_max


class _Hits(NamedTuple):
    """Every (receiver, candidate) pair of the stencils, in candidate order."""

    diffs: list  # dim x (Q, C, S*C) min-imaged receiver - candidate
    dist2: torch.Tensor  # (Q, C, S*C)
    cand_idx: torch.Tensor  # (Q, S*C) candidate particle ids
    slot: torch.Tensor  # (Q, C, S*C) output slot of each hit, K where dropped
    row_max: torch.Tensor  # (Q,) int32 largest row count of the column


def _scan_hits(pos, idx, bases, n_cols, n, cutoff, box, pbc) -> _Hits:
    """The distance tests of the scan, with the kernels' float32 rounding,
    and the packed slot of each hit (K where it is dropped)."""
    rows, cap, dim = pos.shape
    bsz = rows // (n_cols + 1)
    q = bsz * n_cols
    s = bases.shape[1]
    cutoff2, box32, inv32 = _scan_consts(cutoff, box)
    recv = pos.view(bsz, n_cols + 1, cap, dim)[:, :n_cols].reshape(q, cap, dim)
    flat = bases.reshape(-1).long()
    cand = pos[flat].view(q, s * cap, dim)
    cand_idx = idx[flat].view(q, s * cap)

    dist2, diffs = None, []
    for d in range(dim):
        diff = recv[:, :, None, d] - cand[:, None, :, d]  # (Q, C, S*C)
        if pbc[d]:
            diff = diff - box32[d] * torch.floor(diff * inv32[d] + 0.5)
        diffs.append(diff)
        sq = diff * diff
        dist2 = sq if dist2 is None else dist2 + sq
    recv_valid = recv[:, :, 0] < 1e8  # (Q, C)
    mask = (dist2 <= cutoff2) & (cand_idx < n)[:, None, :] & recv_valid[..., None]
    return _Hits(diffs, dist2, cand_idx, _slots(mask), mask.sum(-1).max(dim=1).values.to(torch.int32))


def _slots(mask: torch.Tensor) -> torch.Tensor:
    """Rank of each hit among its row's hits, in candidate order; -1 for a
    pair that is not a hit."""
    return torch.where(mask, torch.cumsum(mask.to(torch.int32), dim=-1) - 1, -1)


def _pack(hits: _Hits, payload: torch.Tensor, k_cap: int, fill) -> torch.Tensor:
    """(Q, C, K) of ``payload`` (broadcast to (Q, C, S*C)) at each hit's
    slot, ``fill`` elsewhere; a trailing axis of ``payload`` is kept."""
    slot = hits.slot
    dest = torch.where((slot >= 0) & (slot < k_cap), slot, k_cap).long()
    extra = tuple(payload.shape[3:])
    q, cap, cw = slot.shape
    src = payload.expand((q, cap, cw) + extra)
    out = torch.full((q, cap, k_cap + 1) + extra, fill, dtype=payload.dtype, device=slot.device)
    index = dest.view(dest.shape + (1,) * len(extra)).expand(src.shape)
    out.scatter_(2, index, src)
    return out[:, :, :k_cap].contiguous()


def _geometry(hits: _Hits, cutoff: float) -> torch.Tensor:
    """(Q, C, S*C, dim+1) cutoff-normalized [rel_disp, rel_dist] of every
    pair, rounded as the kernels round them."""
    inv = _inv_cutoff(cutoff)
    planes = [d * inv for d in hits.diffs] + [torch.sqrt(hits.dist2) * inv]
    return torch.stack(planes, dim=-1)


def _inv_cutoff(cutoff: float) -> float:
    """1/cutoff as the TPU kernel takes it (from the double cutoff**2), in
    float32."""
    return float(np.float32(1.0 / (float(cutoff) ** 2) ** 0.5))


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
    _check_scan("neighbor_scan", pos, idx, bases, n_cols)
    kw = dict(n_cols=n_cols, k_cap=k_cap, n=n, cutoff=cutoff, box=box, pbc=pbc)
    if not pos.is_cuda:
        return neighbor_scan_plain(pos, idx, bases, **kw)
    chunk, consts = _launch_consts("neighbor_scan", pos, idx, bases, cutoff, box, pbc)
    q, (_, cap, dim), s = bases.shape[0], pos.shape, bases.shape[1]
    out = torch.empty((q, cap, k_cap), dtype=torch.int32, device=pos.device)
    row_max = torch.zeros(q, dtype=torch.int32, device=pos.device)
    cutoff2, box_c, inv_c, pbc_c = consts
    NEIGHBOR_SCAN(
        ptr(pos), ptr(idx), ptr(bases), ptr(out), ptr(row_max),
        q, n_cols, cap, s, dim, k_cap, n, chunk, cutoff2, box_c, inv_c, pbc_c,
        device=pos.device,
    )
    return out, row_max


def _check_scan(name, pos, idx, bases, n_cols, single=False) -> None:
    """Raise on inputs a scan kernel does not take."""
    if pos.dtype != torch.float32 or pos.dim() != 3 or not pos.is_contiguous():
        raise ValueError(f"{name}: pos must be contiguous float32 (rows, C, dim)")
    rows, cap, _ = pos.shape
    if idx.shape != (rows, cap) or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous int32 (rows, C)")
    if rows % (n_cols + 1) or bases.dtype != torch.int32 or not bases.is_contiguous():
        raise ValueError(f"{name}: bad bases or table row count")
    if bases.shape[0] != rows // (n_cols + 1) * n_cols:
        raise ValueError(f"{name}: bases must have B*n_cols rows")
    if single and rows != n_cols + 1:
        raise ValueError(f"{name}: one sample's column table (n_cols + 1 rows) expected")


def _launch_consts(name, pos, idx, bases, cutoff, box, pbc):
    """(chunk, (cutoff2, box, 1/box, pbc as C arguments)) of a CUDA launch."""
    if not (idx.is_cuda and bases.is_cuda):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    _, cap, dim = pos.shape
    chunk = scan_chunk(cap, bases.shape[1])
    if chunk == 0:
        raise ValueError(f"{name}: column capacity {cap} exceeds one block's shared memory")
    cutoff2, box32, inv32 = _scan_consts(cutoff, box)
    arrays = [(ctypes.c_float * dim)(*box32), (ctypes.c_float * dim)(*inv32),
              (ctypes.c_int32 * dim)(*[int(bool(p)) for p in pbc])]
    # the arrays stay alive through the call: ctypes.cast keeps a reference
    return chunk, (cutoff2, *[ctypes.cast(a, ctypes.c_void_p) for a in arrays])


# ---------------------------------------------------------------------------
# K9: neighbor scan with the edge geometry
# ---------------------------------------------------------------------------


def neighbor_scan_geometry_plain(pos, idx, bases, *, n_cols, k_cap, n, cutoff, box, pbc):
    """K2 plus the geometry -> (out (Q, C, K), geom (Q, C, K*(dim+1)),
    row_max (Q,)).

    ``geom`` interleaves, per slot, the cutoff-normalized min-imaged
    receiver - sender displacement (dim values) and its norm, zeros in
    unfilled slots: the layout of ``concat(rel_disp, rel_dist)``.
    """
    hits = _scan_hits(pos, idx, bases, n_cols, n, cutoff, box, pbc)
    out = _pack(hits, hits.cand_idx[:, None, :], k_cap, n)
    geom = _pack(hits, _geometry(hits, cutoff), k_cap, 0.0)
    return out, geom.flatten(2), hits.row_max


def neighbor_scan_geometry(pos, idx, bases, *, n_cols, k_cap, n, cutoff, box, pbc):
    """K9. See :func:`neighbor_scan_geometry_plain` for the function computed."""
    _check_scan("neighbor_scan_geometry", pos, idx, bases, n_cols)
    kw = dict(n_cols=n_cols, k_cap=k_cap, n=n, cutoff=cutoff, box=box, pbc=pbc)
    if not pos.is_cuda:
        return neighbor_scan_geometry_plain(pos, idx, bases, **kw)
    chunk, consts = _launch_consts("neighbor_scan_geometry", pos, idx, bases, cutoff, box, pbc)
    q, (_, cap, dim), s = bases.shape[0], pos.shape, bases.shape[1]
    out = torch.empty((q, cap, k_cap), dtype=torch.int32, device=pos.device)
    geom = torch.empty((q, cap, k_cap * (dim + 1)), dtype=torch.float32, device=pos.device)
    row_max = torch.zeros(q, dtype=torch.int32, device=pos.device)
    cutoff2, box_c, inv_c, pbc_c = consts
    NEIGHBOR_SCAN_GEOMETRY(
        _EMIT_GEOMETRY, ptr(pos), ptr(idx), ptr(bases), ptr(out), ptr(row_max), ptr(geom),
        None, q, n_cols, cap, s, dim, k_cap, n, chunk, cutoff2, _inv_cutoff(cutoff),
        box_c, inv_c, pbc_c, device=pos.device,
    )
    return out, geom, row_max


# ---------------------------------------------------------------------------
# K7: slot-space scan
# ---------------------------------------------------------------------------


def slot_scan_plain(pos, idx, bases, *, n_cols, k_cap, n, cutoff, box, pbc):
    """The slot-space graph of one sample, in column-slot order.

    pos (n_cols+1, C, dim) float32 and idx (n_cols+1, C) int32: one column
    table with its sentinel column last; bases (n_cols, S) int32. Returns

    * cand (n_ext, K) int32: the stencil-candidate index j*C + c of each
      hit (stencil step j, rank c in that column), fill S*C;
    * rel_disp (n_ext, K, dim) and rel_dist (n_ext, K, 1) float32: the
      cutoff-normalized receiver - sender geometry, zeros in unfilled slots;
    * row_max (n_cols,) int32,

    with n_ext = (n_cols+1)*C: the sentinel column's C rows are appended
    (fill, zero geometry). The sender of row r's candidate c sits in slot
    ``bases[r // C, c // C] * C + c % C``.
    """
    cap, dim = pos.shape[1], pos.shape[2]
    cw = bases.shape[1] * cap
    hits = _scan_hits(pos, idx, bases, n_cols, n, cutoff, box, pbc)
    payload = torch.arange(cw, dtype=torch.int32, device=pos.device)[None, None, :]
    cand = _pack(hits, payload, k_cap, cw).view(n_cols * cap, k_cap)
    geom = _pack(hits, _geometry(hits, cutoff), k_cap, 0.0).view(n_cols * cap, k_cap, dim + 1)
    cand = torch.cat([cand, cand.new_full((cap, k_cap), cw)])
    geom = torch.cat([geom, geom.new_zeros((cap, k_cap, dim + 1))])
    return cand, geom[..., :dim].contiguous(), geom[..., dim:].contiguous(), hits.row_max


def slot_scan(pos, idx, bases, *, n_cols, k_cap, n, cutoff, box, pbc):
    """K7. See :func:`slot_scan_plain` for the function computed."""
    _check_scan("slot_scan", pos, idx, bases, n_cols, single=True)
    kw = dict(n_cols=n_cols, k_cap=k_cap, n=n, cutoff=cutoff, box=box, pbc=pbc)
    if not pos.is_cuda:
        return slot_scan_plain(pos, idx, bases, **kw)
    chunk, consts = _launch_consts("slot_scan", pos, idx, bases, cutoff, box, pbc)
    (_, cap, dim), s = pos.shape, bases.shape[1]
    n_ext = (n_cols + 1) * cap
    cand = torch.empty((n_ext, k_cap), dtype=torch.int32, device=pos.device)
    rel_disp = torch.empty((n_ext, k_cap, dim), dtype=torch.float32, device=pos.device)
    rel_dist = torch.empty((n_ext, k_cap, 1), dtype=torch.float32, device=pos.device)
    row_max = torch.zeros(n_cols + 1, dtype=torch.int32, device=pos.device)
    cutoff2, box_c, inv_c, pbc_c = consts
    SLOT_SCAN(
        _EMIT_SLOT, ptr(pos), ptr(idx), ptr(bases), ptr(cand), ptr(row_max), ptr(rel_disp),
        ptr(rel_dist), n_cols + 1, n_cols, cap, s, dim, k_cap, n, chunk, cutoff2,
        _inv_cutoff(cutoff), box_c, inv_c, pbc_c, device=pos.device,
    )
    return cand, rel_disp, rel_dist, row_max[:n_cols]
