"""Fixed-capacity radius-graph neighbor search: the dense ``(N, K)`` and
sparse ``(2, E)`` formats, with or without in-kernel edge geometry, and the
cell-sorted slot format.

Counterpart of ``lagrangebench_tpu/ops/neighbors.py``. Three backends:

* ``"cuda"``, the kernel backend (the JAX package's Pallas backend; dense
  and slot formats): K1 builds the column table, K2 (K9 with geometry, K7
  for slots) scans each column's stencil;
* ``"celllist"``, the JAX package's cell list in PyTorch ops: particles
  binned into cells of side >= cutoff (a stable sort ranks them in their
  cell), each particle's 3^dim stencil cells read from the cell table;
* ``"allpairs"``, the JAX package's all-pairs search: every (N, N) pair.

``allocate`` sizes the buffers on the host (numpy and the C++ engine in
``native/``) from one sample: dense K is the largest neighbor count times
the capacity multiplier, rounded up to a multiple of 8 on the kernel
backend and of 4 on the others; sparse E is the edge count times the
multiplier rounded up to a multiple of 128; a cell holds the largest cell
occupancy times the multiplier, rounded up to a multiple of 4. On the
kernel backend the column grid is the coarsening of the first dim-1 cell
axes that minimises the scan's work ``n_cols * cap^2`` among those the
scan kernels admit. ``update`` runs the search at that fixed capacity. It
never resizes: it raises ``did_buffer_overflow``, which stays set across
updates until the caller reallocates (``capacity_boost`` scales the
capacities of that reallocation).

Two fallbacks, decided on the host from the sizes as the JAX package
decides them: a box too small for a 3-cell stencil takes ``allpairs`` (the
slot format raises), and an allocation for which the kernel backend finds
no admissible column grid takes ``celllist`` with a warning. The list's
``backend`` says which search an allocation took.

``format="dense"``: rows are receivers; senders fill with N; self-edges are
kept; padded particles (index >= num_particles) are excluded. On the kernel
backend K1 builds the column table in one launch (the columns, ranks and
slots of the particles, the table of ids and positions with its sentinel
columns, the column-overflow flags), K2 scans each column's stencil and
packs K senders per receiver, and torch index ops scatter the rows back to
particle order; a column overflow in any sample of a batch flags every
sample, as in the JAX package's batched edge builder. With
``emit_geometry`` K9 takes K2's place and also emits the cutoff-normalized
edge geometry, scattered back with the senders in one scatter; the list
carries it as ``aux["rel_disp"]`` (N, K, dim) and ``aux["rel_dist"]``
(N, K, 1). The cell list and all-pairs searches pack each row's senders in
candidate order (cell-list stencil order, or particle order).

``format="sparse"`` (the reference's layout; cell list or all-pairs):
``idx`` is ``(2, E)`` int32, row 0 receivers and row 1 senders, in
receiver-major order, fill N. The overflow is ``n_edges > E``; a cell
overflow forces it.

``format="slot"`` (single-sample, kernel backend): K1 bins, then K7 writes
the graph in column-slot order, with no scatter back: ``idx`` is the
(n_ext, K) stencil-candidate matrix, and ``aux`` holds the geometry, the
maps between slots and particles and the stencil table (see
:func:`make_slot_edges_fn`). A batched update takes batch 1 only.

Every search takes a batch of B samples, (B, N, dim) positions, in one
call; the cell list and all-pairs flag each sample on its own.
"""

from __future__ import annotations

import itertools
import math
import warnings
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import neighbors_cuda as nlc
from . import space
from .neighbors_host import available as host_available
from .neighbors_host import build_edges, count_edges


def _round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


@dataclass
class NeighborList:
    """Fixed-capacity neighbor list, dense, sparse or slot format.

    Attributes:
        idx: dense: (N, K) int32 sender matrix, row i holding the neighbors
            of receiver i, fill N. Sparse: (2, E) int32, row 0 receivers
            and row 1 senders, fill N. Slot: (n_ext, K) int32
            stencil-candidate matrix in column-slot order, fill S*C. A
            leading batch axis B for a batch.
        did_buffer_overflow: bool tensor, () or (B,); True once a capacity
            was exceeded (sticky across updates).
        update_fn: the update closure bound to this list's capacities.
        format: "dense", "sparse" or "slot".
        aux: None, or the tensors beside ``idx`` (batched like it): the
            in-kernel geometry of a dense list with ``emit_geometry``; the
            geometry, maps and stencil table of a slot list.
        backend: the search this allocation took: "cuda", "celllist" or
            "allpairs".
    """

    idx: torch.Tensor
    did_buffer_overflow: torch.Tensor
    update_fn: Callable
    format: str = "dense"
    aux: Optional[dict] = None
    backend: str = "cuda"

    def update(self, position: torch.Tensor, num_particles=None) -> "NeighborList":
        """Recompute edges at ``position`` with this list's capacities."""
        return self.update_fn(position, self, num_particles=num_particles)

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]

    def broadcast(self, batch_size: int) -> "NeighborList":
        """This (unbatched) list repeated along a new leading batch axis."""

        def rep(t):
            return t.expand((batch_size,) + tuple(t.shape)).contiguous()

        return replace(
            self,
            idx=rep(self.idx),
            did_buffer_overflow=self.did_buffer_overflow.expand(batch_size).clone(),
            aux=None if self.aux is None else {k: rep(v) for k, v in self.aux.items()},
        )

    def select(self, index: int) -> "NeighborList":
        """One sample of a batched list."""
        return replace(
            self, idx=self.idx[index], did_buffer_overflow=self.did_buffer_overflow[index],
            aux=None if self.aux is None else {k: v[index] for k, v in self.aux.items()},
        )


class NeighborListFns(NamedTuple):
    allocate: Callable
    update: Callable
    allocate_shell: Callable


class ColumnGrid(NamedTuple):
    """The column grid of one allocation (host-side, static)."""

    cols_per_side: Tuple[int, ...]  # the first dim-1 axes
    col_size: Tuple[float, ...]
    n_cols: int
    pbc: Tuple[bool, ...]


def stencil_bases(grid: ColumnGrid) -> np.ndarray:
    """(n_cols, S) column id of stencil step j for receiver column t.

    Periodic axes wrap; a free axis out of range points at the sentinel
    column ``n_cols``. Same table and order as the TPU kernel's.
    """
    cps = grid.cols_per_side
    if len(cps) == 2:
        ncx, ncy = cps
        offs = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
        bases = np.empty((ncx * ncy, len(offs)), dtype=np.int32)
        for t, (ix, iy) in enumerate((ix, iy) for ix in range(ncx) for iy in range(ncy)):
            for j, (dx, dy) in enumerate(offs):
                jx, jy, ok = ix + dx, iy + dy, True
                if grid.pbc[0]:
                    jx %= ncx
                elif not 0 <= jx < ncx:
                    ok = False
                if grid.pbc[1]:
                    jy %= ncy
                elif not 0 <= jy < ncy:
                    ok = False
                bases[t, j] = jx * ncy + jy if ok else ncx * ncy
        return bases
    (ncx,) = cps
    bases = np.empty((ncx, 3), dtype=np.int32)
    for ix in range(ncx):
        for j, dx in enumerate((-1, 0, 1)):
            jx = ix + dx
            if grid.pbc[0]:
                bases[ix, j] = jx % ncx
            else:
                bases[ix, j] = jx if 0 <= jx < ncx else ncx
    return bases


class Grid(NamedTuple):
    """The cell grid of the cell list (host-side, static)."""

    cells_per_side: Tuple[int, ...]
    cell_size: Tuple[float, ...]
    num_cells: int
    offsets: Tuple[Tuple[int, ...], ...]  # the 3^dim stencil
    pbc: Tuple[bool, ...]


def make_grid(box: Sequence[float], cutoff: float, pbc: Sequence[bool]) -> Optional[Grid]:
    """The cell grid, or None where the box is too small for a cell list:
    a periodic axis needs >= 3 cells (else the +-1 stencil wraps onto one
    cell twice), and some axis needs >= 3."""
    box = [float(b) for b in np.asarray(box).reshape(-1)]
    cps = [max(int(math.floor(b / cutoff)), 1) for b in box]
    if any(c < 3 and p for c, p in zip(cps, pbc)) or all(c < 3 for c in cps):
        return None
    return Grid(
        cells_per_side=tuple(cps),
        cell_size=tuple(b / c for b, c in zip(box, cps)),
        num_cells=int(np.prod(cps)),
        offsets=tuple(itertools.product((-1, 0, 1), repeat=len(box))),
        pbc=tuple(bool(p) for p in pbc),
    )


# ---------------------------------------------------------------------------
# the cell-list and all-pairs searches (the JAX package's XLA backends)
# ---------------------------------------------------------------------------


def _cell_coords(position: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Integer cell coordinates, ``floor(position / size)`` in the
    position's dtype, clamped into the grid."""
    size = torch.as_tensor(grid.cell_size, dtype=position.dtype, device=position.device)
    top = torch.as_tensor(grid.cells_per_side, device=position.device) - 1
    coords = torch.floor(position / size).long()
    return torch.minimum(torch.clamp(coords, min=0), top)


def _flatten_coords(coords: torch.Tensor, grid: Grid) -> torch.Tensor:
    flat = coords[..., 0]
    for d in range(1, len(grid.cells_per_side)):
        flat = flat * grid.cells_per_side[d] + coords[..., d]
    return flat


def _dist2(disp: torch.Tensor) -> torch.Tensor:
    """Squared lengths summed axis by axis, ((d0^2 + d1^2) + d2^2): the same
    rounding on every device (a reduction kernel may sum in another order,
    which moves pairs at the cutoff)."""
    out = disp[..., 0] * disp[..., 0]
    for d in range(1, disp.shape[-1]):
        out = out + disp[..., d] * disp[..., d]
    return out


def _pair_mask(disp2, cutoff, receivers, senders, num_particles, n) -> torch.Tensor:
    """Within the cutoff, both ends real particles; ``num_particles`` (B,)
    broadcasts over the pair axes."""
    limit = torch.clamp(num_particles, max=n).view((-1,) + (1,) * (disp2.dim() - 1))
    return (disp2 <= cutoff * cutoff) & (senders < limit) & (receivers < limit)


def _build_cell_table(position: torch.Tensor, num_particles: torch.Tensor, grid: Grid,
                      cell_cap: int):
    """Bin a batch into (B, num_cells, cell_cap) tables of particle ids
    (fill N) and positions (fill 1e9, which no cutoff reaches). A particle
    ranks in its cell by id (a stable sort), as in the JAX package.

    Returns (table_idx, table_pos, cell_overflow (B,), coords (B, N, dim)).
    """
    bsz, n, dim = position.shape
    dev = position.device
    coords = _cell_coords(position, grid)
    valid = torch.arange(n, device=dev) < num_particles[:, None]
    cid = torch.where(valid, _flatten_coords(coords, grid), grid.num_cells)
    cid_sorted, order = torch.sort(cid, dim=1, stable=True)
    rank = torch.arange(n, device=dev) - torch.searchsorted(cid_sorted, cid_sorted, side="left")
    binned = cid_sorted < grid.num_cells
    overflow = ((rank >= cell_cap) & binned).any(dim=1)
    spare = grid.num_cells * cell_cap  # writes past capacity land here and drop
    slots = torch.where((rank < cell_cap) & binned, cid_sorted * cell_cap + rank, spare)
    table = torch.full((bsz, spare + 1), n, dtype=torch.int32, device=dev)
    table.scatter_(1, slots, order.to(torch.int32))
    table_pos = torch.full((bsz, spare + 1, dim), 1e9, dtype=position.dtype, device=dev)
    sel = order[..., None].expand(-1, -1, dim)
    table_pos.scatter_(1, slots[..., None].expand(-1, -1, dim), position.gather(1, sel))
    return (table[:, :spare].view(bsz, grid.num_cells, cell_cap),
            table_pos[:, :spare].view(bsz, grid.num_cells, cell_cap, dim), overflow, coords)


def _celllist_candidates(position, num_particles, displacement_fn, cutoff, grid, cell_cap):
    """Each particle's stencil candidates: (cand (B, N, S*C) sender ids,
    fill N; mask (B, N, S*C) within the cutoff and valid; cell_overflow
    (B,))."""
    bsz, n, dim = position.shape
    dev = position.device
    table, table_pos, cell_overflow, coords = _build_cell_table(position, num_particles, grid,
                                                                cell_cap)
    cps = torch.as_tensor(grid.cells_per_side, device=dev)
    offsets = torch.as_tensor(grid.offsets, device=dev)  # (S, dim)
    pbc = torch.as_tensor(grid.pbc, device=dev)
    ncoords = coords[:, :, None, :] + offsets  # (B, N, S, dim)
    in_range = (pbc | ((ncoords >= 0) & (ncoords < cps))).all(dim=-1)
    ncell = _flatten_coords(torch.remainder(ncoords, cps), grid)  # (B, N, S)
    rows = torch.arange(bsz, device=dev)[:, None, None]
    cand = torch.where(in_range[..., None], table[rows, ncell], n)  # (B, N, S, C)
    disp = displacement_fn(position[:, :, None, None, :], table_pos[rows, ncell])
    disp2 = _dist2(disp)
    receivers = torch.arange(n, device=dev).view(1, n, 1, 1)
    # the index test also rejects the sentinel position slots
    mask = _pair_mask(disp2, cutoff, receivers, cand, num_particles, n) & (cand < n)
    s, c = cand.shape[2], cand.shape[3]
    return cand.reshape(bsz, n, s * c), mask.reshape(bsz, n, s * c), cell_overflow


def _allpairs_candidates(position, num_particles, displacement_fn, cutoff):
    """Every particle a candidate of every row: (cand (B, N, N), mask)."""
    bsz, n, _ = position.shape
    disp = displacement_fn(position[:, :, None, :], position[:, None, :, :])
    disp2 = _dist2(disp)
    ids = torch.arange(n, device=position.device)
    cand = ids.expand(bsz, n, n)
    return cand, _pair_mask(disp2, cutoff, ids[:, None], cand, num_particles, n)


def _nth_true(mask: torch.Tensor, count: int):
    """Index along the last axis of each row's j-th True, j < ``count``,
    by a binary search of the running count (no scatter); the axis length
    where a row has fewer. Returns (positions (..., count), running count).

    The running count is one scan of the flattened mask, less each row's
    start: on CUDA a scan along the last axis takes a block per row, which
    is slow for a few long rows (the sparse list's one row per sample)."""
    length = mask.shape[-1]
    running = torch.cumsum(mask.reshape(-1), dim=0).view(-1, length)
    start = torch.cat([running.new_zeros(1), running[:-1, -1]])
    running = (running - start[:, None]).view(mask.shape)
    nth = torch.arange(1, count + 1, device=mask.device).expand(
        tuple(mask.shape[:-1]) + (count,)).contiguous()
    return torch.searchsorted(running, nth), running


def _dense_select(cand: torch.Tensor, mask: torch.Tensor, k_cap: int, n: int):
    """The first ``k_cap`` valid candidates of each row, in candidate
    order: (senders (B, N, K) int32 fill n, row_overflow (B,))."""
    bsz, rows, c = cand.shape
    if k_cap >= c:  # every candidate slot fits: no selection
        senders = torch.where(mask, cand, n).to(torch.int32)
        pad = senders.new_full((bsz, rows, k_cap - c), n)
        return torch.cat([senders, pad], dim=-1), torch.zeros(bsz, dtype=torch.bool,
                                                              device=cand.device)
    pos, running = _nth_true(mask, k_cap)
    picked = cand.gather(-1, torch.clamp(pos, max=c - 1))
    senders = torch.where(pos < c, picked, n).to(torch.int32)
    return senders, (running[..., -1] > k_cap).any(dim=1)


def _compact_edges(mask: torch.Tensor, senders: torch.Tensor, e_cap: int, n: int):
    """Masked (receiver, sender) pairs of (B, N, C) candidates, packed in
    receiver-major order into (B, 2, e_cap) int32 (fill n); (idx,
    n_edges (B,))."""
    bsz, rows, c = mask.shape
    flat = mask.reshape(bsz, -1)
    pos, running = _nth_true(flat, e_cap)
    valid = pos < flat.shape[1]
    pos = torch.clamp(pos, max=flat.shape[1] - 1)
    send = senders.expand(bsz, rows, c).reshape(bsz, -1).gather(1, pos)
    idx = torch.stack([torch.where(valid, pos // c, n), torch.where(valid, send, n)], dim=1)
    return idx.to(torch.int32), running[:, -1]


def make_xla_edges_fn(backend: str, format: str, cap: int, displacement_fn: Callable,
                      cutoff: float, grid: Optional[Grid] = None, cell_cap: int = 0
                      ) -> Callable:
    """The cell-list or all-pairs edge builder at fixed capacities.

    Returns ``edges(position (B, N, dim), num_particles (B,)) -> (idx,
    overflow (B,))``: dense ``idx`` (B, N, cap) senders; sparse ``idx`` (B,
    2, cap) [receivers; senders]. A sparse cell list whose cells overflow
    counts ``cap + 1`` edges, so that the caller reallocates. Counterpart of
    the JAX package's ``_celllist_dense``, ``_allpairs_dense``,
    ``_celllist_edges`` and ``_allpairs_edges``.
    """

    def edges(position: torch.Tensor, num_particles: torch.Tensor):
        n = position.shape[1]
        if backend == "celllist":
            cand, mask, cell_overflow = _celllist_candidates(
                position, num_particles, displacement_fn, cutoff, grid, cell_cap)
        else:
            cand, mask = _allpairs_candidates(position, num_particles, displacement_fn, cutoff)
            cell_overflow = torch.zeros(position.shape[0], dtype=torch.bool,
                                        device=position.device)
        if format == "dense":
            senders, row_overflow = _dense_select(cand, mask, cap, n)
            return senders, row_overflow | cell_overflow
        idx, n_edges = _compact_edges(mask, cand, cap, n)
        return idx, cell_overflow | (n_edges > cap)

    return edges


def make_edges_fn(
    grid: ColumnGrid,
    k_cap: int,
    col_cap: int,
    cutoff: float,
    box: Sequence[float],
    emit_geometry: bool = False,
) -> Callable:
    """Dense edge builder at a fixed column grid and capacities.

    Returns ``edges(position (B, N, dim), num_particles (B,)) ->
    (senders (B, N, K) int32, overflow (B,) bool)``: K1 bins every sample
    into one shared column table (sample b's columns offset by b*n_cols,
    its sentinel column after them), K2 scans it, and the rows scatter back to particle order. With
    ``emit_geometry``, K9 scans instead and the function returns
    ``(senders, geometry (B, N, K, dim+1) float32, overflow)``: the
    cutoff-normalized [rel_disp, rel_dist] of each slot, zeros in padded
    slots, scattered back together with the senders in one scatter.
    Counterpart of ``neighbors_pallas.make_edges_fn``.
    """
    dim = len(grid.cols_per_side) + 1
    pbc = list(grid.pbc)
    box = [float(b) for b in box]
    n_cols = grid.n_cols
    bases_np = stencil_bases(grid)
    s = bases_np.shape[1]
    cache = {}

    def batch_bases(bsz: int, device) -> torch.Tensor:
        key = (bsz, str(device))
        if key not in cache:
            flat = (
                np.arange(bsz, dtype=np.int32)[:, None, None] * (n_cols + 1)
                + bases_np[None]
            ).reshape(bsz * n_cols, s)
            cache[key] = torch.as_tensor(flat, device=device).contiguous()
        return cache[key]

    def edges(position: torch.Tensor, num_particles: torch.Tensor):
        """position (B, N, dim), num_particles (B,) -> senders[, geometry], overflow."""
        bsz, n, _ = position.shape
        dev = position.device
        _, idx_f, pos_f, col_overflow = nlc.column_table(position, num_particles, grid,
                                                         col_cap)
        kw = dict(n_cols=n_cols, k_cap=k_cap, n=n, cutoff=cutoff, box=box, pbc=pbc)
        if emit_geometry:
            rows, geom, row_max = nlc.neighbor_scan_geometry(
                pos_f, idx_f, batch_bases(bsz, dev), **kw)
        else:
            rows, row_max = nlc.neighbor_scan(pos_f, idx_f, batch_bases(bsz, dev), **kw)

        # rows back to per-sample particle order; empty slots dropped
        local = idx_f.view(bsz, n_cols + 1, col_cap)[:, :n_cols].long().reshape(bsz, -1)
        boffs = torch.arange(bsz, device=dev)[:, None] * n
        back = torch.where(local < n, local + boffs, bsz * n).reshape(-1)
        overflow = (row_max.view(bsz, n_cols).max(dim=1).values > k_cap) | col_overflow
        if not emit_geometry:
            senders = torch.full((bsz * n + 1, k_cap), n, dtype=torch.int32, device=dev)
            senders[back] = rows.reshape(-1, k_cap)
            return senders[: bsz * n].view(bsz, n, k_cap), overflow
        # one scatter for both: the sender ids ride as float32 bits beside
        # the geometry plane
        gw = k_cap * (dim + 1)
        dest = torch.zeros((bsz * n + 1, k_cap + gw), dtype=torch.float32, device=dev)
        dest[:, :k_cap].view(torch.int32).fill_(n)
        dest[back] = torch.cat([rows.reshape(-1, k_cap).view(torch.float32),
                                geom.reshape(-1, gw)], dim=1)
        dest = dest[: bsz * n]
        senders = dest[:, :k_cap].contiguous().view(torch.int32).view(bsz, n, k_cap)
        return senders, dest[:, k_cap:].reshape(bsz, n, k_cap, dim + 1), overflow

    return edges


def make_slot_edges_fn(
    grid: ColumnGrid,
    k_cap: int,
    col_cap: int,
    cutoff: float,
    box: Sequence[float],
) -> Callable:
    """Slot-space edge builder of one sample at a fixed grid and capacities.

    Counterpart of ``neighbors_pallas.make_slot_edges_fn``. Returns
    ``edges(position (N, dim), num_particles) -> (aux, overflow)``: K1
    bins the sample into its column table and K7 scans it, and the graph
    stays in column-slot order. With C = ``col_cap`` and n_ext =
    (n_cols+1)*C (the sentinel column's C rows last):

    * ``aux["cand"]`` (n_ext, K) int32: stencil-candidate index in [0, S*C),
      fill S*C. The receiver of row r is slot r; the sender of candidate c
      lives in slot ``bases[r // C, c // C] * C + c % C``;
    * ``aux["rel_disp"]`` (n_ext, K, dim), ``aux["rel_dist"]`` (n_ext, K, 1)
      float32: receiver - sender, cutoff-normalized, zeros in padded slots;
    * ``aux["slot_to_particle"]`` (n_ext,) int32, fill N;
    * ``aux["particle_to_slot"]`` (N,) int32; an unbinned particle holds
      K1's sentinel slot n_cols*C;
    * ``aux["bases"]`` (n_cols, S) int32, the stencil table.
    """
    dim = len(grid.cols_per_side) + 1
    pbc = list(grid.pbc)
    box = [float(b) for b in box]
    n_cols = grid.n_cols
    bases_np = stencil_bases(grid)
    cache = {}

    def edges(position: torch.Tensor, num_particles):
        n = position.shape[0]
        dev = position.device
        if str(dev) not in cache:
            cache[str(dev)] = torch.as_tensor(bases_np, device=dev).contiguous()
        bases = cache[str(dev)]
        npart = torch.as_tensor(num_particles, device=dev).reshape(1)
        slots, idx_f, pos_f, col_overflow = nlc.column_table(position[None], npart, grid,
                                                             col_cap)
        cand, rel_disp, rel_dist, row_max = nlc.slot_scan(
            pos_f, idx_f, bases, n_cols=n_cols, k_cap=k_cap, n=n, cutoff=cutoff, box=box,
            pbc=pbc,
        )
        aux = {
            "cand": cand,
            "rel_disp": rel_disp,
            "rel_dist": rel_dist,
            "slot_to_particle": idx_f.reshape(-1),
            "particle_to_slot": slots,
            "bases": bases,
        }
        return aux, (row_max.max() > k_cap) | col_overflow

    return edges


def neighbor_list(
    displacement_fn: Optional[Callable],
    box,
    r_cutoff: float,
    backend: str = "cuda",
    capacity_multiplier: float = 1.25,
    num_particles_max: Optional[int] = None,
    pbc: Optional[Sequence[bool]] = None,
    mask_self: bool = False,
    format: str = "dense",
    emit_geometry: bool = False,
) -> NeighborListFns:
    """Create allocate/update functions for a fixed-capacity radius graph.

    Args:
        displacement_fn: pairwise displacement of the cell list and
            all-pairs searches (None: the minimum image of ``box`` when any
            axis is periodic, else the plain difference); the kernels
            min-image periodic axes themselves.
        box: box side lengths, shape (dim,).
        r_cutoff: connectivity radius.
        backend: "cuda" (the kernels; dense and slot formats), "celllist"
            or "allpairs".
        capacity_multiplier: headroom factor on the capacities.
        num_particles_max: accepted for API parity.
        pbc: per-dimension periodic flags (default all periodic).
        mask_self: must be False (self-edges are kept).
        format: "dense", "sparse" or "slot" (slot takes the kernel
            backend).
        emit_geometry: dense format on the kernel backend: the scan (K9)
            also emits the edge geometry, carried as ``aux`` (the slot
            format always has it). Ignored where an allocation takes
            another backend.

    The tensors of ``allocate`` and ``update`` live on the device of the
    positions they are given.
    """
    if format not in ("dense", "sparse", "slot"):
        raise ValueError(f"unknown neighbor format {format!r}")
    if backend not in ("cuda", "celllist", "allpairs"):
        raise ValueError(f"unknown neighbor backend {backend!r}")
    if mask_self:
        raise ValueError("self-edges are kept (mask_self=False)")
    if format == "slot":
        backend = "cuda"
    box = np.asarray(box, dtype=np.float64).reshape(-1)
    dim = box.shape[0]
    pbc = [True] * dim if pbc is None else [bool(p) for p in np.asarray(pbc).reshape(-1)]
    cutoff = float(r_cutoff)
    # the displacement is periodic on every axis if any axis is, as in the
    # JAX package
    periodic_all = any(pbc)

    grid = make_grid(box, cutoff, pbc) if backend != "allpairs" else None
    if grid is None and backend != "allpairs":
        if format == "slot":
            raise ValueError("the slot format needs a cell grid (box too small for a 3-cell "
                             "stencil at this cutoff); use the dense format")
        backend = "allpairs"
    if backend == "cuda":
        if format == "sparse":
            raise ValueError("the cuda neighbor kernels are dense/slot-only; the sparse "
                             "format takes the celllist or allpairs backend")
        if dim not in (2, 3):
            raise ValueError("the neighbor kernels support 2D and 3D")

    def _displacement(position: torch.Tensor) -> Callable:
        if displacement_fn is not None:
            return displacement_fn
        if not periodic_all:
            return space.free()[0]
        side = torch.as_tensor(box, dtype=position.dtype, device=position.device)
        return space.periodic(side)[0]

    def _count_and_caps(position, num_particles, capacity_boost: float = 1.0):
        """Host-side capacities of one sample -> (cap, cell_cap, col_grid,
        backend): cap is K (dense, slot) or E (sparse); cell_cap the column
        capacity on the kernel backend, the cell capacity on the cell list;
        the backend is the one this allocation takes."""
        eff_backend = backend
        mult = capacity_multiplier * capacity_boost
        pos = np.asarray(position, dtype=np.float64)
        npart = pos.shape[0] if num_particles is None else int(num_particles)
        pos_valid = pos[:npart]

        if host_available():
            count = count_edges(pos_valid, box, periodic_all, cutoff)
            max_k = 1
            if format != "sparse":
                edges, _ = build_edges(pos_valid, box, periodic_all, cutoff, e_cap=count)
                per_row = np.bincount(edges[0], minlength=npart)
                max_k = int(per_row.max()) if per_row.size else 1
        else:  # chunked numpy, bounding the (chunk, N, dim) temporary
            count, max_k, cutoff2 = 0, 1, cutoff * cutoff
            for start in range(0, npart, 1024):
                disp = pos_valid[start : start + 1024, None, :] - pos_valid[None]
                if periodic_all:
                    disp = np.mod(disp + box * 0.5, box) - box * 0.5
                within = np.sum(disp * disp, axis=-1) <= cutoff2
                count += int(within.sum())
                if within.size:
                    max_k = max(max_k, int(within.sum(axis=1).max()))

        col_grid, cell_cap = None, 0
        if eff_backend == "cuda":
            col_grid, cell_cap = _column_grid(pos_valid, mult, max_k)
            if col_grid is None:
                if format == "slot":
                    raise ValueError(
                        f"the slot format: no column grid fits the neighbor scan kernel at "
                        f"this size (box {box.tolist()}, cutoff {cutoff}); use the dense "
                        "format")
                warnings.warn("cuda neighbor backend: no column grid fits the scan kernel "
                              "at this system size; falling back to the celllist backend "
                              "for this allocation")
                eff_backend = "celllist"
        if eff_backend == "celllist":
            size, cps = np.asarray(grid.cell_size), np.asarray(grid.cells_per_side)
            coords = np.clip(np.floor(pos_valid / size).astype(np.int64), 0, cps - 1)
            cid = coords[:, 0]
            for d in range(1, dim):
                cid = cid * grid.cells_per_side[d] + coords[:, d]
            occ = np.bincount(cid, minlength=grid.num_cells)
            cell_cap = max(_round_up((int(occ.max()) if occ.size else 1) * mult, 4), 4)

        if format == "sparse":
            return max(_round_up(max(count, 1) * mult, 128), 128), cell_cap, None, eff_backend
        # multiples of 8 for the kernels' K axis, 4 elsewhere (the JAX
        # package's alignment, so that both packages' shapes agree)
        k_align = 8 if eff_backend == "cuda" else 4
        k_cap = max(_round_up(max(max_k, 1) * mult, k_align), k_align)
        return k_cap, cell_cap, col_grid, eff_backend

    def _column_grid(pos_valid, mult, max_k):
        """The kernel backend's column grid: coarsenings of the first dim-1
        cell axes (any column side >= cutoff is valid); the one with the
        least scan work among those whose column fits a scan block (the
        one limit of K2, K7 and K9; K8 reads sender rows from device memory
        and has none) and whose column count K1's shared memory holds.
        (None, 0) when none does."""
        best = None
        base_nc = [max(int(math.floor(float(b) / cutoff)), 1) for b in box[:-1]]
        for f in (1.0, 0.75, 0.6, 0.5, 0.4, 0.33):
            ncs = [max(int(round(nc * f)), 1) for nc in base_nc]
            if any(nc < 3 and p for nc, p in zip(ncs, pbc[:-1])):
                continue
            sizes = [float(b) / nc for b, nc in zip(box[:-1], ncs)]
            if any(s < cutoff for s in sizes):
                continue
            cid = np.zeros(len(pos_valid), dtype=np.int64)
            n_bins = 1
            for d, (nc, s) in enumerate(zip(ncs, sizes)):
                c = np.clip(np.floor(pos_valid[:, d] / s).astype(np.int64), 0, nc - 1)
                cid = cid * nc + c
                n_bins *= nc
            occ = np.bincount(cid, minlength=n_bins)
            max_occ = int(occ.max()) if occ.size else 1
            cap = max(_round_up(max_occ * mult, 8), 8)
            if nlc.scan_chunk(cap, 3 ** (dim - 1)) == 0 or not nlc.column_table_fits(n_bins):
                continue
            cost = n_bins * cap * cap
            if best is None or cost < best[0]:
                best = (cost, ncs, sizes, cap)
        if best is None:
            return None, 0
        _, ncs, sizes, col_cap = best
        return ColumnGrid(tuple(ncs), tuple(sizes), int(np.prod(ncs)), tuple(pbc)), col_cap

    def _sticky(neighbors, overflow):
        """The new flag or'ed with the previous list's (sticky overflow)."""
        if neighbors is None:
            return overflow
        return overflow | neighbors.did_buffer_overflow.to(overflow.device)

    def _make_update(cap: int, cell_cap: int, col_grid: Optional[ColumnGrid],
                     eff_backend: str) -> Callable:
        if format == "slot":
            slot_edges = make_slot_edges_fn(col_grid, cap, cell_cap, cutoff, box)

            def update_slot(position, neighbors=None, num_particles=None, **kwargs):
                position = torch.as_tensor(position)
                batched = position.dim() == 3
                if batched and position.shape[0] != 1:
                    raise ValueError(
                        "the slot neighbor layout is single-sample: a batched update "
                        f"takes batch 1, got {position.shape[0]}"
                    )
                pos1 = position[0] if batched else position
                npart = pos1.shape[0] if num_particles is None else num_particles
                if isinstance(npart, torch.Tensor):
                    npart = npart.reshape(-1)[0]
                aux, overflow = slot_edges(pos1, npart)
                overflow = _sticky(neighbors, overflow.reshape(1) if batched else overflow)
                cand = aux.pop("cand")
                if batched:
                    cand, aux = cand[None], {k: v[None] for k, v in aux.items()}
                return NeighborList(idx=cand, did_buffer_overflow=overflow,
                                    update_fn=update_slot, format="slot", aux=aux)

            return update_slot

        geometry = emit_geometry and eff_backend == "cuda"
        if eff_backend == "cuda":
            edges = make_edges_fn(col_grid, cap, cell_cap, cutoff, box, geometry)
        else:
            xla = {}

            def edges(position, num_particles):
                key = (position.dtype, position.device)
                if key not in xla:
                    xla[key] = make_xla_edges_fn(eff_backend, format, cap,
                                                 _displacement(position), cutoff, grid,
                                                 cell_cap)
                return xla[key](position, num_particles)

        def update(position, neighbors=None, num_particles=None, **kwargs):
            position = torch.as_tensor(position)
            batched = position.dim() == 3
            pos_b = position if batched else position[None]
            bsz, n = pos_b.shape[:2]
            if num_particles is None:
                npart = torch.full((bsz,), n, dtype=torch.int32, device=pos_b.device)
            else:
                npart = torch.as_tensor(num_particles, device=pos_b.device)
                npart = npart.reshape(-1).expand(bsz)
            out = edges(pos_b, npart)
            idx, overflow = out[0], out[-1]
            aux = None
            if geometry:
                aux = {"rel_disp": out[1][..., :dim], "rel_dist": out[1][..., dim:]}
            overflow = _sticky(neighbors, overflow)
            if not batched:
                idx, overflow = idx[0], overflow[0]
                aux = None if aux is None else {k: v[0] for k, v in aux.items()}
            return NeighborList(idx=idx, did_buffer_overflow=overflow, update_fn=update,
                                format=format, aux=aux, backend=eff_backend)

        return update

    def allocate_shell(position, num_particles=None, capacity_boost: float = 1.0,
                       device=None, **kwargs) -> NeighborList:
        """Size buffers from this sample without building the list.

        The returned list holds all-padding buffers of the shapes an update
        returns and the update closure at the chosen capacities.
        ``capacity_boost`` scales them beyond the standard multiplier (used
        by the rollout's retries).
        """
        pos_np = (
            position.detach().cpu().numpy() if isinstance(position, torch.Tensor)
            else np.asarray(position)
        )
        if device is None:
            device = position.device if isinstance(position, torch.Tensor) else "cpu"
        cap, cell_cap, col_grid, eff_backend = _count_and_caps(pos_np, num_particles,
                                                               capacity_boost)
        n = pos_np.shape[0]
        shape, fill, aux = (n, cap), n, None
        if format == "sparse":
            shape = (2, cap)
        elif format == "slot":
            bases = torch.as_tensor(stencil_bases(col_grid), device=device)
            shape = ((col_grid.n_cols + 1) * cell_cap, cap)
            fill = bases.shape[1] * cell_cap
            aux = {
                "slot_to_particle": torch.full(shape[:1], n, dtype=torch.int32, device=device),
                "particle_to_slot": torch.zeros((n,), dtype=torch.int32, device=device),
                "bases": bases,
            }
        if format == "slot" or (emit_geometry and eff_backend == "cuda"):
            aux = dict(aux or {},
                       rel_disp=torch.zeros(shape + (dim,), device=device),
                       rel_dist=torch.zeros(shape + (1,), device=device))
        return NeighborList(
            idx=torch.full(shape, fill, dtype=torch.int32, device=device),
            did_buffer_overflow=torch.zeros((), dtype=torch.bool, device=device),
            update_fn=_make_update(cap, cell_cap, col_grid, eff_backend),
            format=format,
            aux=aux,
            backend=eff_backend,
        )

    def allocate(position, num_particles=None, capacity_boost: float = 1.0,
                 **kwargs) -> NeighborList:
        """Size buffers from this sample and build the list."""
        shell = allocate_shell(position, num_particles, capacity_boost)
        return shell.update_fn(torch.as_tensor(position), None, num_particles=num_particles)

    def update(position, neighbors: NeighborList, num_particles=None, **kwargs):
        return neighbors.update_fn(position, neighbors, num_particles=num_particles)

    return NeighborListFns(allocate=allocate, update=update, allocate_shell=allocate_shell)
