"""Fixed-capacity radius-graph neighbor search: the dense ``(N, K)`` format,
with or without in-kernel edge geometry, and the cell-sorted slot format.

Counterpart of ``lagrangebench_tpu/ops/neighbors.py`` with its Pallas
backend:

* ``allocate`` sizes the buffers on the host (numpy and the C++ engine in
  ``native/``) from one sample: K is the largest neighbor count times the
  capacity multiplier, rounded up to a multiple of 8; the column grid is
  the coarsening of the first dim-1 cell axes that minimises the scan's
  work ``n_cols * cap^2`` among those the scan kernels admit (a size with
  none raises);
* ``update`` runs the kernels at that fixed capacity. It never resizes: it
  raises ``did_buffer_overflow``, which stays set across updates until the
  caller reallocates (``capacity_boost`` scales the capacities of that
  reallocation).

``format="dense"``: K1 builds the column table in one launch (the columns,
ranks and slots of the particles, the table of ids and positions with its
sentinel columns, the column-overflow flags), K2 scans each column's
stencil and packs K senders per receiver, and torch index ops scatter the
rows back to particle order. Rows are receivers; senders fill with N;
self-edges are kept; padded particles (index >= num_particles) are
excluded. A batch of B samples shares one launch of each kernel, and a
column overflow in any sample flags every sample, as in the JAX package's
batched edge builder. With ``emit_geometry``
K9 takes K2's place and also emits the cutoff-normalized edge geometry,
scattered back with the senders in one scatter; the list carries it as
``aux["rel_disp"]`` (N, K, dim) and ``aux["rel_dist"]`` (N, K, 1).

``format="slot"`` (single-sample): K1 bins, then K7 writes the graph in
column-slot order, with no scatter back: ``idx`` is the (n_ext, K)
stencil-candidate matrix, and ``aux`` holds the geometry, the maps
between slots and particles and the stencil table (see
:func:`make_slot_edges_fn`). A batched update takes batch 1 only.

There is no fallback to another search; the sparse ``(2, E)`` format is
not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import neighbors_cuda as nlc
from .neighbors_host import available as host_available
from .neighbors_host import build_edges, count_edges


def _round_up(x: int, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


@dataclass
class NeighborList:
    """Fixed-capacity neighbor list, dense or slot format.

    Attributes:
        idx: dense: (N, K) int32 sender matrix, row i holding the neighbors
            of receiver i, fill N. Slot: (n_ext, K) int32 stencil-candidate
            matrix in column-slot order, fill S*C. A leading batch axis B
            for a batch.
        did_buffer_overflow: bool tensor, () or (B,); True once a capacity
            was exceeded (sticky across updates).
        update_fn: the update closure bound to this list's capacities.
        format: "dense" or "slot".
        aux: None, or the tensors beside ``idx`` (batched like it): the
            in-kernel geometry of a dense list with ``emit_geometry``; the
            geometry, maps and stencil table of a slot list.
    """

    idx: torch.Tensor
    did_buffer_overflow: torch.Tensor
    update_fn: Callable
    format: str = "dense"
    aux: Optional[dict] = None

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


def _has_stencil_grid(box: np.ndarray, cutoff: float, pbc: Sequence[bool]) -> bool:
    """The JAX package's cell-grid test: >= 3 cells on periodic axes and not
    fewer than 3 on every axis."""
    cps = [max(int(math.floor(float(b) / cutoff)), 1) for b in box]
    if any(c < 3 and p for c, p in zip(cps, pbc)):
        return False
    return not all(c < 3 for c in cps)


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
    displacement_fn: Callable,
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
        displacement_fn: pairwise displacement (kept for API parity; the
            kernels min-image periodic axes themselves).
        box: box side lengths, shape (dim,).
        r_cutoff: connectivity radius.
        backend: "cuda", the port's kernel backend.
        capacity_multiplier: headroom factor on the K and column capacities.
        num_particles_max: accepted for API parity.
        pbc: per-dimension periodic flags (default all periodic).
        mask_self: must be False (self-edges are kept).
        format: "dense" or "slot"; "sparse" is not ported.
        emit_geometry: dense format: the scan (K9) also emits the edge
            geometry, carried as ``aux`` (the slot format always has it).

    The tensors of ``allocate`` and ``update`` live on the device of the
    positions they are given.
    """
    if format not in ("dense", "slot"):
        raise NotImplementedError(f"neighbor format {format!r} is not ported")
    if backend != "cuda":
        raise NotImplementedError(f"neighbor backend {backend!r} is not ported")
    if mask_self:
        raise ValueError("self-edges are kept (mask_self=False)")
    box = np.asarray(box, dtype=np.float64).reshape(-1)
    dim = box.shape[0]
    if dim not in (2, 3):
        raise ValueError("the neighbor kernels support 2D and 3D")
    pbc = [True] * dim if pbc is None else [bool(p) for p in np.asarray(pbc).reshape(-1)]
    cutoff = float(r_cutoff)
    if not _has_stencil_grid(box, cutoff, pbc):
        raise ValueError(
            "box too small for a 3-cell stencil at this cutoff; the port has "
            "no all-pairs search"
        )
    periodic_all = any(pbc)

    def _count_and_caps(position, num_particles, capacity_boost: float = 1.0):
        """Host-side K capacity, column capacity and column grid."""
        mult = capacity_multiplier * capacity_boost
        pos = np.asarray(position, dtype=np.float64)
        npart = pos.shape[0] if num_particles is None else int(num_particles)
        pos_valid = pos[:npart]

        if host_available():
            count = count_edges(pos_valid, box, periodic_all, cutoff)
            edges, _ = build_edges(pos_valid, box, periodic_all, cutoff, e_cap=count)
            per_row = np.bincount(edges[0], minlength=npart)
            max_k = int(per_row.max()) if per_row.size else 1
        else:
            max_k, cutoff2 = 1, cutoff * cutoff
            for start in range(0, npart, 1024):
                disp = pos_valid[start : start + 1024, None, :] - pos_valid[None]
                if periodic_all:
                    disp = np.mod(disp + box * 0.5, box) - box * 0.5
                within = np.sum(disp * disp, axis=-1) <= cutoff2
                if within.size:
                    max_k = max(max_k, int(within.sum(axis=1).max()))

        # column grid: coarsenings of the first dim-1 cell axes (any column
        # side >= cutoff is valid); keep the one with the least scan work
        # among those whose column fits a scan block (the one limit of K2,
        # K7 and K9; K8 reads sender rows from device memory and has none)
        # and whose column count K1's shared memory holds
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
            raise ValueError(
                f"no column grid fits the neighbor scan kernel at this size ({format} "
                f"format, box {box.tolist()}, cutoff {cutoff})"
            )
        _, ncs, sizes, col_cap = best
        grid = ColumnGrid(tuple(ncs), tuple(sizes), int(np.prod(ncs)), tuple(pbc))
        k_cap = max(_round_up(max(max_k, 1) * mult, 8), 8)
        return k_cap, col_cap, grid

    def _sticky(neighbors, overflow):
        """The new flag or'ed with the previous list's (sticky overflow)."""
        if neighbors is None:
            return overflow
        return overflow | neighbors.did_buffer_overflow.to(overflow.device)

    def _make_update(k_cap: int, col_cap: int, grid: ColumnGrid) -> Callable:
        if format == "slot":
            slot_edges = make_slot_edges_fn(grid, k_cap, col_cap, cutoff, box)

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

        edges = make_edges_fn(grid, k_cap, col_cap, cutoff, box, emit_geometry)

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
            senders, overflow = out[0], out[-1]
            aux = None
            if emit_geometry:
                aux = {"rel_disp": out[1][..., :dim], "rel_dist": out[1][..., dim:]}
            overflow = _sticky(neighbors, overflow)
            if not batched:
                senders, overflow = senders[0], overflow[0]
                aux = None if aux is None else {k: v[0] for k, v in aux.items()}
            return NeighborList(idx=senders, did_buffer_overflow=overflow, update_fn=update,
                                aux=aux)

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
        k_cap, col_cap, grid = _count_and_caps(pos_np, num_particles, capacity_boost)
        n = pos_np.shape[0]
        rows, aux = n, None
        if format == "slot":
            bases = torch.as_tensor(stencil_bases(grid), device=device)
            rows = (grid.n_cols + 1) * col_cap
            fill = bases.shape[1] * col_cap
            aux = {
                "slot_to_particle": torch.full((rows,), n, dtype=torch.int32, device=device),
                "particle_to_slot": torch.zeros((n,), dtype=torch.int32, device=device),
                "bases": bases,
            }
        else:
            fill = n
        if format == "slot" or emit_geometry:
            aux = dict(aux or {},
                       rel_disp=torch.zeros((rows, k_cap, dim), device=device),
                       rel_dist=torch.zeros((rows, k_cap, 1), device=device))
        return NeighborList(
            idx=torch.full((rows, k_cap), fill, dtype=torch.int32, device=device),
            did_buffer_overflow=torch.zeros((), dtype=torch.bool, device=device),
            update_fn=_make_update(k_cap, col_cap, grid),
            format=format,
            aux=aux,
        )

    def allocate(position, num_particles=None, capacity_boost: float = 1.0,
                 **kwargs) -> NeighborList:
        """Size buffers from this sample and build the list."""
        shell = allocate_shell(position, num_particles, capacity_boost)
        return shell.update_fn(torch.as_tensor(position), None, num_particles=num_particles)

    def update(position, neighbors: NeighborList, num_particles=None, **kwargs):
        return neighbors.update_fn(position, neighbors, num_particles=num_particles)

    return NeighborListFns(allocate=allocate, update=update, allocate_shell=allocate_shell)
