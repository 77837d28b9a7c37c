"""Spatial (x-slab) sharding with a halo exchange, over ``torch.distributed``.

Counterpart of ``lagrangebench_tpu/parallel/spatial.py`` for GNS, PaiNN,
SEGNN and EGNN.
The box is split into slabs along x and each rank of a slab ring owns the
particles of one slab: positions, the (N_loc, K) neighbor list, edge states
and node states never leave it. Per message-passing step a rank sends its
projected sender states, one (N_loc, F) block, to its two ring neighbours
and receives theirs (the halo), so that every edge of its receivers finds
its sender's row; nothing is gathered across the ring.

* Host helpers (numpy, as in JAX): :func:`spatial_partition`,
  :func:`spatial_caps` (the port's host neighbor engine), the random-walk
  noise ``_host_gns_noise`` and the periodic-box check.
* The local search (``_local_cell_nl``): the slab's receivers against its
  own and both halo slabs' particles in a local frame, binned into a
  (cells, C) table and tested on the 3^dim stencil, in PyTorch ops over
  ``ops/neighbors.py``'s helpers (the JAX package leaves it to XLA). A
  stable sort, squared distances summed axis by axis and min-image on the
  periodic axes only make the senders equal JAX's in float64.
* The halo: :func:`halo_exchange`, one ``batch_isend_irecv`` of the ring
  shifts, inside an autograd Function whose backward sends the cotangents
  back the other way (the transpose of JAX's ``ppermute``);
  :func:`reverse_halo`, its transpose as a Function of its own (halo
  segments home and summed; the backward is the halo's forward). Over
  gloo a CUDA tensor is staged through the host (``.cpu()``, the exchange,
  ``.to(device)``), under the ``spatial::halo_staging`` span of the
  ``spatial::halo_exchange`` span; NCCL exchanges CUDA tensors directly.
* The models are the port's own modules, not restated: the spatial GNS runs
  ``GNS.encode_nodes``, ``GNS.process`` (per step the sender rows are
  gathered from the halo-extended projection, then K3 with the edge encoder
  folded into step 0; K4 in the backward) and the decoder; the spatial
  PaiNN runs ``PaiNN.embed``, each fused layer with K5 gathering from the
  halo-extended (3 N_loc, (2 + dim) H) rows, and ``PaiNN.read_out``. SEGNN
  and EGNN run the module built for the config (``model_def``, as JAX
  passes its flax module) with their layers' ``sender_nodes`` /
  ``sender_h``, ``sender_pos``, ``edge_mask`` and ``sender_scatter_fn``:
  SEGNN exchanges its whole (N_loc, dim) node tensor once per layer, EGNN
  its ``h`` and accumulated position delta in one tensor, and returns its
  sender-directed position sums through the reverse halo. PyTorch ops, as
  JAX leaves them to XLA.
* Training: the loss is each rank's share of the global kinematic-masked
  acceleration MSE; sender-state cotangents return home through the halo's
  backward; loss, overflow flag and gradients are summed over the mesh in
  one flat all-reduce. The global particle count is all-reduced before the
  forward, outside autograd (differentiating through it would count the
  ring n times). :func:`build_spatial_train_step_dp` composes the slab ring
  with data parallelism over the rows of a :class:`~.mesh.Mesh2D`.
* Rollout (:func:`spatial_rollout`): chunks of steps, the overflow and
  drift flags reduced over the ring once per chunk; on an overflow the
  capacities escalate and the chunk reruns, on drift it reruns shorter;
  after each chunk every rank's slab (padded to N_loc) is gathered with
  ``all_gather_into_tensor`` and the slabs re-partitioned alike on every
  rank.
* :func:`train_spatial` and :func:`infer_spatial`: the runner's
  ``parallel.spatial: N`` (N ranks, N x n_data for a batch over the rows of
  a 2D mesh); standard-layout checkpoints, written by rank 0.

Partitioning (ring of n >= 3): each rank sees candidates from its own slab
plus both neighbour slabs, placed in a local frame ``rel_x = base_seg +
centered_mod(x - owner * slab_w)`` (plain differences in x, min-image on the
other axes). Rings of 2 and 1 degenerate to the fully periodic box on each
rank (no self-image duplicates).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
SEGNN with instance norm and EGNN with more than the velocity magnitudes
as node features (particle types, an external force) raise ValueError, as
JAX's asserts refuse them.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.e3 import IrrepsArray, from_mul_major
from ..models.gns import GNS, fused_params_from_standard, standard_params_from_fused
from ..models.painn import (
    EPS,
    PaiNN,
    cosine_cutoff,
    painn_fused_params_from_standard,
    painn_standard_params_from_fused,
)
from ..ops import neighbors as nb
from ..models.segnn import EDGE_IRREPS
from ..ops import painn_msg, space
from ..ops.scatter import segment_sum
from ..utils import NodeType, resolve_device
from .mesh import Mesh, Mesh2D, _world, launch_hint, make_mesh, make_mesh_2d

MODELS = ("gns", "painn", "segnn", "egnn")
# a chunk reruns shorter once 2 x the largest x-drift since it started plus
# the cutoff reaches this share of the slab width
DRIFT_SHARE = 0.95


# ---------------------------------------------------------------------------
# host helpers (numpy)
# ---------------------------------------------------------------------------

def _require_periodic(metadata, where: str) -> None:
    """Spatial sharding takes fully periodic boxes only: the slab partition
    wraps positions through the box. Wall-bounded datasets run the standard
    path (reference boundary dispatch: lagrangebench/case_setup/case.py:104-108)."""
    pbc = list(metadata.get("periodic_boundary_conditions", []))
    if not (pbc and all(bool(p) for p in pbc)):
        raise ValueError(
            f"{where}: parallel.spatial requires a fully periodic box, but "
            f"the dataset has periodic_boundary_conditions={pbc}. "
            f"Wall-bounded datasets wrap through walls under the slab "
            f"partition — run them on the standard path (parallel.spatial=0)."
        )


def spatial_partition(
    pos: np.ndarray,
    ptype: np.ndarray,
    n_dev: int,
    box_x: float,
    pad_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Slab partition along x by the most recent frame of ``pos`` (N, T, dim).

    Returns (pos_sh (n_dev, N_loc, T, dim), ptype_sh (n_dev, N_loc) with -1
    padding, counts (n_dev,), order (N,) original indices in slab-sorted
    order); ``order[:counts.cumsum()]`` recovers the global permutation.
    Every rank computes the same partition from the same inputs.
    """
    pos = np.asarray(pos)
    ptype = np.asarray(ptype)
    n, t, dim = pos.shape
    x = np.mod(pos[:, -1, 0], box_x)
    slab = np.clip((x / (box_x / n_dev)).astype(np.int64), 0, n_dev - 1)
    order = np.argsort(slab, kind="stable")
    counts = np.bincount(slab, minlength=n_dev)
    n_loc = int(-(-max(int(counts.max()), 1) // pad_multiple) * pad_multiple)

    pos_sh = np.zeros((n_dev, n_loc, t, dim), pos.dtype)
    ptype_sh = np.full((n_dev, n_loc), -1, ptype.dtype)
    start = 0
    for d in range(n_dev):
        c = int(counts[d])
        sel = order[start: start + c]
        pos_sh[d, :c] = pos[sel]
        ptype_sh[d, :c] = ptype[sel]
        start += c
    return pos_sh, ptype_sh, counts.astype(np.int32), order


def _slab_rows(counts: np.ndarray, order: np.ndarray, d: int) -> np.ndarray:
    """The global indices of slab d's particles, in slab order."""
    start = int(np.sum(counts[:d]))
    return order[start: start + int(counts[d])]


def spatial_caps(pos: np.ndarray, box, cutoff: float,
                 multiplier: float = 1.25) -> Tuple[int, int]:
    """(k_cap, cell_cap) of the slab search, from the most recent frame (N, dim)."""
    from ..ops import neighbors_host

    pos = np.mod(np.asarray(pos, np.float64), np.asarray(box))
    box = np.asarray(box, np.float64)
    dim = pos.shape[1]
    ncs = [max(int(np.floor(b / cutoff)), 1) for b in box]
    sizes = box / np.asarray(ncs)
    coords = np.clip((pos / sizes).astype(np.int64), 0, np.asarray(ncs) - 1)
    cid = coords[:, 0]
    for d in range(1, dim):
        cid = cid * ncs[d] + coords[:, d]
    occ = np.bincount(cid, minlength=int(np.prod(ncs)))
    max_occ = int(occ.max()) if occ.size else 1
    cell_cap = max(-(-int(max_occ * multiplier) // 8) * 8, 8)
    # the neighbor count bound: exact from the host engine, else estimated
    # from the densest cell (a cell is at least one cutoff wide)
    if neighbors_host.available() and pos.shape[0] <= 200_000:
        count = neighbors_host.build_edges(
            pos, box, True, cutoff,
            e_cap=neighbors_host.count_edges(pos, box, True, cutoff),
        )[0]
        per_row = np.bincount(count[0], minlength=pos.shape[0])
        max_k = int(per_row.max()) if per_row.size else 1
    else:
        max_k = int(max_occ * 4.2 / 3 + 1)  # sphere vs cube volume ratio
    k_cap = max(-(-int(max_k * multiplier) // 8) * 8, 8)
    return k_cap, cell_cap


def _host_gns_noise(rng: np.random.Generator, pos, ptype, isl: int, noise_std: float, box):
    """Host random-walk noise with the math of ``train.strats.add_gns_noise``
    (velocity walk whose last step has std ``noise_std``, zero on kinematic
    particles, target frames shifted by the last input frame's noise)."""
    if noise_std <= 0:
        return pos
    n, t, dim = pos.shape
    nvel = isl - 1
    vel_noise = rng.normal(size=(n, nvel, dim)) * (noise_std / nvel**0.5)
    vel_walk = np.cumsum(vel_noise, axis=1)
    pos_noise = np.concatenate([np.zeros((n, 1, dim)), np.cumsum(vel_walk, axis=1)], axis=1)
    kin = (ptype == 1) | (ptype == 2) | (ptype == -1)
    pos_noise[kin] = 0.0
    full = np.concatenate([pos_noise, np.repeat(pos_noise[:, -1:], t - isl, axis=1)], axis=1)
    return np.mod(pos + full, np.asarray(box))


# ---------------------------------------------------------------------------
# the slab ring and its exchanges
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ring:
    """One rank's slab ring: its process group (None for one slab), the
    global ranks in ring order and this rank's index among them."""

    group: Optional[Any]
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    def peer(self, shift: int) -> int:
        """The global rank ``shift`` places on around the ring."""
        return self.ranks[(self.index + shift) % self.size]


def ring_of(mesh: Mesh) -> Ring:
    """The slab ring of a 1D mesh (all of it) or of a 2D mesh (this rank's row)."""
    if not mesh.member:
        raise ValueError("this rank is not a member of the mesh")
    if isinstance(mesh, Mesh2D):
        return Ring(mesh.ring, mesh.ring_ranks, mesh.space_index)
    return Ring(mesh.group, tuple(range(mesh.size)), mesh.rank)


def _staged(ring: Ring, x: torch.Tensor) -> bool:
    """Gloo sends and receives host tensors: a CUDA tensor goes through the host."""
    return x.is_cuda and dist.get_backend(ring.group) == "gloo"


def _exchange(ring: Ring, sends: Sequence[Tuple[int, torch.Tensor]]) -> List[torch.Tensor]:
    """One batch of point-to-point messages around the ring: for each (shift
    s, tensor x), x goes to the rank s places on and a tensor of x's shape
    and dtype comes back from the rank s places back. Posted together with
    ``batch_isend_irecv`` (tagged by position), so that no order can
    deadlock. Returns the received tensors in the order of ``sends``."""
    with torch.profiler.record_function("spatial::halo_exchange"):
        device = sends[0][1].device
        stage = _staged(ring, sends[0][1])
        if stage:
            with torch.profiler.record_function("spatial::halo_staging"):
                payload = [x.detach().cpu() for _, x in sends]
        else:
            payload = [x.detach().contiguous() for _, x in sends]
        ops, out = [], []
        for tag, ((shift, _), x) in enumerate(zip(sends, payload)):
            buf = torch.empty_like(x)
            ops.append(dist.P2POp(dist.isend, x, ring.peer(shift), ring.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, ring.peer(-shift), ring.group, tag))
            out.append(buf)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if stage:
            with torch.profiler.record_function("spatial::halo_staging"):
                out = [x.to(device) for x in out]
        return out


def _send_back(ring: Ring, shifts, xs) -> torch.Tensor:
    """Each of ``xs`` back the other way (``-shift`` places on), summed on
    arrival: the transpose of the shifts of one tensor."""
    back = _exchange(ring, [(-s, x.contiguous()) for s, x in zip(shifts, xs)])
    out = back[0]
    for x in back[1:]:
        out = out + x
    return out


class _Halo(torch.autograd.Function):
    """The ring shifts of one tensor, differentiable: the forward sends x
    ``shift`` places on for every shift and returns what arrives; the
    backward sends each output's cotangent back the other way and sums
    what arrives, the gradient of x (JAX: the transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, ring, shifts, x):
        ctx.ring, ctx.shifts = ring, shifts
        return tuple(_exchange(ring, [(s, x) for s in shifts]))

    @staticmethod
    def backward(ctx, *grads):
        return None, None, _send_back(ctx.ring, ctx.shifts, grads)


class _ReverseHalo(torch.autograd.Function):
    """The transpose of :class:`_Halo`: the forward sends each halo segment
    back to the rank it came from and sums what arrives (``_Halo``'s
    backward); the backward sends the cotangent out as ``_Halo``'s forward
    does, one segment's gradient per shift."""

    @staticmethod
    def forward(ctx, ring, shifts, *segments):
        ctx.ring, ctx.shifts = ring, shifts
        return _send_back(ring, shifts, segments)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *_exchange(ctx.ring, [(s, grad.contiguous()) for s in ctx.shifts]))


def halo_exchange(ring: Ring, x: torch.Tensor, shifts=(1, -1)) -> Tuple[torch.Tensor, ...]:
    """``x`` of the ranks ``shifts`` places back around the ring (shift +1:
    the left neighbour's, -1: the right one's), differentiable in x."""
    return _Halo.apply(ring, tuple(shifts), x)


def reverse_halo(ring: Ring, segments: Sequence[torch.Tensor], shifts=(1, -1)) -> torch.Tensor:
    """Per-row sums over the halo segments that ``halo_exchange(ring, x,
    shifts)`` delivered, returned to the rows' owners and summed there
    (the segment of shift +1 goes back to the left neighbour);
    differentiable."""
    return _ReverseHalo.apply(ring, tuple(shifts), *segments)


def _all_reduce(ring: Ring, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if ring.group is not None:
        dist.all_reduce(x, op=op, group=ring.group)
    return x


def _all_gather(ring: Ring, x: torch.Tensor) -> torch.Tensor:
    """(ring size, L): every slab's 1-D x in ring order, on every rank, in one
    ``all_gather_into_tensor``."""
    if ring.group is None:
        return x[None]
    send = x.detach().cpu() if _staged(ring, x) else x.detach().contiguous()
    out = send.new_empty((ring.size * send.numel(),))
    dist.all_gather_into_tensor(out, send, group=ring.group)
    return out.view(ring.size, -1).to(x.device)


# ---------------------------------------------------------------------------
# the local search
# ---------------------------------------------------------------------------

def _masked_cell_table(position: torch.Tensor, valid: torch.Tensor, grid: nb.Grid,
                       cell_cap: int):
    """Bin the valid rows of ``position`` (M, dim) into (cells, C) tables of
    row indices (fill M) and positions (fill 1e9); a row ranks in its cell
    by index (a stable sort). Returns (table, table_pos, overflow)."""
    m, dim = position.shape
    dev = position.device
    cid = nb._flatten_coords(nb._cell_coords(position, grid), grid)
    cid = torch.where(valid, cid, grid.num_cells)
    cid_sorted, order = torch.sort(cid, stable=True)
    rank = torch.arange(m, device=dev) - torch.searchsorted(cid_sorted, cid_sorted, side="left")
    binned = cid_sorted < grid.num_cells
    overflow = ((rank >= cell_cap) & binned).any()
    spare = grid.num_cells * cell_cap  # rows past capacity land here and drop
    slots = torch.where((rank < cell_cap) & binned, cid_sorted * cell_cap + rank, spare)
    table = torch.full((spare + 1,), m, dtype=torch.int32, device=dev)
    table.scatter_(0, slots, order.to(torch.int32))
    table_pos = torch.full((spare + 1, dim), 1e9, dtype=position.dtype, device=dev)
    table_pos.scatter_(0, slots[:, None].expand(-1, dim), position[order])
    return (table[:spare].view(grid.num_cells, cell_cap),
            table_pos[:spare].view(grid.num_cells, cell_cap, dim), overflow)


def _min_image(diff: torch.Tensor, grid: nb.Grid) -> torch.Tensor:
    """Min-image on the grid's periodic axes, plain differences on the others."""
    pbc = torch.as_tensor(grid.pbc, device=diff.device)
    box_l = torch.as_tensor([s * c for s, c in zip(grid.cell_size, grid.cells_per_side)],
                            dtype=diff.dtype, device=diff.device)
    return torch.where(pbc, diff - box_l * torch.floor(diff / box_l + 0.5), diff)


def _local_cell_nl(recv_pos: torch.Tensor, recv_valid: torch.Tensor, cand_pos: torch.Tensor,
                   cand_valid: torch.Tensor, grid: nb.Grid, cell_cap: int, k_cap: int,
                   cutoff: float):
    """Cell-table radius search of the slab's receivers (N_loc, dim) against
    its candidates (M, dim), both in the local frame. Returns (senders
    (N_loc, K) int32 rows of the candidates, fill M; edge_valid; overflow)."""
    n_loc, dim = recv_pos.shape
    m = cand_pos.shape[0]
    dev = recv_pos.device
    table, table_pos, cell_overflow = _masked_cell_table(cand_pos, cand_valid, grid, cell_cap)
    cps = torch.as_tensor(grid.cells_per_side, device=dev)
    offsets = torch.as_tensor(grid.offsets, device=dev)  # (S, dim)
    pbc = torch.as_tensor(grid.pbc, device=dev)
    ncoords = nb._cell_coords(recv_pos, grid)[:, None, :] + offsets  # (N, S, dim)
    in_range = (pbc | ((ncoords >= 0) & (ncoords < cps))).all(dim=-1)
    ncell = nb._flatten_coords(torch.remainder(ncoords, cps), grid)  # (N, S)
    cand = torch.where(in_range[..., None], table[ncell], m)  # (N, S, C)
    diff = _min_image(recv_pos[:, None, None, :] - table_pos[ncell], grid)
    mask = (nb._dist2(diff) <= cutoff * cutoff) & (cand < m) & recv_valid[:, None, None]
    s, c = cand.shape[1], cand.shape[2]
    senders, row_overflow = nb._dense_select(cand.reshape(1, n_loc, s * c),
                                             mask.reshape(1, n_loc, s * c), k_cap, m)
    senders = senders[0]
    return senders, senders < m, cell_overflow | row_overflow[0]


# ---------------------------------------------------------------------------
# the spatial cores: slab geometry around the port's models
# ---------------------------------------------------------------------------

def _dtype(compute_dtype) -> torch.dtype:
    return getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype


def _stat(stats, kind: str, what: str, dtype, device) -> torch.Tensor:
    return torch.as_tensor(stats[kind][what]).to(device=device, dtype=dtype)


class _SpatialBase:
    """Slab geometry, halo and local search around one port model (its
    parameters are the model's; several cores may share one model)."""

    def __init__(self, ring: Ring, model: nn.Module, *, box, cutoff, input_seq_length, k_cap,
                 cell_cap, stats):
        self.ring = ring
        self.n_dev = ring.size
        self.model = model
        self.cdt = _dtype(model.compute_dtype)
        self.pos_dtype = torch.float64 if self.cdt == torch.float64 else torch.float32
        self.device = next(model.parameters()).device
        self.box_np = np.asarray(box, np.float64).reshape(-1)
        self.box = torch.as_tensor(self.box_np, dtype=self.pos_dtype, device=self.device)
        # velocities, targets and integration take the min-image of the
        # case (``ops/space.py``), as the unsharded path does: in float32 a
        # velocity is a difference of near-equal positions, and another
        # rounding of its min-image moves it by ~1e-5 of its size
        self.displacement, self.shift = space.periodic(self.box)
        self.box_x = float(self.box_np[0])
        self.slab_w = self.box_x / self.n_dev
        if self.slab_w < cutoff:
            raise ValueError(f"slab width {self.slab_w:.4f} below the cutoff {cutoff}: a one-slab "
                             "halo is not enough; use fewer slabs or a larger box")
        self.cutoff = float(cutoff)
        self.isl = int(input_seq_length)
        self.k_cap = int(k_cap)
        self.cell_cap = int(cell_cap)
        self.vel_mean, self.vel_std, self.acc_mean, self.acc_std = (
            _stat(stats, kind, what, self.pos_dtype, self.device)
            for kind in ("velocity", "acceleration") for what in ("mean", "std"))
        # the local frame: [0, 3w] and not periodic in x for n >= 3; the
        # periodic box for n <= 2 (each candidate appears once)
        if self.n_dev >= 3:
            gbox = [3.0 * self.slab_w] + list(self.box_np[1:])
            pbc = [False] + [True] * (len(self.box_np) - 1)
        else:
            gbox, pbc = list(self.box_np), [True] * len(self.box_np)
        grid = nb.make_grid(gbox, cutoff, pbc)
        if grid is None:
            raise ValueError(f"spatial sharding needs a cell grid: box {gbox} with cutoff "
                             f"{cutoff} has fewer than 3 cells on a periodic axis")
        self.grid = grid

    # ---- geometry --------------------------------------------------------
    def _local_frame_x(self, x: torch.Tensor, owner_offset: int) -> torch.Tensor:
        """x in the local frame for a segment owned by the rank
        ``owner_offset`` places on: base + centered-mod(x - owner * w)."""
        w = self.slab_w
        owner = (self.ring.index + owner_offset) % self.n_dev
        delta = x - owner * w
        delta = delta - self.box_x * torch.round(delta / self.box_x)
        return (1 + owner_offset) * w + delta

    def _with_x(self, p: torch.Tensor, owner_offset: int) -> torch.Tensor:
        return torch.cat([self._local_frame_x(p[:, :1], owner_offset), p[:, 1:]], dim=1)

    def _candidates(self, most_recent: torch.Tensor, count: torch.Tensor):
        """The receivers and the candidates (own slab, then the left and the
        right halo) in the local frame: (recv_pos, cand_pos, cand_valid)."""
        n_loc = most_recent.shape[0]
        slot = torch.arange(self.n_dev * n_loc if self.n_dev <= 2 else 3 * n_loc,
                            device=self.device)
        if self.n_dev >= 3:
            gl, gr, cl, cr = _exchange(self.ring, [(1, most_recent), (-1, most_recent),
                                                   (1, count), (-1, count)])
            own = self._with_x(most_recent, 0)
            cand_pos = torch.cat([own, self._with_x(gl, -1), self._with_x(gr, 1)])
            seg = torch.where(slot < n_loc, count, torch.where(slot < 2 * n_loc, cl, cr))
            return own, cand_pos, (slot % n_loc) < seg
        if self.n_dev == 2:
            other, cl = _exchange(self.ring, [(1, most_recent), (1, count)])
            seg = torch.where(slot < n_loc, count, cl)
            return most_recent, torch.cat([most_recent, other]), (slot % n_loc) < seg
        return most_recent, most_recent, slot < count

    @property
    def _shifts(self) -> Tuple[int, ...]:
        """The halo's ring shifts: the left and the right neighbour for n >= 3,
        the other rank for n == 2."""
        return (1, -1) if self.n_dev >= 3 else (1,) if self.n_dev == 2 else ()

    def _halo_concat(self, x: torch.Tensor) -> torch.Tensor:
        """Node rows extended to the candidate rows: [own, left, right]."""
        if self.n_dev == 1:
            return x
        return torch.cat([x, *halo_exchange(self.ring, x, self._shifts)])

    def _reverse_halo(self, buckets: torch.Tensor, n_loc: int) -> torch.Tensor:
        """(candidate rows, ...) sums -> (N_loc, ...) sums of the rows'
        owners: the halo segments' rows go home and add to the slab's own."""
        if self.n_dev == 1:
            return buckets
        segments = buckets[n_loc:].split(n_loc)
        return buckets[:n_loc] + reverse_halo(self.ring, segments, self._shifts)

    def _search(self, pos: torch.Tensor, count: torch.Tensor):
        """The slab's neighbor list: (recv_pos (N_loc, dim) and cand_pos (M,
        dim) in the local frame, senders clamped to the candidate rows
        (N_loc, K) int64, edge_valid, overflow)."""
        n_loc = pos.shape[0]
        most_recent = pos[:, self.isl - 1]
        recv_valid = torch.arange(n_loc, device=self.device) < count
        recv_pos, cand_pos, cand_valid = self._candidates(most_recent, count)
        senders, edge_valid, overflow = _local_cell_nl(
            recv_pos, recv_valid, cand_pos, cand_valid, self.grid, self.cell_cap, self.k_cap,
            self.cutoff)
        safe = torch.clamp(senders, max=cand_pos.shape[0] - 1).long()
        return recv_pos, cand_pos, safe, edge_valid, overflow

    def _graph(self, pos: torch.Tensor, count: torch.Tensor):
        """The slab's neighbor list and edge geometry: (senders clamped to the
        candidate rows (N_loc, K) int64, edge_valid, rel_disp (N_loc, K, dim)
        receiver - sender over the cutoff in the local frame, zero on padded
        slots, overflow)."""
        recv_pos, cand_pos, safe, edge_valid, overflow = self._search(pos, count)
        diff = _min_image(recv_pos[:, None, :] - cand_pos[safe], self.grid)
        rel_disp = torch.where(edge_valid[..., None], diff / self.cutoff, torch.zeros_like(diff))
        return safe, edge_valid, rel_disp, overflow

    def _vel_norm(self, pos: torch.Tensor) -> torch.Tensor:
        """The normalized velocity history (N_loc, isl - 1, dim)."""
        d = self.displacement(pos[:, 1:self.isl], pos[:, :self.isl - 1])
        return (d - self.vel_mean) / self.vel_std

    def forward(self, pos: torch.Tensor, ptype: torch.Tensor, count) -> Tuple[torch.Tensor,
                                                                               torch.Tensor]:
        """pos (N_loc, T, dim), this rank's window (the first isl frames are
        read); ptype (N_loc,); count, the slab's real particles. Returns
        (normalized acceleration (N_loc, dim), local overflow flag)."""
        pos = torch.as_tensor(pos, device=self.device).to(self.pos_dtype)
        ptype = torch.as_tensor(ptype, device=self.device)
        count = torch.as_tensor(count, device=self.device).reshape(1).to(torch.int64)
        return self._forward(pos, ptype, count)


class _SpatialGNS(_SpatialBase):
    """The fused GNS over the slab: ``GNS.encode_nodes``, ``GNS.process``
    with the sender rows gathered from the halo-extended projection (K3;
    K4 in the backward) and the decoder."""

    def _forward(self, pos, ptype, count):
        g = self.model
        n_loc = pos.shape[0]
        safe, edge_valid, rel_disp, overflow = self._graph(pos, count)
        vel_n = self._vel_norm(pos)
        nodes = vel_n.reshape(n_loc, -1)
        # the encoder's input width says whether the checkpoint was trained
        # with magnitude features (vel_hist [+ vel_mag] [+ embedding])
        emb_w = g.embedding.shape[1] if g.num_particle_types > 1 else 0
        if g.node_encoder.layers[0].in_features == nodes.shape[-1] + (self.isl - 1) + emb_w:
            nodes = torch.cat([nodes, torch.linalg.vector_norm(vel_n, dim=-1)], dim=-1)
        h = g.encode_nodes(nodes, ptype)
        rel_dist = torch.sqrt(torch.sum(rel_disp**2, dim=-1, keepdim=True))
        # the raw edge features in the compute dtype, as the JAX spatial GNS
        # casts them before the encoder; K3 takes them in float32 (float64)
        raw = torch.cat([rel_disp, rel_dist], dim=-1).to(self.cdt).to(
            torch.float64 if self.cdt == torch.float64 else torch.float32)
        h = g.process(h, raw.contiguous(), safe, edge_valid.to(torch.float32),
                      extend=self._halo_concat)
        return g.decoder(h, self.cdt).to(self.pos_dtype), overflow


class _SpatialPaiNN(_SpatialBase):
    """The fused PaiNN over the slab: ``PaiNN.embed``, each layer's K5 on the
    halo-extended (3 N_loc, (2 + dim) H) rows, ``PaiNN.read_out``. The RBF and
    cutoff radius is the model's (1.5 x the connectivity radius, applied to
    radius-normalized distances, as ``build_painn`` sets it)."""

    def _forward(self, pos, ptype, count):
        p = self.model
        cdt = self.cdt
        n_loc = pos.shape[0]
        safe, edge_valid, rel_disp, overflow = self._graph(pos, count)
        norm_ij = torch.sqrt(torch.sum(rel_disp**2, dim=-1) + EPS)
        dir_ij = rel_disp / (norm_ij[..., None] + EPS)
        phi = p.rbf(norm_ij).to(cdt)
        scale = cosine_cutoff(norm_ij, p.radius).to(cdt) * edge_valid.to(cdt)
        phi_ext = torch.cat([phi, scale[..., None]], dim=-1).contiguous()
        vel_n = self._vel_norm(pos)  # (N, n_vels, dim)
        s, v = p.embed(torch.linalg.vector_norm(vel_n, dim=-1), vel_n.transpose(1, 2))
        v = v.reshape(n_loc, -1)
        # K5's source rows: the slab's, then its halo slabs' (one or two)
        sidx = painn_msg.sender_index(safe, min(self.n_dev, 3) * n_loc)
        dir_c = dir_ij.to(cdt)
        for layer in p.layers:
            s, v = layer(s, v, dir_c, phi_ext, sidx, None, cdt, extend=self._halo_concat)
        acc = p.read_out(s, v.reshape(n_loc, -1, p.hidden_size))
        return acc.to(self.pos_dtype), overflow


class _SpatialSEGNN(_SpatialBase):
    """The port's SEGNN over the slab, its steerable math not restated: the
    features and attributes of ``SEGNN.forward`` (the 2D -> 3D lift, the
    node attributes with the mean of the edge harmonics over the valid
    slots), ``SEGNN.embed``, each ``SEGNNLayer`` with the senders on the
    halo-extended node rows and an explicit edge mask, the decoder gates
    and the output product. The halo exchanges the whole (N_loc, dim) node
    tensor once per layer (JAX: each m-part on its own; the rows are the
    same). Instance norm needs statistics over all nodes and is refused."""

    def __init__(self, ring, model, **kw):
        if any(layer.norm == "instance" for layer in model.layers):
            raise ValueError("spatial SEGNN does not support instance norm (it needs "
                             "statistics over every node of the system)")
        super().__init__(ring, model, **kw)

    def _forward(self, pos, ptype, count):
        m = self.model
        n_loc, dim = pos.shape[0], pos.shape[-1]
        nv = m.n_vels
        safe, edge_valid, rel_disp, overflow = self._graph(pos, count)
        rel_dist = torch.sqrt(torch.sum(rel_disp**2, dim=-1, keepdim=True))
        vel3, rel_disp3 = self._vel_norm(pos), rel_disp
        if dim == 2:
            vel3 = torch.nn.functional.pad(vel3, (0, 1))
            rel_disp3 = torch.nn.functional.pad(rel_disp, (0, 1))

        # the attributes of SEGNN._attributes, the mean over the valid slots
        if nv == 1:
            vel_agg = vel3[:, 0]
        elif m.velocity_aggregate == "avg":
            vel_agg = vel3.mean(dim=1)
        else:
            vel_agg = vel3[:, -1]
        edge_attr = m.sh(rel_disp3)
        maskf = edge_valid[..., None].to(edge_attr.dtype)
        scattered = torch.sum(edge_attr * maskf, dim=1) / torch.clamp(maskf.sum(dim=1), min=1.0)
        node_attr = m.sh(vel_agg) + scattered
        node_attr = torch.cat([torch.ones_like(node_attr[:, :1]), node_attr[:, 1:]], dim=-1)
        node_attributes = IrrepsArray(m.attribute_irreps, node_attr)
        edge_attributes = IrrepsArray(m.attribute_irreps, edge_attr)

        # node features of a periodic box: the velocities [+ their
        # magnitudes] [+ the type one-hot]
        feats = [vel3.reshape(n_loc, nv * 3)]
        irreps = m.node_features_irreps
        types = 0 if m.homogeneous_particles else NodeType.SIZE
        if irreps.count("0e") >= nv + types:
            feats.append(torch.linalg.vector_norm(vel3, dim=-1))
        if not m.homogeneous_particles:
            feats.append((ptype[:, None] == torch.arange(NodeType.SIZE, device=self.device))
                         .to(vel3.dtype))
        if irreps.dim != sum(f.shape[-1] for f in feats):
            raise ValueError(f"spatial SEGNN takes velocity [+ magnitude] [+ type] node features; "
                             f"the model expects {irreps} ({irreps.dim} values)")
        nodes = m.embed(from_mul_major(irreps, torch.cat(feats, dim=-1)), node_attributes)
        edge_feats = IrrepsArray(EDGE_IRREPS, torch.cat([rel_disp3, rel_dist], dim=-1))

        receivers = torch.arange(n_loc, device=self.device)[:, None].expand_as(safe)
        for layer in m.layers:
            ext = IrrepsArray(nodes.irreps, self._halo_concat(nodes.array))
            nodes = layer(nodes, node_attributes, edge_attributes, edge_feats, safe, safe,
                          receivers, sender_nodes=ext, edge_mask=edge_valid)
        x = nodes
        for block in m.decoder:
            x = block(x, node_attributes)
        acc = m.out(x, node_attributes).array[:, :dim]
        return acc.to(self.pos_dtype), overflow


class _SpatialEGNN(_SpatialBase):
    """The port's EGNN over the slab: ``EGNN.embed`` and each ``EGNNLayer``
    on halo-extended sender rows. Positions move per layer, so the halo
    carries the accumulated position delta with ``h`` (one exchange of the
    two, concatenated) and the senders' positions are the candidates'
    layer-0 positions plus their owners' deltas; the position terms sum
    into their senders, over the candidate rows, and the reverse halo
    returns the halo rows' sums to their owners. Positions stay in the
    local frame (plain differences in x, min-image on the periodic axes, no
    wrap within a forward). Returns the normalized acceleration."""

    def __init__(self, ring, model, **kw):
        h = model.embed.out_features
        if model.embed.in_features != model.n_vels or any(
                layer.upd.layers[0].in_features != 2 * h for layer in model.layers):
            raise ValueError("spatial EGNN supports homogeneous particles without an external "
                             "force: the embedding takes the velocity magnitudes only")
        super().__init__(ring, model, **kw)

    def _forward(self, pos, ptype, count):
        m = self.model
        n_loc = pos.shape[0]
        recv_pos, cand_pos, safe, edge_valid, overflow = self._search(pos, count)
        n_cand = cand_pos.shape[0]
        pbc = torch.as_tensor(self.grid.pbc, device=self.device)
        box_l = torch.as_tensor([s * c for s, c in zip(self.grid.cell_size,
                                                       self.grid.cells_per_side)],
                                dtype=self.pos_dtype, device=self.device)

        def disp(a, b):
            d = a - b
            return torch.where(pbc, d - box_l * torch.round(d / box_l), d)

        def shift(p, dp):
            return p + dp

        diff0 = disp(cand_pos[safe], recv_pos[:, None, :])
        rel_dist = torch.sqrt(torch.sum((diff0 / self.cutoff) ** 2, dim=-1, keepdim=True))
        rel_dist = torch.where(edge_valid[..., None], rel_dist, torch.zeros_like(rel_dist))
        vel_n = self._vel_norm(pos)
        h = m.embed(torch.sqrt(torch.sum(vel_n**2, dim=-1) + 1e-16), m.compute_dtype)
        stats = {k: torch.as_tensor(v, device=self.device).to(self.pos_dtype)
                 for k, v in m.velocity_stats.items()}
        prev_vel = vel_n[:, -1] * stats["std"] + stats["mean"]

        def sender_scatter(trans, senders):
            return self._reverse_halo(segment_sum(trans, senders, n_cand), n_loc)

        receivers = torch.arange(n_loc, device=self.device)[:, None].expand_as(safe)
        dpos = torch.zeros_like(recv_pos)
        width = h.shape[-1]
        for layer in m.layers:
            wide = torch.promote_types(h.dtype, dpos.dtype)
            ext = self._halo_concat(torch.cat([h.to(wide), dpos.to(wide)], dim=-1))
            h_ext, dpos_ext = ext[:, :width].to(h.dtype), ext[:, width:].to(dpos.dtype)
            h, new_pos = layer(h, recv_pos + dpos, prev_vel, safe, safe, receivers, rel_dist,
                               None, disp, shift, m.compute_dtype, sender_h=h_ext,
                               sender_pos=cand_pos + dpos_ext, edge_mask=edge_valid,
                               sender_scatter_fn=sender_scatter)
            dpos = new_pos - recv_pos
        acc = dpos - prev_vel
        return ((acc - self.acc_mean) / self.acc_std).to(self.pos_dtype), overflow


_CORES = {"gns": _SpatialGNS, "painn": _SpatialPaiNN, "segnn": _SpatialSEGNN,
          "egnn": _SpatialEGNN}


def _tree_of(params) -> Dict:
    return {k: (_tree_of(v) if isinstance(v, dict) else np.asarray(v)) for k, v in params.items()}


def spatial_model(model: str, params, num_mp_steps: Optional[int] = None, *,
                  compute_dtype=torch.float32, radius: Optional[float] = None,
                  cutoff: Optional[float] = None, model_def: Optional[nn.Module] = None,
                  device="cuda") -> nn.Module:
    """The port's module of ``model`` holding a JAX parameter tree (numpy
    leaves); parameters in float64 for a float64 compute dtype, else as
    built. The fused GNS or PaiNN is sized from the tree (either layout);
    SEGNN and EGNN need ``model_def``, the port's module built for the
    config (their shapes do not follow from the tree), into which the tree
    is loaded. An ``nn.Module`` passed as ``params`` passes through."""
    if isinstance(params, nn.Module):
        return params
    _check_model(model)
    device = resolve_device(device)
    cdt = _dtype(compute_dtype)
    name = str(cdt).split(".")[-1]
    tree = _tree_of(params)
    if model in ("segnn", "egnn"):
        if model_def is None:
            raise ValueError(f"spatial {model} needs the port's {model} module (model_def), "
                             "built for the config, to hold the parameter tree")
        net = model_def.double() if cdt == torch.float64 else model_def
        net.load_jax_params(tree)
        return net.to(device)
    if model == "gns":
        if not any(str(k).startswith("mp0_") for k in tree):
            tree = fused_params_from_standard(tree, num_mp_steps)
        emb = tree.get("Embed_0", {}).get("embedding")
        node_w = tree["MLP_0"]["Dense_0"]["kernel"].shape[0]
        net = GNS(
            particle_dimension=tree["MLP_1"]["Dense_1"]["kernel"].shape[1],
            node_in=node_w - (0 if emb is None else emb.shape[1]),
            edge_in=tree["enc_w1"].shape[0],
            latent_size=tree["MLP_0"]["Dense_1"]["kernel"].shape[1],
            num_mp_steps=num_mp_steps,
            particle_type_embedding_size=16 if emb is None else emb.shape[1],
            num_particle_types=1 if emb is None else emb.shape[0],
            compute_dtype=name, device="cpu")
    else:
        if "filt_w" not in tree.get("PaiNNLayer_0", {}):
            tree = painn_fused_params_from_standard(tree, num_mp_steps)
        s_emb = tree["LinearXav_0"]["Dense_0"]["kernel"]
        n_vels = s_emb.shape[0]
        extra = tree["LinearXav_1"]["Dense_0"]["kernel"].shape[0] - n_vels
        if extra:
            raise ValueError("spatial PaiNN takes the velocity channels only (a periodic box "
                             f"without an external force); the tree has {extra} more")
        net = PaiNN(hidden_size=s_emb.shape[1], num_mp_steps=num_mp_steps,
                    n_rbf=tree["GaussianRBF_0"]["offset"].shape[0],
                    radius=float(radius if radius is not None else 1.5 * cutoff),
                    n_vels=n_vels, fused=True, compute_dtype=name, device="cpu")
    if cdt == torch.float64:
        net = net.double()
    net.load_jax_params(tree)
    return net.to(device)


def standard_params(model: str, net: nn.Module) -> Dict:
    """The module's parameters as a standard-layout JAX tree (numpy), the
    layout spatial checkpoints are written in (SEGNN's and EGNN's have one
    layout)."""
    _check_model(model)
    params = net.jax_params()
    if model == "gns":
        return standard_params_from_fused(params, net.num_mp_steps)
    if model == "painn":
        return painn_standard_params_from_fused(params, net.num_mp_steps)
    return params


def _check_model(model: str) -> None:
    if model not in MODELS:
        raise ValueError(f"spatial sharding supports {'|'.join(MODELS)}, got {model}")


def _make_core(model: str, mesh, params, *, box, cutoff, input_seq_length, num_mp_steps, k_cap,
               cell_cap, stats, compute_dtype=torch.float32, radius=None, model_def=None,
               device="cuda"):
    """The spatial core of ``model`` (gns | painn | segnn | egnn) on this
    rank's ring of ``mesh``; ``params`` a JAX tree or the module to share
    (a tree of SEGNN or EGNN goes into ``model_def``)."""
    _check_model(model)
    net = spatial_model(model, params, num_mp_steps, compute_dtype=compute_dtype, radius=radius,
                        cutoff=cutoff, model_def=model_def, device=device)
    return _CORES[model](ring_of(mesh), net, box=box, cutoff=cutoff,
                         input_seq_length=input_seq_length, k_cap=k_cap, cell_cap=cell_cap,
                         stats=stats)


def _forward_stats(vel_mean, vel_std, acc_mean=None, acc_std=None) -> Dict:
    """A forward's normalization stats: the velocity's, and the
    acceleration's where the model reads them (EGNN; else mean 0, std 1)."""
    mean = torch.as_tensor(vel_mean)
    return {"velocity": {"mean": mean, "std": torch.as_tensor(vel_std)},
            "acceleration": {
                "mean": torch.zeros_like(mean) if acc_mean is None else torch.as_tensor(acc_mean),
                "std": torch.ones_like(mean) if acc_std is None else torch.as_tensor(acc_std)}}


def _build_forward(model: str, mesh, params, *, box, cutoff, input_seq_length, k_cap, vel_mean,
                   vel_std, num_mp_steps: Optional[int] = None, cell_cap: Optional[int] = None,
                   acc_mean=None, acc_std=None, compute_dtype=torch.float32,
                   radius: Optional[float] = None, model_def=None, device="cuda"):
    core = _make_core(model, mesh, params, box=box, cutoff=cutoff,
                      input_seq_length=input_seq_length, num_mp_steps=num_mp_steps, k_cap=k_cap,
                      cell_cap=cell_cap or 4 * k_cap,
                      stats=_forward_stats(vel_mean, vel_std, acc_mean, acc_std),
                      compute_dtype=compute_dtype, radius=radius, model_def=model_def,
                      device=device)

    @torch.no_grad()
    def forward(pos, ptype, count):
        acc, overflow = core.forward(pos, ptype, count)
        flag = _all_reduce(core.ring, overflow.to(torch.int32).reshape(1))
        return acc, bool(flag.item() > 0)

    forward.core = core
    return forward


def build_spatial_gns_forward(mesh, params, **kw):
    """Spatially sharded GNS forward over the slab ring of ``mesh``.

    Returns ``fn(pos, ptype, count) -> (acc (N_loc, dim), overflow)`` for
    this rank's slab (a row of :func:`spatial_partition`'s outputs: pos
    (N_loc, T, dim), ptype (N_loc,), the slab's count); ``overflow`` is
    summed over the ring. ``params`` is a GNS tree in either layout (or the
    module). Keywords: box, cutoff, input_seq_length, num_mp_steps, k_cap,
    vel_mean, vel_std, cell_cap (4 x k_cap), compute_dtype, device.
    ``fn.core`` is the core."""
    return _build_forward("gns", mesh, params, **kw)


def build_spatial_painn_forward(mesh, params, **kw):
    """Spatially sharded PaiNN forward: as :func:`build_spatial_gns_forward`,
    ``params`` a PaiNN tree in either layout and the keyword ``radius`` the
    model's RBF and cutoff radius (1.5 x ``cutoff`` by default)."""
    return _build_forward("painn", mesh, params, **kw)


def build_spatial_segnn_forward(mesh, params, model_def=None, **kw):
    """Spatially sharded SEGNN forward: as :func:`build_spatial_gns_forward`,
    ``params`` a SEGNN tree loaded into ``model_def`` (the port's SEGNN built
    for the config) or the module itself; no ``num_mp_steps``."""
    return _build_forward("segnn", mesh, params, model_def=model_def, **kw)


def build_spatial_egnn_forward(mesh, params, model_def=None, **kw):
    """Spatially sharded EGNN forward: as :func:`build_spatial_segnn_forward`
    with the port's EGNN, and the keywords ``acc_mean`` and ``acc_std``: it
    returns the normalized acceleration (the EGNN itself integrates
    positions)."""
    return _build_forward("egnn", mesh, params, model_def=model_def, **kw)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _local_counts(ptype: torch.Tensor, count) -> torch.Tensor:
    """This rank's non-kinematic real particles of each sample (B,)."""
    b, n_loc = ptype.shape
    valid = torch.arange(n_loc, device=ptype.device) < count.reshape(b, 1)
    return (valid & (ptype != 1) & (ptype != 2) & (ptype != -1)).sum(dim=1)


def _sample_loss_contrib(core: _SpatialBase, pos, ptype, count, gcnt, unroll: int = 0):
    """This rank's share of one sample's kinematic-masked acceleration MSE:
    its slab's squared errors over the global count ``gcnt`` (summed over
    the ring, the shares make the sample's loss).

    ``pos`` (N_loc, T, dim): without pushforward (``unroll == 0``) T is
    isl + 1 (isl model frames and the target frame); with it, the noised
    sequence (isl inputs, 1 + max_unroll target frames) followed by the raw
    isl-frame input window. The unrolls (no gradient) see the noised
    window first, integrate from the raw one and run on the pushed window;
    the target is the second finite difference of the noised sequence
    around frame isl - 1 + unroll (the reference's strats.py:112-161)."""
    isl = core.isl
    disp = core.displacement
    window = pos[:, :isl]
    overflow = torch.zeros((), dtype=torch.bool, device=core.device)
    if unroll > 0:
        with torch.no_grad():
            base = pos[:, -isl:]  # the raw window: the integration base
            for _ in range(unroll):
                acc_n, ovf = core._forward(window, ptype, count)
                overflow = overflow | ovf
                acc = core.acc_mean + acc_n * core.acc_std
                new_pos = core.shift(base[:, -1], disp(base[:, -1], base[:, -2]) + acc)
                base = torch.cat([base[:, 1:], new_pos[:, None]], dim=1)
                window = base
    acc_pred, ovf = core._forward(window, ptype, count)
    overflow = overflow | ovf
    cur_vel = disp(pos[:, isl - 1 + unroll], pos[:, isl - 2 + unroll])
    next_vel = disp(pos[:, isl + unroll], pos[:, isl - 1 + unroll])
    acc_t = (next_vel - cur_vel - core.acc_mean) / core.acc_std
    n_loc = pos.shape[0]
    valid = torch.arange(n_loc, device=core.device) < count
    non_kin = valid & (ptype != 1) & (ptype != 2) & (ptype != -1)
    per_node = torch.sum((acc_pred - acc_t) ** 2, dim=-1)
    local = torch.sum(torch.where(non_kin, per_node, torch.zeros_like(per_node)))
    return local / torch.clamp(gcnt, min=1.0), overflow


def _sum_over_mesh(params, loss: torch.Tensor, overflow: torch.Tensor, mesh):
    """Sum the loss, the overflow flag and the gradients of ``params`` over
    the mesh in one all-reduce of one flat buffer; the gradients become
    views of the sums. Returns (loss, overflow) as device tensors."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    dtype = params[0].dtype if params else loss.dtype
    flat = torch.cat([loss.detach().reshape(1).to(dtype), overflow.reshape(1).to(dtype)]
                     + [g.reshape(-1).to(dtype) for g in grads])
    if mesh.size > 1:
        dist.all_reduce(flat, group=mesh.group)
    offset = 2
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
        offset += p.numel()
    return flat[0], flat[1] > 0


def _batch_loss(core, samples, unroll: int, n_batch: int, grad: bool):
    """The summed shares of this rank's samples (pos, ptype, count each),
    over the global batch ``n_batch``; the global counts come first, in one
    all-reduce over the ring, outside autograd."""
    ptypes = torch.stack([ptype for _, ptype, _ in samples])
    counts = torch.stack([count for _, _, count in samples])
    gcnt = _all_reduce(core.ring, _local_counts(ptypes, counts).to(core.pos_dtype))
    total = torch.zeros((), dtype=core.pos_dtype, device=core.device)
    overflow = torch.zeros((), dtype=torch.bool, device=core.device)
    with torch.set_grad_enabled(grad):
        for (pos, ptype, count), g in zip(samples, gcnt):
            share, ovf = _sample_loss_contrib(core, pos, ptype, count, g, unroll)
            total = total + share
            overflow = overflow | ovf
    return total / n_batch, overflow


def _mesh_step(mesh, params, grad: bool, *, box, cutoff, input_seq_length, k_cap,
               normalization_stats, num_mp_steps: Optional[int] = None,
               cell_cap: Optional[int] = None, compute_dtype=torch.float32, model: str = "gns",
               radius: Optional[float] = None, model_def=None, device="cuda"):
    """``step(pos, ptype, count, unroll_steps=0) -> (loss, overflow)``: this
    rank's share of the loss (with ``grad`` its backward), summed with the
    overflow flag (and the gradients) over the mesh. One sample per call on
    a 1D mesh; this rank's rows of the batch on a 2D one. ``step.core`` is
    the core."""
    batched = isinstance(mesh, Mesh2D)
    core = _make_core(model, mesh, params, box=box, cutoff=cutoff,
                      input_seq_length=input_seq_length, num_mp_steps=num_mp_steps, k_cap=k_cap,
                      cell_cap=cell_cap or 4 * k_cap, stats=normalization_stats,
                      compute_dtype=compute_dtype, radius=radius, model_def=model_def,
                      device=device)
    leaves = list(core.model.parameters()) if grad else []

    def step(pos, ptype, count, unroll_steps: int = 0):
        samples = _as_samples(core, pos, ptype, count, batched)
        n_batch = len(samples) * (mesh.n_data if batched else 1)
        for p in leaves:
            p.grad = None
        loss, overflow = _batch_loss(core, samples, int(unroll_steps), n_batch, grad)
        if grad:
            loss.backward()
        return _sum_over_mesh(leaves, loss, overflow, mesh)

    step.core = core
    return step


def _as_samples(core, pos, ptype, count, batched: bool):
    dev = core.device
    pos = torch.as_tensor(pos, device=dev).to(core.pos_dtype)
    ptype = torch.as_tensor(ptype, device=dev)
    count = torch.as_tensor(count, device=dev).to(torch.int64)
    if not batched:
        return [(pos, ptype, count.reshape(1))]
    return [(pos[i], ptype[i], count[i].reshape(1)) for i in range(pos.shape[0])]


def build_spatial_gns_train_step(mesh, params, **kw):
    """Spatially sharded training step on the slab ring of a 1D ``mesh``,
    for ``model`` gns, painn, segnn or egnn (keywords: box, cutoff,
    input_seq_length, num_mp_steps, k_cap, normalization_stats, cell_cap,
    compute_dtype, model, radius, model_def, device).

    Returns ``(step, module)``. ``step(pos, ptype, count, unroll_steps=0) ->
    (loss, overflow)`` takes this rank's slab of one sample (pos (N_loc, T,
    dim) with T = isl + 1, or the pushforward layout of
    ``_sample_loss_contrib``), computes the global loss's share and its
    backward (K4 for GNS; the halo's backward routes the sender cotangents
    home) and sums loss, overflow and every gradient over the mesh: the
    gradients of the global loss are left in the module's ``.grad``.
    ``module`` is the port's model holding ``params`` (GNS and PaiNN fused;
    ``model_def`` for SEGNN and EGNN)."""
    step = _mesh_step(mesh, params, True, **kw)
    return step, step.core.model


def build_spatial_train_step_dp(mesh, params, **kw):
    """The training step over a 2D ``(data, space)`` mesh
    (:func:`~.mesh.make_mesh_2d`): each row's ring takes its share of the
    batch, ``step(pos (b_loc, N_loc, T, dim), ptype (b_loc, N_loc), counts
    (b_loc,), unroll_steps=0)`` with this rank's rows and slab; the loss is
    the batch mean of the per-sample losses, summed with the gradients over
    the whole mesh. Returns ``(step, module)``."""
    if not isinstance(mesh, Mesh2D):
        raise ValueError("build_spatial_train_step_dp needs a (data, space) mesh (make_mesh_2d)")
    step = _mesh_step(mesh, params, True, **kw)
    return step, step.core.model


def build_spatial_loss_fn(mesh, params, **kw):
    """The loss without gradients (in-training validation) on a 1D ring (one
    sample per call) or a 2D mesh (this rank's rows, as
    :func:`build_spatial_train_step_dp`): ``eval_fn(pos, ptype, count) ->
    (loss, overflow)``, summed over the mesh."""
    return _mesh_step(mesh, params, False, **kw)


# ---------------------------------------------------------------------------
# rollout
# ---------------------------------------------------------------------------

@torch.no_grad()
def _rollout_chunk(core: _SpatialBase, pos, ptype, count, n_steps: int, gt=None):
    """``n_steps`` semi-implicit Euler steps of this rank's slab. Positions
    are carried in the dtype of ``pos`` (float64 from the datasets, as the
    standard rollout carries them), the model reads them in its position
    dtype. Kinematic particles hold their position, or follow ``gt``
    (n_steps, N_loc, dim), the ground truth in slab order. Returns
    (predictions (n_steps, N_loc, dim), the last window, (overflow,
    drift)), both flags reduced over the ring in one all-reduce: drift means
    that ownership may have gone stale (2 x the largest x-drift since the
    chunk began plus the cutoff reached ``DRIFT_SHARE`` of the slab width)
    and the chunk must rerun."""
    dev = core.device
    cur = torch.as_tensor(pos, device=dev)
    displacement, shift = space.periodic(core.box.to(cur.dtype))
    ptype = torch.as_tensor(ptype, device=dev)
    count = torch.as_tensor(count, device=dev).reshape(1).to(torch.int64)
    if gt is not None:
        gt = torch.as_tensor(gt, device=dev).to(cur.dtype)
    n_loc = cur.shape[0]
    valid = torch.arange(n_loc, device=dev) < count
    wall = (ptype == 1) | (ptype == 2)
    kinematic, forced = (wall | ~valid)[:, None], (wall & valid)[:, None]
    x0 = cur[:, core.isl - 1, 0]
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    drift = torch.zeros((), dtype=cur.dtype, device=dev)
    preds = []
    for t in range(n_steps):
        acc_n, ovf = core._forward(cur.to(core.pos_dtype), ptype, count)
        acc = core.acc_mean + acc_n * core.acc_std
        most = cur[:, -1]
        new_pos = shift(most, displacement(most, cur[:, -2]) + acc)
        new_pos = torch.where(kinematic, most, new_pos)
        if gt is not None:
            new_pos = torch.where(forced, gt[t], new_pos)
        cur = torch.cat([cur[:, 1:], new_pos[:, None]], dim=1)
        dx = new_pos[:, 0] - x0
        dx = dx - core.box_x * torch.round(dx / core.box_x)
        drift = torch.maximum(drift, torch.max(torch.where(valid, dx.abs(), torch.zeros_like(dx))))
        overflow = overflow | ovf
        preds.append(new_pos)
    flags = _all_reduce(core.ring, torch.stack([overflow.to(drift.dtype), drift]),
                        op=dist.ReduceOp.MAX).tolist()
    return (torch.stack(preds), cur,
            (flags[0] > 0, 2 * flags[1] + core.cutoff >= core.slab_w * DRIFT_SHARE))


def build_spatial_gns_rollout(mesh, params, *, box, cutoff, input_seq_length, num_mp_steps,
                              k_cap, cell_cap, normalization_stats, compute_dtype=torch.float32,
                              model: str = "gns", radius: Optional[float] = None,
                              model_def=None, device="cuda"):
    """A chunk of rollout on the slab ring of ``mesh``: returns ``run(pos,
    ptype, count, n_steps, gt=None) -> (preds (n_steps, N_loc, dim), window,
    (overflow, drift))`` for this rank's slab (see ``_rollout_chunk``);
    ``run.core`` is the core, whose ``k_cap`` and ``cell_cap`` may be
    raised between calls."""
    core = _make_core(model, mesh, params, box=box, cutoff=cutoff,
                      input_seq_length=input_seq_length, num_mp_steps=num_mp_steps, k_cap=k_cap,
                      cell_cap=cell_cap, stats=normalization_stats,
                      compute_dtype=compute_dtype, radius=radius, model_def=model_def,
                      device=device)

    def run(pos, ptype, count, n_steps: int, gt=None):
        return _rollout_chunk(core, pos, ptype, count, int(n_steps), gt)

    run.core = core
    return run


def _escalate(cap: int) -> int:
    return -(-int(cap * 1.5) // 8) * 8


def spatial_rollout(params, pos: np.ndarray, ptype: np.ndarray, *, mesh, box, cutoff,
                    input_seq_length, num_mp_steps, n_steps: int, normalization_stats,
                    chunk: int = 25, multiplier: float = 1.25, compute_dtype=torch.float32,
                    max_retries: int = 8, model: str = "gns",
                    target: Optional[np.ndarray] = None, radius: Optional[float] = None,
                    model_def=None, device="cuda") -> np.ndarray:
    """A full spatially sharded rollout, every rank of the ring taking part.

    pos (N, input_seq_length, dim), the initial window in global order, the
    same on every rank; returns the predicted positions (n_steps, N, dim)
    in the original particle order, on every rank, in the dtype of ``pos``
    (positions are carried in it, as the standard rollout does). ``target`` (n_steps, N,
    dim): the ground truth onto which kinematic particles (walls, moving
    walls) are forced each step (the reference's
    lagrangebench/evaluate/rollout.py:64-69); without it they hold their
    position. ``params``: a JAX tree (SEGNN's and EGNN's loaded into
    ``model_def``) or the module (a trainer's live one).

    On a neighbor-capacity overflow the caps grow x1.5 and the chunk
    reruns; on drift the chunk reruns from its start at half its length.
    After each chunk every slab's predictions and window are gathered
    (padded to N_loc, one ``all_gather_into_tensor``) and the next chunk
    partitions afresh.
    """
    k_cap, cell_cap = spatial_caps(np.asarray(pos)[:, -1], box, cutoff, multiplier)
    run = build_spatial_gns_rollout(mesh, params, box=box, cutoff=cutoff,
                                    input_seq_length=input_seq_length,
                                    num_mp_steps=num_mp_steps, k_cap=k_cap, cell_cap=cell_cap,
                                    normalization_stats=normalization_stats,
                                    compute_dtype=compute_dtype, model=model, radius=radius,
                                    model_def=model_def, device=device)
    core = run.core
    ring = core.ring
    cur = np.array(pos)
    n, dim = cur.shape[0], cur.shape[-1]
    out = np.zeros((n_steps, n, dim), cur.dtype)
    done, retries = 0, 0
    while done < n_steps:
        pos_sh, ptype_sh, counts, order = spatial_partition(cur, ptype, ring.size, core.box_x)
        d, n_loc = ring.index, pos_sh.shape[1]
        steps = min(chunk, n_steps - done)
        gt = None
        if target is not None:
            gt = np.zeros((steps, n_loc, dim), cur.dtype)
            gt[:, :counts[d]] = target[done:done + steps, _slab_rows(counts, order, d)]
        preds, window, (overflow, drift) = run(pos_sh[d], ptype_sh[d], counts[d], steps, gt)
        if overflow:
            retries += 1
            if retries > max_retries:
                raise RuntimeError("spatial rollout: capacity escalation failed")
            core.k_cap, core.cell_cap = _escalate(core.k_cap), _escalate(core.cell_cap)
            continue
        if drift and steps > 1:
            retries += 1
            if retries > max_retries:
                raise RuntimeError("spatial rollout: drift retry failed")
            chunk = max(1, steps // 2)
            continue
        retries = 0
        flat = torch.cat([preds.reshape(-1), window.reshape(-1)])
        every = _all_gather(ring, flat).cpu().numpy()
        split = preds.numel()
        for r in range(ring.size):
            rows = _slab_rows(counts, order, r)
            c = rows.size
            out[done:done + steps, rows] = every[r, :split].reshape(steps, n_loc, dim)[:, :c]
            cur[rows] = every[r, split:].reshape(n_loc, -1, dim)[:c]
        done += steps
    return out


# ---------------------------------------------------------------------------
# the runner's entry points
# ---------------------------------------------------------------------------

def _data_rows(batch: int, world: int, n_space: int) -> int:
    """The data rows of a spatial training mesh: the largest divisor of the
    batch that is at most ``world // n_space``."""
    for d in range(min(batch, world // n_space), 0, -1):
        if batch % d == 0:
            return d
    return 1


def _rank_block(mesh, arrays, batch: int):
    """This rank's block of globally partitioned arrays (B, n_space, N_loc,
    ...): its rows of the batch and its slab; a batch of one drops the
    batch axis."""
    if batch == 1:
        return tuple(a[0, mesh.rank] for a in arrays)
    b_loc = batch // mesh.n_data
    rows = slice(mesh.data_index * b_loc, (mesh.data_index + 1) * b_loc)
    return tuple(a[rows, mesh.space_index] for a in arrays)


def train_spatial(params, case, data_train, data_valid, *, n_devices: int, model: str,
                  num_mp_steps: int, cfg_train, cfg_logging, input_seq_length: int, metadata,
                  seed: int = 0, step_max: Optional[int] = None, store_ckp: Optional[str] = None,
                  compute_dtype=torch.float32, multiplier: float = 1.25,
                  load_ckp: Optional[str] = None, n_rollout_steps_val: int = 20,
                  n_trajs_val: int = 2, model_def: Optional[nn.Module] = None, device="cuda"):
    """Spatially sharded training (``parallel.spatial: N``).

    Every step runs the halo-exchange train step over an N-slab ring; with
    ``train.batch_size > 1`` the batch shards over the rows of a 2D
    ``(data, space)`` mesh, n_data the largest divisor of the batch that is
    at most (ranks // N). Every rank loads the same batches and draws the
    same noise (three numpy Generators: noise ``seed``, loader ``seed + 2``,
    pushforward ``seed + 3``) and takes its block. Carried over from the
    standard trainer: resume from a standard-layout checkpoint (``load_ckp``:
    parameters, AdamW state where its layout matches, step), loss-only
    validation with capacities of its own, best-model selection by the
    validation rollout MSE (``n_trajs_val`` rollouts of
    ``n_rollout_steps_val`` steps), the pushforward curriculum (the unroll
    count sampled per step, no gradient through it), GNS noise drawn on the
    host. Rank 0 prints and writes the checkpoints, in the standard layout.
    ``model``: gns, painn, segnn or egnn; SEGNN and EGNN train
    ``model_def``, the port's module built for the config, which takes
    ``params``.

    Returns (standard-layout parameters, state, optimizer); a rank outside
    the mesh returns (None, {}, None).
    """
    from ..checkpoint import load_checkpoint, save_checkpoint
    from ..data import DataLoader, cycle
    from ..train.strats import push_forward_sample_steps
    from ..train.trainer import AdamW, exponential_decay

    isl = input_seq_length
    _require_periodic(metadata, "train_spatial")
    _check_model(model)
    bounds = np.asarray(metadata["bounds"], np.float64)
    box = (bounds[:, 1] - bounds[:, 0]).tolist()
    cutoff = float(metadata["default_connectivity_radius"])
    batch = int(cfg_train.batch_size)
    noise_std = float(cfg_train.noise_std)
    step_max = int(step_max if step_max is not None else cfg_train.step_max)
    lw = cfg_train.get("loss_weight", None)
    if lw is not None and (float(lw.get("pos", 0)) != 0 or float(lw.get("vel", 0)) != 0):
        print("WARNING: spatial training optimizes the acceleration MSE; "
              "train.loss_weight pos/vel components are ignored.")
    # separate Generators: the loader shuffles in its prefetch thread
    rng_noise = np.random.default_rng(seed)
    rng_loader = np.random.default_rng(seed + 2)
    rng_push = np.random.default_rng(seed + 3)
    pushforward = cfg_train.get("pushforward", None)
    max_unroll = int(max(pushforward.unrolls)) if pushforward else 0

    world, _ = _world()
    if world < n_devices:
        raise ValueError(f"parallel.spatial={n_devices} needs {n_devices} ranks, {world} "
                         f"running; {launch_hint(n_devices)}")
    mesh = (make_mesh_2d(_data_rows(batch, world, n_devices), n_devices) if batch > 1
            else make_mesh(n_devices))
    if not mesh.member:
        return None, {}, None
    main = mesh.rank == 0

    step_start, opt_leaves = 0, None
    if load_ckp is not None:
        params, _, opt_leaves, ckp_step = load_checkpoint(load_ckp)
        step_start = int(ckp_step) + 1
    net = spatial_model(model, params, num_mp_steps, compute_dtype=compute_dtype,
                        cutoff=cutoff, model_def=model_def, device=device)
    stats = case.normalization_stats
    pos0 = np.asarray(data_train[0][0])
    k_cap, cell_cap = spatial_caps(pos0[:, isl - 1], box, cutoff, multiplier)
    common = dict(box=box, cutoff=cutoff, input_seq_length=isl, num_mp_steps=num_mp_steps,
                  normalization_stats=stats, compute_dtype=compute_dtype, model=model,
                  device=device)
    builder = build_spatial_train_step_dp if batch > 1 else build_spatial_gns_train_step
    step_fn, _ = builder(mesh, net, k_cap=k_cap, cell_cap=cell_cap, **common)
    # validation has capacities of its own: its escalations never grow the
    # training buffers
    eval_fn = build_spatial_loss_fn(mesh, net, k_cap=k_cap, cell_cap=cell_cap, **common)

    opt = cfg_train.optimizer
    schedule = exponential_decay(float(opt.lr_start), float(opt.lr_decay_steps),
                                 float(opt.lr_decay_rate), end_value=float(opt.lr_final))
    optimizer = AdamW(net.jax_leaves(), schedule, weight_decay=1e-8)
    if opt_leaves is not None:
        try:
            optimizer.load_state_leaves(opt_leaves)
        except ValueError as e:
            # e.g. a checkpoint of the standard processor's layout
            if main:
                print(f"WARNING: optimizer state not restored ({e}); starting the optimizer "
                      f"fresh at step {step_start}.")

    def prepare(samples, noise: float, extra: int = 0):
        """Noise, partition and pad (pos, ptype) samples; with ``extra``
        pushforward frames the raw isl-frame input window goes after the
        noised frames. Returns this rank's block."""
        parts = []
        for pos, ptype in samples:
            pos = np.asarray(pos)[:, : isl + 1 + extra]
            if pos.shape[1] != isl + 1 + extra:
                raise ValueError(f"pushforward needs {isl + 1 + extra} frames per window, got "
                                 f"{pos.shape[1]}: load the dataset with "
                                 "extra_seq_length=max_unroll")
            ptype = np.asarray(ptype)
            raw_win = pos[:, :isl].copy() if extra > 0 else None
            pos = _host_gns_noise(rng_noise, pos, ptype, isl, noise, box)
            if extra > 0:
                pos = np.concatenate([pos, raw_win], axis=1)
            parts.append(spatial_partition(pos, ptype, n_devices, box[0]))
        n_loc = max(p[0].shape[1] for p in parts)

        def pad(a, fill=0):
            width = [(0, 0)] * a.ndim
            width[1] = (0, n_loc - a.shape[1])
            return np.pad(a, width, constant_values=fill)

        arrays = (np.stack([pad(p[0]) for p in parts]),
                  np.stack([pad(p[1], fill=-1) for p in parts]),
                  np.stack([p[2] for p in parts]))
        return _rank_block(mesh, arrays, batch)

    loader = cycle(DataLoader(data_train, batch_size=batch, shuffle=True, drop_last=True,
                              rng=rng_loader))
    if len(data_valid) < batch:
        raise ValueError(f"data_valid has {len(data_valid)} samples; spatial training "
                         f"evaluates batches of {batch}")
    loader_valid = cycle(DataLoader(data_valid, batch_size=batch, drop_last=True,
                                    rng=np.random.default_rng(seed + 1)))

    def split_batch(raw):
        if batch > 1:
            return list(zip(np.asarray(raw[0]), np.asarray(raw[1])))
        return [(raw[0][0], raw[1][0])]

    def val_rollout_mse():
        """The validation rollouts' plain position MSE (MetricsComputer's
        "mse"), each data row on its own ring."""
        mses = []
        for i in range(min(n_trajs_val, len(data_valid))):
            vpos, vptype = data_valid[i]
            vpos = np.asarray(vpos)
            horizon = vpos.shape[1] - isl
            if n_rollout_steps_val > 0:
                horizon = min(horizon, n_rollout_steps_val)
            if horizon < 1:
                continue
            tgt = vpos[:, isl:isl + horizon].transpose(1, 0, 2)
            preds = spatial_rollout(net, vpos[:, :isl], np.asarray(vptype), mesh=mesh, box=box,
                                    cutoff=cutoff, input_seq_length=isl,
                                    num_mp_steps=num_mp_steps, n_steps=horizon,
                                    normalization_stats=stats, compute_dtype=compute_dtype,
                                    model=model, target=tgt, device=device)
            mses.append(float(np.mean((preds - tgt) ** 2)))
        return float(np.mean(mses)) if mses else None

    log_steps, eval_steps = int(cfg_logging.log_steps), int(cfg_logging.eval_steps)
    step, retries = step_start, 0
    while step < step_max:
        unroll = push_forward_sample_steps(rng_push, step, pushforward) if pushforward else 0
        block = prepare(split_batch(next(loader)), noise_std, extra=max_unroll)
        loss, overflow = step_fn(*block, unroll_steps=unroll)
        if bool(overflow):
            retries += 1
            if retries > 8:
                raise RuntimeError("spatial training: capacity escalation failed")
            core = step_fn.core
            core.k_cap, core.cell_cap = _escalate(core.k_cap), _escalate(core.cell_cap)
            continue  # the update is dropped; the next batch retries
        retries = 0
        optimizer.step()
        optimizer.zero_grad()
        if step % log_steps == 0 and main:
            print(f"{step}, train/loss: {float(loss):.5f}.")
        if (step % eval_steps == 0 and step > 0) or step == step_max - 1:
            # the noise-free validation loss; on an overflow only the eval
            # capacities grow, so a truncated graph is never recorded
            vblock = prepare(split_batch(next(loader_valid)), 0.0)
            for _ in range(8):
                vloss, v_overflow = eval_fn(*vblock)
                if not bool(v_overflow):
                    break
                core = eval_fn.core
                core.k_cap, core.cell_cap = _escalate(core.k_cap), _escalate(core.cell_cap)
            else:
                raise RuntimeError("spatial training: validation capacity escalation failed")
            vloss = float(vloss)
            vroll = val_rollout_mse()
            if vroll is None:
                warnings.warn("spatial training: no validation trajectory long enough for a "
                              "rollout; best-model selection falls back to the one-step "
                              "validation loss")
                vroll = vloss
            if main:
                print(f"{step}, val/loss: {vloss:.6f}, val/rollout_mse: {vroll:.3e}.")
                if store_ckp is not None:
                    save_checkpoint(store_ckp, standard_params(model, net), {},
                                    {"step": step, "loss": vroll, "val_loss": vloss},
                                    opt_state=optimizer.state_leaves())
        step += 1
    return standard_params(model, net), {}, optimizer


def infer_spatial(params, case, data_test, *, n_devices: int, num_mp_steps: int,
                  cfg_eval_infer=None, n_rollout_steps: int = 20, compute_dtype=torch.float32,
                  model: str = "gns", model_def: Optional[nn.Module] = None, device="cuda",
                  mesh=None) -> Optional[Dict[str, Dict]]:
    """Spatially sharded inference over a test split (``parallel.spatial: N``
    in infer mode), on the first N ranks or on ``mesh``'s ring.

    Kinematic particles are forced to the ground truth each step, as in the
    standard ``infer``, and the metrics are computed on the gathered global
    trajectory with the standard ``MetricsComputer``. ``params`` of SEGNN
    and EGNN go into ``model_def`` (see :func:`spatial_model`). Returns the
    metrics per trajectory on every rank of the ring; None on a rank outside
    it.
    """
    from ..config import merge
    from ..defaults import defaults
    from ..evaluate.metrics import MetricsComputer
    from ..evaluate.rollout import _to_numpy

    cfg = merge(defaults.eval.infer, cfg_eval_infer or {})
    metadata = data_test.metadata
    _require_periodic(metadata, "infer_spatial")
    _check_model(model)
    if mesh is None:
        world, _ = _world()
        if world < n_devices:
            raise ValueError(f"parallel.spatial={n_devices} needs {n_devices} ranks, {world} "
                             f"running; {launch_hint(n_devices)}")
        mesh = make_mesh(n_devices)
    if not mesh.member:
        return None
    isl = data_test.input_seq_length
    bounds = np.asarray(metadata["bounds"], np.float64)
    box = bounds[:, 1] - bounds[:, 0]
    cutoff = float(metadata["default_connectivity_radius"])
    net = spatial_model(model, params, num_mp_steps, compute_dtype=compute_dtype,
                        cutoff=cutoff, model_def=model_def, device=device)
    metrics_computer = MetricsComputer(list(cfg.metrics), dist_fn=case.displacement,
                                       metadata=metadata, input_seq_length=isl,
                                       stride=cfg.metrics_stride)
    n_trajs = cfg.n_trajs if cfg.n_trajs != -1 else data_test.num_samples
    n_trajs = min(n_trajs, data_test.num_samples)
    out = {}
    for i in range(n_trajs):
        pos, ptype = data_test[i]
        pos = np.asarray(pos)
        n_steps = pos.shape[1] - isl
        if n_rollout_steps > 0:
            n_steps = min(n_steps, n_rollout_steps)
        target = pos[:, isl:isl + n_steps].transpose(1, 0, 2)  # (T, N, dim)
        preds = spatial_rollout(net, pos[:, :isl], np.asarray(ptype), mesh=mesh, box=box,
                                cutoff=cutoff, input_seq_length=isl, num_mp_steps=num_mp_steps,
                                n_steps=n_steps, normalization_stats=case.normalization_stats,
                                compute_dtype=compute_dtype, model=model, target=target,
                                device=device)
        m = metrics_computer(torch.as_tensor(preds, device=case.device),
                             torch.as_tensor(target, device=case.device))
        out[f"rollout_{i}"] = _to_numpy(m)
    return out
