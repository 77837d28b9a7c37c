"""Data parallelism over ``torch.distributed``: one process per rank.

Counterpart of ``lagrangebench_tpu/parallel/mesh.py``. There a 1D ``data``
mesh spans the devices of one program, the batch shards over it and XLA
emits one ``psum`` for the gradients. Here each rank is a process with its
own device; a :class:`Mesh` records the data group (the first n ranks of
the process group), this rank's index in it and its size, and the trainer and rollout call the collectives below themselves:

* every rank builds the same global batch and takes its own rows of the
  leading axis (:func:`shard_batch`);
* a train step sums the loss, the overflow flag and every gradient over the
  ranks in one all-reduce of one flat buffer (:func:`all_reduce_sum_`);
* rank 0's parameters are broadcast once at the start of training
  (:func:`broadcast_tensors_`), the counterpart of JAX's replicated
  placement;
* small host objects (a run name, per-trajectory metrics) travel with
  :func:`broadcast_object` and :func:`all_gather_objects`.

The backend is NCCL for CUDA ranks and gloo for CPU ranks; gloo also
reduces and broadcasts CUDA tensors (through the host), which lets two
ranks share one card where NCCL refuses to.

Spatial sharding (``parallel/spatial.py``) runs a slab ring over a
:class:`Mesh` or over each row of a :class:`Mesh2D` (:func:`make_mesh_2d`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "space"

# what ``torch.distributed.run`` (and any env:// launcher) sets in every rank
_LAUNCH_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


@dataclass(frozen=True)
class Mesh:
    """A 1D data-parallel mesh over the first ``size`` ranks.

    Attributes:
        group: the process group of those ranks (None for one rank).
        rank: this process's index in the group; -1 where the mesh left
            this rank out.
        size: the number of ranks.
    """

    group: Optional[Any]
    rank: int
    size: int

    @property
    def member(self) -> bool:
        return self.rank >= 0


def is_main(mesh: Optional[Mesh]) -> bool:
    """True where this process writes: no mesh, or rank 0 of the mesh."""
    return mesh is None or mesh.rank == 0


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: int = -1) -> Mesh:
    """A data mesh over the first ``n_devices`` ranks (-1: all of them).

    Every rank of the process group calls it: a mesh over part of the
    ranks makes a new group, which is collective.
    """
    world, rank = _world()
    if n_devices == -1:
        n_devices = world
    if not 1 <= n_devices <= world:
        raise ValueError(f"requested {n_devices} ranks, only {world} available")
    if n_devices == 1:
        return Mesh(None, 0 if rank == 0 else -1, 1)
    group = dist.group.WORLD if n_devices == world else dist.new_group(list(range(n_devices)))
    if rank >= n_devices:
        return Mesh(None, -1, n_devices)
    return Mesh(group, rank, n_devices)


@dataclass(frozen=True)
class Mesh2D(Mesh):
    """The (data, space) mesh of spatial sharding over the first ``n_data x
    n_space`` ranks: rank r is row ``r // n_space`` (its share of the batch)
    and column ``r % n_space`` (its slab of the row's ring). ``group``,
    ``rank`` and ``size`` describe the whole mesh, over which gradients are
    summed; ``ring`` is the process group of this rank's row (None for a
    ring of one) and ``ring_ranks`` its global ranks in ring order."""

    n_data: int = 1
    n_space: int = 1
    ring: Optional[Any] = None
    ring_ranks: Tuple[int, ...] = ()

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space


def launch_hint(n: int) -> str:
    """How to launch ``n`` ranks, for the errors that find too few."""
    return (f"launch {n} ranks: python -m torch.distributed.run --nproc_per_node={n} "
            "-m lagrangebench_torch ... (add gpu=-1 for CPU ranks over gloo)")


def make_mesh_2d(n_data: int, n_space: int) -> Mesh2D:
    """The (data, space) mesh over the first ``n_data * n_space`` ranks.

    Every rank of the process group calls it: it makes the mesh's group and
    one group per row, in row order, which is collective. Raises ValueError
    where the ranks are too few; a rank beyond the mesh gets a non-member
    mesh (``rank == -1``).
    """
    world, rank = _world()
    need = n_data * n_space
    if n_data < 1 or n_space < 1:
        raise ValueError(f"a ({n_data}, {n_space}) mesh has no ranks")
    if need > world:
        raise ValueError(f"the ({n_data}, {n_space}) (data, space) mesh needs {need} ranks, "
                         f"{world} available; {launch_hint(need)}")
    if need == 1:
        return Mesh2D(None, 0 if rank == 0 else -1, 1, 1, 1, None, (0,))
    whole = dist.group.WORLD if need == world else dist.new_group(list(range(need)))
    rings = []
    for row in range(n_data):
        members = list(range(row * n_space, (row + 1) * n_space))
        if n_space == 1:
            rings.append(None)
        else:
            rings.append(whole if n_data == 1 else dist.new_group(members))
    if rank >= need:
        return Mesh2D(None, -1, need, n_data, n_space, None, ())
    row = rank // n_space
    return Mesh2D(whole, rank, need, n_data, n_space, rings[row],
                  tuple(range(row * n_space, (row + 1) * n_space)))


def data_parallel_size(parallel_data: int, world_size: int, batch_size: int) -> int:
    """The JAX runner's mesh sizing (``lagrangebench_tpu/runner.py``): all
    ranks for ``parallel.data=-1``, else ``parallel.data``, cut to the ranks
    that exist and then down to a divisor of ``train.batch_size``. 1 means
    no mesh."""
    if parallel_data == 1 or world_size <= 1:
        return 1
    n_req = world_size if parallel_data == -1 else parallel_data
    n_req = min(n_req, world_size)
    while n_req > 1 and batch_size % n_req != 0:
        n_req -= 1
    return n_req


def _rows(x, mesh: Mesh):
    b = x.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} does not split over {mesh.size} ranks")
    per = b // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def shard_batch(tree, mesh: Optional[Mesh]):
    """This rank's rows of the leading axis of every leaf (numpy arrays or
    tensors in tuples, lists and dicts); the tree as it is with no mesh or
    a mesh of one."""
    if mesh is None or mesh.size == 1:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(v, mesh) for v in tree)
    return _rows(tree, mesh)


def all_reduce_sum_(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``tensor`` over the mesh's ranks, in place."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.group)
    return tensor


def broadcast_tensors_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Overwrite ``tensors`` (one dtype and device) with rank 0's, in one
    broadcast of one flat buffer."""
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0, group=mesh.group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` (picklable) on every rank of the mesh."""
    if mesh is None or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def all_gather_objects(obj, mesh: Mesh) -> List:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _launch_indicated() -> bool:
    """True when the environment describes a launch (``torch.distributed.run``
    or another env:// launcher sets all three of MASTER_ADDR, WORLD_SIZE and
    RANK). ``LOCAL_RANK`` or ``WORLD_SIZE`` alone, as single-process tools
    set them, do not count."""
    return all(os.environ.get(v) for v in _LAUNCH_ENV_VARS)


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
) -> int:
    """Initialize the default process group; returns this process's rank.

    Idempotent and single-process-safe by construction, not by swallowing
    errors: where the group exists already, or no launch is indicated (no
    explicit ``init_method`` or ``world_size`` and no launcher environment),
    the call is a deliberate no-op. Where a launch is indicated, a failure
    propagates: a run asked to be distributed must not carry on alone.

    The backend is NCCL for CUDA ranks and gloo for CPU ranks (``device``);
    ``backend="gloo"`` on CUDA ranks lets several ranks share one card.
    """
    if dist.is_initialized():
        return dist.get_rank()
    explicit = init_method is not None or world_size is not None
    if not explicit and not _launch_indicated():
        return 0
    if backend is None:
        backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(
        backend=backend,
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
    )
    return dist.get_rank()
