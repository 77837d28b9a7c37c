"""Port parity: neighbor search kernels K1/K2 (plain versions) and the dense
neighbor list, against the JAX package's Pallas path in interpret mode.

Both sides pack senders in candidate order, so the (N, K) sender matrices
are compared for equality, as are the overflow flags and binning slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.ops import free as jax_free
from lagrangebench_tpu.ops import neighbor_list as jax_neighbor_list
from lagrangebench_tpu.ops import neighbors as jax_nb
from lagrangebench_tpu.ops import periodic as jax_periodic
from lagrangebench_tpu.ops.neighbors_pallas import _table_from_cid
from lagrangebench_tpu.ops.neighbors_pallas import make_edges_fn as jax_make_edges_fn
from lagrangebench_torch.ops import neighbors_cuda as nlc
from lagrangebench_torch.ops.neighbors import (
    ColumnGrid,
    make_edges_fn,
    neighbor_list,
)


@pytest.mark.parametrize("cap", [3, 16])
def test_binning_plain_matches_pallas(cap):
    """K1 plain version vs _table_from_cid(interpret=True): slots and the
    overflow flag are equal (cap=3 overflows some cells)."""
    rng = np.random.default_rng(0)
    num_cells, m = 37, 700
    cid = rng.integers(0, num_cells + 1, size=m).astype(np.int32)  # some unbinned
    pos = rng.uniform(size=(m, 3))
    _, _, overflow, slots = _table_from_cid(
        jnp.asarray(cid), jnp.asarray(pos), num_cells, cap, tile=128, interpret=True
    )
    got_slots, max_occ = nlc.binning(torch.as_tensor(cid), num_cells, cap)
    np.testing.assert_array_equal(got_slots.numpy(), np.asarray(slots))
    assert bool(max_occ[0] > cap) == bool(overflow)


def _grids(dim, box, cutoff, pbc, f=1.0):
    """The same column grid for both packages."""
    nc = max(int(round(int(box // cutoff) * f)), 3)
    ncs = [nc] * (dim - 1)
    sizes = [box / nc] * (dim - 1)
    port = ColumnGrid(tuple(ncs), tuple(sizes), int(np.prod(ncs)), tuple([pbc] * dim))
    ref = jax_nb._Grid(
        cells_per_side=tuple(ncs) + (1,),
        cell_size=tuple(sizes) + (box,),
        num_cells=int(np.prod(ncs)),
        offsets=(),
        pbc=tuple([pbc] * dim),
    )
    return port, ref


@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("pbc", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_scan_plain_matches_make_edges_fn(dim, pbc, bsz):
    """K2 plain version (through the port's make_edges_fn) vs the Pallas
    make_edges_fn in interpret mode: equal (N, K) senders and flags, with
    padded particles in the second sample."""
    rng = np.random.default_rng(dim * 10 + pbc)
    box, cutoff, n, k_cap, col_cap = 1.0, 0.3, 60, 16, 16 if dim == 3 else 32
    pos = rng.uniform(0, box, size=(bsz, n, dim))
    npart = np.array([n, n - 13][:bsz], dtype=np.int32)
    port_grid, ref_grid = _grids(dim, box, cutoff, pbc)
    disp = jax_periodic(box)[0] if pbc else jax_free()[0]
    ref_fn = jax_make_edges_fn(
        disp, cutoff, ref_grid, k_cap, col_cap, box=[box] * dim, interpret=True
    )
    ref_senders, ref_ovf = jax.vmap(ref_fn)(jnp.asarray(pos), jnp.asarray(npart))

    fn = make_edges_fn(port_grid, k_cap, col_cap, cutoff, [box] * dim)
    senders, ovf = fn(torch.as_tensor(pos), torch.as_tensor(npart))
    np.testing.assert_array_equal(senders.numpy(), np.asarray(ref_senders))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ref_ovf))


def test_scan_overflow_flags_match():
    """Row overflow (K too small) and column overflow (cap too small) raise
    the same flags on both sides."""
    rng = np.random.default_rng(3)
    box, cutoff, n = 1.0, 0.3, 48
    pos = rng.uniform(0, box, size=(2, n, 3))
    pos[1, :20] = 0.5 + 0.01 * rng.uniform(size=(20, 3))  # a dense clump
    npart = np.array([n, n], dtype=np.int32)
    port_grid, ref_grid = _grids(3, box, cutoff, True)
    for k_cap, col_cap in ((8, 32), (32, 8)):
        ref_fn = jax_make_edges_fn(
            jax_periodic(box)[0], cutoff, ref_grid, k_cap, col_cap, box=[box] * 3,
            interpret=True,
        )
        ref_senders, ref_ovf = jax.vmap(ref_fn)(jnp.asarray(pos), jnp.asarray(npart))
        fn = make_edges_fn(port_grid, k_cap, col_cap, cutoff, [box] * 3)
        senders, ovf = fn(torch.as_tensor(pos), torch.as_tensor(npart))
        np.testing.assert_array_equal(ovf.numpy(), np.asarray(ref_ovf))
        assert ovf.any()
        np.testing.assert_array_equal(senders.numpy(), np.asarray(ref_senders))


@pytest.mark.parametrize("pbc", [True, False])
def test_neighbor_list_allocate_update_boost(pbc):
    """neighbor_list(format="dense"): allocate, update, sticky overflow and
    capacity_boost agree with the JAX neighbor_list(backend="pallas")."""
    rng = np.random.default_rng(7)
    box, cutoff, n, dim = 1.0, 0.3, 100, 3
    disp = jax_periodic(box)[0] if pbc else jax_free()[0]
    ref = jax_neighbor_list(disp, [box] * dim, cutoff, backend="pallas",
                            format="dense", pbc=[pbc] * dim)
    port = neighbor_list(None, [box] * dim, cutoff, pbc=[pbc] * dim)

    pos0 = rng.uniform(0, box, size=(n, dim))
    r0 = ref.allocate(jnp.asarray(pos0), num_particles=n - 10)
    p0 = port.allocate(torch.as_tensor(pos0), num_particles=n - 10)
    np.testing.assert_array_equal(p0.idx.numpy(), np.asarray(r0.idx))
    assert not bool(p0.did_buffer_overflow) and not bool(r0.did_buffer_overflow)

    pos1 = np.clip(pos0 + rng.normal(0, 0.01, size=pos0.shape), 0, box - 1e-6)
    r1 = r0.update(jnp.asarray(pos1), num_particles=n - 10)
    p1 = p0.update(torch.as_tensor(pos1), num_particles=n - 10)
    np.testing.assert_array_equal(p1.idx.numpy(), np.asarray(r1.idx))

    # collapse -> overflow, which stays set on the next (normal) update
    pos2 = 0.7 + 0.02 * rng.uniform(size=(n, dim))
    p2 = p1.update(torch.as_tensor(pos2))
    r2 = r1.update(jnp.asarray(pos2))
    assert bool(p2.did_buffer_overflow) and bool(r2.did_buffer_overflow)
    assert bool(p2.update(torch.as_tensor(pos1)).did_buffer_overflow)

    r3 = ref.allocate(jnp.asarray(pos1), capacity_boost=1.5)
    p3 = port.allocate(torch.as_tensor(pos1), capacity_boost=1.5)
    assert p3.capacity == r3.capacity > p1.capacity
    np.testing.assert_array_equal(p3.idx.numpy(), np.asarray(r3.idx))


def test_neighbor_list_batched_update_matches_per_sample():
    """A (B, N, dim) update equals B single-sample updates."""
    rng = np.random.default_rng(11)
    box, cutoff, n = 1.0, 0.2, 90
    port = neighbor_list(None, [box] * 3, cutoff)
    pos = rng.uniform(0, box, size=(2, n, 3))
    shell = port.allocate_shell(pos[0], capacity_boost=2.0)
    batched = shell.broadcast(2).update(torch.as_tensor(pos), num_particles=torch.tensor([n, 70]))
    for b, npart in enumerate((n, 70)):
        single = shell.update(torch.as_tensor(pos[b]), num_particles=npart)
        np.testing.assert_array_equal(batched.idx[b].numpy(), single.idx.numpy())


def test_too_small_box_raises():
    with pytest.raises(ValueError):
        neighbor_list(None, [1.0, 1.0], 0.5)
