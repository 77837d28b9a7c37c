"""Port parity: the cell-list and all-pairs searches, dense and sparse,
against the JAX package's XLA backends, and the two fallbacks.

Both packages pack senders in candidate order (dense) and edges in
receiver-major candidate order (sparse), so ``idx``, the overflow flags and
the capacities are compared for equality, in float64. Padded particles
(``num_particles < N``) take part throughout.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.ops import free as jax_free
from lagrangebench_tpu.ops import neighbor_list as jax_neighbor_list
from lagrangebench_tpu.ops import neighbors as jax_nb
from lagrangebench_tpu.ops import periodic as jax_periodic
from lagrangebench_torch.defaults import resolve_backend
from lagrangebench_torch.ops import neighbors_cuda as nlc
from lagrangebench_torch.ops import space
from lagrangebench_torch.ops.neighbors import make_grid, make_xla_edges_fn, neighbor_list

BOX, CUTOFF = 1.0, 0.3


def _spaces(pbc, dim):
    """(JAX displacement, port displacement) of the unit box."""
    if pbc:
        return jax_periodic(jnp.asarray([BOX] * dim))[0], space.periodic(
            torch.full((dim,), BOX, dtype=torch.float64))[0]
    return jax_free()[0], space.free()[0]


def _lists(backend, fmt, dim, pbc, cutoff=CUTOFF, box=BOX, **kw):
    jd, pd = _spaces(pbc, dim)
    ref = jax_neighbor_list(jd, [box] * dim, cutoff, backend=backend, format=fmt,
                            pbc=[pbc] * dim, **kw)
    port = neighbor_list(pd, [box] * dim, cutoff, backend=backend, format=fmt,
                         pbc=[pbc] * dim, **kw)
    return ref, port


def _same(p, r):
    np.testing.assert_array_equal(p.idx.numpy(), np.asarray(r.idx))
    assert bool(p.did_buffer_overflow) == bool(r.did_buffer_overflow)


@pytest.mark.parametrize("pbc", [True, False], ids=["periodic", "free"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("backend", ["allpairs", "celllist"])
def test_neighbor_list_matches_jax(backend, fmt, dim, pbc):
    """allocate (with padding), update, sticky overflow after a collapse,
    and a boosted reallocation: equal idx, flags and capacities."""
    rng = np.random.default_rng(3 + dim)
    n = 90 if dim == 2 else 120
    ref, port = _lists(backend, fmt, dim, pbc)
    pos0 = rng.uniform(0, BOX, size=(n, dim))
    r0 = ref.allocate(jnp.asarray(pos0), num_particles=n - 7)
    p0 = port.allocate(torch.as_tensor(pos0), num_particles=n - 7)
    assert p0.format == fmt and p0.backend == backend and p0.capacity == r0.capacity
    _same(p0, r0)
    assert not bool(p0.did_buffer_overflow)

    pos1 = np.clip(pos0 + rng.normal(0, 0.01, size=pos0.shape), 0, BOX - 1e-6)
    r1 = r0.update(jnp.asarray(pos1), num_particles=n - 7)
    p1 = p0.update(torch.as_tensor(pos1), num_particles=n - 7)
    _same(p1, r1)

    # collapse: the capacities overflow (on the cell list, the cells too),
    # and the flag stays set on the next normal update
    pos2 = 0.5 + 0.03 * rng.uniform(size=(n, dim))
    r2, p2 = r1.update(jnp.asarray(pos2)), p1.update(torch.as_tensor(pos2))
    _same(p2, r2)
    assert bool(p2.did_buffer_overflow)
    assert bool(p2.update(torch.as_tensor(pos1)).did_buffer_overflow)

    r3 = ref.allocate(jnp.asarray(pos1), capacity_boost=1.5)
    p3 = port.allocate(torch.as_tensor(pos1), capacity_boost=1.5)
    assert p3.capacity == r3.capacity > p1.capacity
    _same(p3, r3)


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("backend", ["allpairs", "celllist"])
def test_edge_builders_at_small_capacities(backend, fmt):
    """The edge builders at capacities the data overflows (cells of 4, K of
    8, E of 256) against the JAX package's: the kept senders, their order
    and the flags are equal; a cell overflow on the sparse cell list counts
    E + 1 edges in JAX (a forced reallocation) and flags the port's list."""
    rng = np.random.default_rng(5)
    n, dim, npart = 150, 3, 141
    pos = rng.uniform(0, BOX, size=(n, dim))
    pos[:20] = 0.1 + 0.05 * rng.uniform(size=(20, dim))  # one crowded cell
    jd, pd = _spaces(True, dim)
    grid = make_grid([BOX] * dim, 0.2, [True] * dim)
    jgrid = jax_nb.make_grid([BOX] * dim, 0.2, [True] * dim)
    cap = 8 if fmt == "dense" else 256
    fn = make_xla_edges_fn(backend, fmt, cap, pd, 0.2, grid, 4)
    got, overflow = fn(torch.as_tensor(pos)[None], torch.tensor([npart]))
    args = (jnp.asarray(pos), npart, jd, 0.2, cap)
    if backend == "celllist":
        args += (jgrid, 4)
    name = f"_{backend}_{'dense' if fmt == 'dense' else 'edges'}"
    static = tuple(range(2, len(args)))  # all but the positions and the count
    want, flag = jax.jit(getattr(jax_nb, name), static_argnums=static)(*args)
    if fmt == "sparse":
        flag = flag > cap
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert bool(overflow[0]) == bool(flag) and bool(flag)


def test_batched_update_matches_per_sample():
    """A (B, N, dim) update of the cell list equals B single-sample
    updates, and each sample's flag is its own."""
    rng = np.random.default_rng(11)
    n = 100
    _, port = _lists("celllist", "sparse", 3, True)
    pos = rng.uniform(0, BOX, size=(2, n, 3))
    pos[1, :40] = 0.5 + 0.02 * rng.uniform(size=(40, 3))  # sample 1 overflows
    shell = port.allocate_shell(pos[0])
    batched = shell.broadcast(2).update(torch.as_tensor(pos), num_particles=torch.tensor([n, 90]))
    assert batched.idx.shape == (2, 2, shell.capacity)
    for b, npart in enumerate((n, 90)):
        single = shell.update(torch.as_tensor(pos[b]), num_particles=npart)
        np.testing.assert_array_equal(batched.idx[b].numpy(), single.idx.numpy())
        assert bool(batched.did_buffer_overflow[b]) == bool(single.did_buffer_overflow) == (b == 1)
    one = batched.select(1)
    assert one.idx.shape == (2, shell.capacity) and bool(one.did_buffer_overflow)


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
def test_small_box_takes_allpairs(fmt):
    """A box under three cells per axis: the kernel backend (dense) and the
    cell list (both formats) take the all-pairs search, as JAX does; the
    slot format raises."""
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, BOX, size=(40, 2))
    jd, pd = _spaces(True, 2)
    ref = jax_neighbor_list(jd, [BOX] * 2, 0.5, backend="allpairs", format=fmt)
    want = ref.allocate(jnp.asarray(pos), num_particles=35)
    backends = ("cuda", "celllist") if fmt == "dense" else ("celllist",)
    for backend in backends:
        got = neighbor_list(pd, [BOX] * 2, 0.5, backend=backend, format=fmt).allocate(
            torch.as_tensor(pos), num_particles=35)
        assert got.backend == "allpairs" and got.capacity == want.capacity
        _same(got, want)


def test_no_column_grid_takes_celllist(monkeypatch):
    """When no column grid admits the scan kernel (``scan_chunk`` 0), the
    kernel backend warns and builds the cell list, equal to JAX's cell
    list; the slot format raises."""
    monkeypatch.setattr(nlc, "scan_chunk", lambda cap, n_steps: 0)
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, BOX, size=(120, 3))
    jd, pd = _spaces(True, 3)
    want = jax_neighbor_list(jd, [BOX] * 3, CUTOFF, backend="celllist",
                             format="dense").allocate(jnp.asarray(pos), num_particles=110)
    with pytest.warns(UserWarning, match="falling back to the celllist"):
        got = neighbor_list(pd, [BOX] * 3, CUTOFF, format="dense").allocate(
            torch.as_tensor(pos), num_particles=110)
    assert got.backend == "celllist" and got.capacity == want.capacity
    _same(got, want)
    with warnings.catch_warnings(), pytest.raises(ValueError, match="slot format"):
        warnings.simplefilter("ignore")
        neighbor_list(pd, [BOX] * 3, CUTOFF, format="slot").allocate(torch.as_tensor(pos))


def test_celllist_rows_equal_kernel_rows_as_sets():
    """The cell list's dense rows hold the same senders as the kernel
    backend's plain version (K1 + K2 on the CPU), row by row as sets."""
    rng = np.random.default_rng(6)
    pos = torch.as_tensor(rng.uniform(0, BOX, size=(2, 150, 3)))
    npart = torch.tensor([150, 131])
    rows = {}
    for backend in ("celllist", "cuda"):
        shell = neighbor_list(None, [BOX] * 3, 0.2, backend=backend).allocate_shell(
            pos[0], capacity_boost=2.0)
        nbrs = shell.broadcast(2).update(pos, num_particles=npart)
        assert not nbrs.did_buffer_overflow.any()
        rows[backend] = nbrs.idx.numpy()
    for b in range(2):
        for i in range(150):
            assert (set(rows["celllist"][b, i]) - {150}) == (set(rows["cuda"][b, i]) - {150})


@pytest.mark.parametrize("backend,fmt,want", [
    ("auto", "dense", "cuda"), ("pallas", "slot", "cuda"), ("cuda", "dense", "cuda"),
    ("auto", "sparse", "celllist"), ("celllist", "sparse", "celllist"),
    ("allpairs", "dense", "allpairs"), ("jaxmd_vmap", "sparse", "celllist"),
    ("jaxmd_scan", "dense", "celllist"), ("matscipy", "sparse", "celllist"),
    ("pallas", "sparse", ValueError), ("cuda", "sparse", ValueError),
    ("nope", "dense", ValueError),
])
def test_resolve_backend(backend, fmt, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            resolve_backend(backend, fmt)
    else:
        assert resolve_backend(backend, fmt) == want
