"""Port parity: K1's function, the column table of a batch
(``neighbors_cuda.column_table_plain``), against the JAX package's Pallas
path: the batched edge builder's column ids, ``_table_from_cid`` in interpret mode
and the sentinel column it appends per sample (``neighbors_pallas.py``,
``make_edges_fn``), with the positions cast to float32 as the scan reads
them. Slots, ids, positions and the overflow flag are compared for
equality.

The ``gpu`` case holds the kernel to the plain version on the card and skips
without one; JAX is imported only by the CPU cases, so that the card's
machine runs the file with ``--noconftest -m gpu``.
"""

import numpy as np
import pytest
import torch

from lagrangebench_torch.ops import neighbors_cuda as nlc
from lagrangebench_torch.ops.neighbors import ColumnGrid

BOX = 1.0


def _grid(dim, nc, pbc=True):
    sizes = (BOX / nc,) * (dim - 1)
    return ColumnGrid((nc,) * (dim - 1), sizes, nc ** (dim - 1), (pbc,) * dim)


def _jax_table(pos, npart, grid, cap):
    """What the JAX batched edge builder hands its scan: (slots, idx_f, pos_f
    float32, overflow)."""
    import jax
    import jax.numpy as jnp

    from lagrangebench_tpu.ops import neighbors as jax_nb
    from lagrangebench_tpu.ops.neighbors_pallas import _table_from_cid

    bsz, n, dim = pos.shape
    cps, n_cols = grid.cols_per_side, grid.n_cols
    ref_grid = jax_nb._Grid(cells_per_side=tuple(cps) + (1,),
                            cell_size=tuple(grid.col_size) + (BOX,), num_cells=n_cols,
                            offsets=(), pbc=grid.pbc)

    def cid_of(p, k):
        coords = jax_nb._cell_coords(p, ref_grid)
        cid = coords[:, 0]
        for d in range(1, dim - 1):
            cid = cid * cps[d] + coords[:, d]
        return jnp.where(jnp.arange(n) < k, cid, -1).astype(jnp.int32)

    cid_local = jax.vmap(cid_of)(jnp.asarray(pos), jnp.asarray(npart))
    offs = jnp.arange(bsz, dtype=jnp.int32)[:, None] * n_cols
    cid_flat = jnp.where(cid_local >= 0, cid_local + offs, bsz * n_cols).reshape(-1)
    table_idx, table_pos, overflow, slots = _table_from_cid(
        cid_flat, jnp.asarray(pos).reshape(bsz * n, dim), bsz * n_cols, cap, tile=128,
        interpret=True, values=jnp.tile(jnp.arange(n, dtype=jnp.int32), bsz), fill=n)
    idx_f = jnp.concatenate([table_idx.reshape(bsz, n_cols, cap),
                             jnp.full((bsz, 1, cap), n, jnp.int32)], axis=1)
    pos_f = jnp.concatenate([table_pos.reshape(bsz, n_cols, cap, dim),
                             jnp.full((bsz, 1, cap, dim), 1e9, table_pos.dtype)], axis=1)
    rows = bsz * (n_cols + 1)
    return (np.asarray(slots), np.asarray(idx_f).reshape(rows, cap),
            np.asarray(pos_f.astype(jnp.float32)).reshape(rows, cap, dim), bool(overflow))


def _assert_same(got, want):
    slots, idx_f, pos_f, overflow = got
    np.testing.assert_array_equal(slots.numpy(), want[0])
    np.testing.assert_array_equal(idx_f.numpy(), want[1])
    np.testing.assert_array_equal(pos_f.numpy(), want[2])
    assert bool(overflow) == want[3]
    assert slots.dtype == idx_f.dtype == torch.int32 and pos_f.dtype == torch.float32


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("bsz,dtype", [(1, np.float64), (2, np.float32), (3, np.float64)])
def test_column_table_plain_matches_jax(bsz, dtype, dim):
    """Random positions in float32 or float64, fewer valid particles than N
    in every sample after the first; cap above every column's count."""
    rng = np.random.default_rng(10 * bsz + dim)
    n = 60
    pos = rng.uniform(0, BOX, size=(bsz, n, dim)).astype(dtype)
    npart = np.array([n, n - 13, n - 30][:bsz], dtype=np.int32)
    grid, cap = _grid(dim, 3), 48 if dim == 2 else 24
    want = _jax_table(pos, npart, grid, cap)
    assert not want[3]
    got = nlc.column_table(torch.as_tensor(pos), torch.as_tensor(npart), grid, cap)
    _assert_same(got, want)


@pytest.mark.parametrize("dim", [2, 3])
def test_column_table_overflow_matches_jax(dim):
    """cap below the largest occupancy of one sample: the particles past cap
    take the sentinel slot and land nowhere, and the one batch flag is set
    (the other sample alone would not overflow)."""
    rng = np.random.default_rng(dim)
    n = 50
    pos = rng.uniform(0, BOX, size=(2, n, dim))
    pos[1, :35, :-1] = 0.5 + 0.01 * rng.uniform(size=(35, dim - 1))  # one dense column
    npart = np.array([n, n], dtype=np.int32)
    grid, cap = _grid(dim, 3), 28 if dim == 2 else 16
    alone = nlc.column_table(torch.as_tensor(pos[:1]), torch.tensor([n]), grid, cap)
    assert not alone[3]
    want = _jax_table(pos, npart, grid, cap)
    assert want[3]
    got = nlc.column_table(torch.as_tensor(pos), torch.as_tensor(npart), grid, cap)
    _assert_same(got, want)
    assert int((got[0] == 2 * grid.n_cols * cap).sum()) >= 35 - cap


@pytest.mark.parametrize("dim", [2, 3])
def test_column_table_float64_boundaries_match_jax(dim):
    """float64 positions on (and one ulp either side of) the column
    boundaries k * col_size: the column is floor(p / col_size) in float64,
    bit for bit as the JAX package takes it."""
    nc = 7  # col_size 1/7 has no exact binary form
    grid = _grid(dim, nc, pbc=False)
    cs = grid.col_size[0]
    edges = np.array([k * cs for k in range(nc + 1)] + [k / nc for k in range(nc + 1)])
    xs = np.concatenate([edges, np.nextafter(edges, 2.0), np.nextafter(edges, -1.0)])
    xs = np.clip(xs, 0.0, BOX)
    n = xs.size
    pos = np.full((1, n, dim), 0.5)
    pos[0, :, 0] = xs
    if dim == 3:
        pos[0, :, 1] = xs[::-1]
    want = _jax_table(pos, np.array([n], np.int32), grid, 64)
    got = nlc.column_table(torch.as_tensor(pos), torch.tensor([n]), grid, 64)
    _assert_same(got, want)


def test_column_table_fits_the_shared_memory():
    """K1 holds 35 int32 per column in one block's 227 KB; the grid choice
    of ops/neighbors.py admits no more columns per sample."""
    assert nlc.column_table_fits(1653) and not nlc.column_table_fits(1654)
    assert nlc.column_table_smem_bytes(169) == 4 * 35 * 169


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["batch2", "batch1", "overflow", "float64"])
def test_column_table_kernel(case):
    """K1 on the card against its plain version: every output equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    bsz, n, cap, dtype = {"batch2": (2, 8000, 88, np.float32),
                          "batch1": (1, 8000, 88, np.float32),
                          "overflow": (2, 3000, 12, np.float32),
                          "float64": (2, 5000, 96, np.float64)}[case]
    grid = _grid(3, 13)
    pos = rng.uniform(0, BOX, size=(bsz, n, 3)).astype(dtype)
    if case == "float64":
        pos[:, ::3, 0] = np.arange(0, n, 3) % 14 * grid.col_size[0]
    dev = torch.device("cuda")
    npart = torch.tensor([n, n - 700][:bsz], dtype=torch.int32, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    got = nlc.column_table(pos_t, npart, grid, cap)
    want = nlc.column_table_plain(pos_t, npart, grid, cap)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(got[3]) == (case == "overflow")
