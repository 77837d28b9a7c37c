"""Port parity: the dense neighbor layout with in-kernel edge geometry
(neighbors ``emit_geometry: true``) against the JAX package on the CPU.

K9's plain version (through the port's ``make_edges_fn``) against the
Pallas ``make_edges_fn(emit_geometry=True)`` in interpret mode at the same
column grid and capacities, batched; the port's features from the
geometry-emitting list against its own sender-gather features; the case
passing the setting through to the neighbor list; and the runner giving the
same metrics with the setting on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.ops import free as jax_free
from lagrangebench_tpu.ops import neighbors as jax_nb
from lagrangebench_tpu.ops import periodic as jax_periodic
from lagrangebench_tpu.ops.neighbors_pallas import make_edges_fn as jax_make_edges_fn
from lagrangebench_torch import runner
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.config import Config, from_dotlist, merge
from lagrangebench_torch.data.synthetic import make_synthetic_dataset
from lagrangebench_torch.defaults import defaults
from lagrangebench_torch.ops import neighbors_cuda as nlc
from lagrangebench_torch.ops.neighbors import ColumnGrid, make_edges_fn, neighbor_list


def _grids(dim, box, cutoff, pbc):
    """The same column grid for both packages."""
    nc = max(int(box // cutoff), 3)
    ncs = [nc] * (dim - 1)
    sizes = [box / nc] * (dim - 1)
    port = ColumnGrid(tuple(ncs), tuple(sizes), int(np.prod(ncs)), tuple([pbc] * dim))
    ref = jax_nb._Grid(cells_per_side=tuple(ncs) + (1,), cell_size=tuple(sizes) + (box,),
                       num_cells=int(np.prod(ncs)), offsets=(), pbc=tuple([pbc] * dim))
    return port, ref


@pytest.mark.parametrize("pbc", [True, False], ids=["periodic", "free"])
@pytest.mark.parametrize("dim", [2, 3])
def test_geometry_scan_plain_matches_make_edges_fn(dim, pbc):
    """K9 plain version vs the Pallas make_edges_fn(emit_geometry=True) in
    interpret mode, batch 2 with padded particles in the second sample:
    senders and overflow flags equal exactly, the (B, N, K, dim+1)
    geometry within 1e-6; the senders also equal K2's."""
    rng = np.random.default_rng(dim * 10 + pbc + 1)
    box, cutoff, n = 1.0, 0.3, 60
    k_cap, col_cap = 16, 16 if dim == 3 else 32
    pos = rng.uniform(0, box, size=(2, n, dim))
    npart = np.array([n, n - 13], dtype=np.int32)
    port_grid, ref_grid = _grids(dim, box, cutoff, pbc)
    disp = jax_periodic(box)[0] if pbc else jax_free()[0]
    ref_fn = jax_make_edges_fn(disp, cutoff, ref_grid, k_cap, col_cap, box=[box] * dim,
                               interpret=True, emit_geometry=True)
    ref_senders, ref_geom, ref_ovf = jax.vmap(ref_fn)(jnp.asarray(pos), jnp.asarray(npart))

    fn = make_edges_fn(port_grid, k_cap, col_cap, cutoff, [box] * dim, emit_geometry=True)
    senders, geom, ovf = fn(torch.as_tensor(pos), torch.as_tensor(npart))
    np.testing.assert_array_equal(senders.numpy(), np.asarray(ref_senders))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ref_ovf))
    assert geom.shape == ref_geom.shape == (2, n, k_cap, dim + 1)
    assert geom.dtype == torch.float32
    np.testing.assert_allclose(geom.numpy(), np.asarray(ref_geom), rtol=0, atol=1e-6)
    plain, _ = make_edges_fn(port_grid, k_cap, col_cap, cutoff, [box] * dim)(
        torch.as_tensor(pos), torch.as_tensor(npart))
    assert torch.equal(senders, plain)
    assert (senders.numpy()[1, n - 13:] == n).all()
    assert (geom.numpy()[1, n - 13:] == 0).all()


@pytest.mark.parametrize("pbc", [True, False], ids=["periodic", "free"])
def test_geometry_is_the_min_imaged_sender_displacement(pbc):
    """Every filled slot of the geometry-emitting list holds (receiver -
    sender) / cutoff, min-imaged on periodic axes, and its norm (1e-6);
    unfilled slots hold zeros."""
    rng = np.random.default_rng(7)
    box, cutoff, n, dim = 1.0, 0.2, 150, 3
    pos = rng.uniform(0, box, size=(n, dim))
    nl = neighbor_list(None, [box] * dim, cutoff, pbc=[pbc] * dim, emit_geometry=True)
    nbrs = nl.allocate(torch.as_tensor(pos))
    assert nbrs.format == "dense" and set(nbrs.aux) == {"rel_disp", "rel_dist"}
    senders = nbrs.idx.numpy()
    rel_disp, rel_dist = nbrs.aux["rel_disp"].numpy(), nbrs.aux["rel_dist"].numpy()
    valid = senders < n
    d = pos[:, None, :] - pos[np.minimum(senders, n - 1)]
    if pbc:
        d = d - box * np.round(d / box)
    want = np.where(valid[..., None], d / cutoff, 0.0)
    np.testing.assert_allclose(rel_disp, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rel_dist[..., 0], np.linalg.norm(want, axis=-1), rtol=0,
                               atol=1e-6)
    assert valid.sum() > n  # the graph has edges beyond the self-edges


META = {
    "bounds": [[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]],
    "periodic_boundary_conditions": [True, True, True],
    "default_connectivity_radius": 0.18,
    "num_particles_max": 150,
    "vel_mean": [0.0] * 3, "vel_std": [0.01] * 3,
    "acc_mean": [0.0] * 3, "acc_std": [0.001] * 3,
    "dim": 3, "dt": 0.01, "write_every": 1,
}
ISL = 4


def _samples(bsz, n=150, free=False):
    rng = np.random.default_rng(bsz)
    pos = rng.uniform(size=(bsz, n, 1, 3)) * 0.9 + 0.05 + np.cumsum(
        rng.normal(size=(bsz, n, ISL, 3)) * 0.002, axis=2)
    ptype = np.zeros((bsz, n), dtype=np.int64)
    ptype[:, -9:] = -1  # padding
    return (pos if free else np.mod(pos, 1.0)), ptype


@pytest.mark.parametrize("pbc", [True, False], ids=["periodic", "free"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_features_with_geometry_match_the_gather_path(dtype, pbc):
    """preprocess_eval_batched (batch 2) and allocate_eval with the
    geometry-emitting list vs the sender-position gather path: every
    feature but the geometry equal exactly, rel_disp and rel_dist within
    1e-5."""
    meta = dict(META, periodic_boundary_conditions=[pbc] * 3)
    pos, ptype = _samples(2, free=not pbc)
    feats = {}
    for geom in (False, True):
        case = case_builder([1.0] * 3, meta, ISL, cfg_neighbors={"emit_geometry": geom},
                            dtype=dtype, device="cpu")
        single, nl = case.allocate_eval((pos[0], ptype[0]))
        assert (nl.aux is not None) == geom
        batched, _ = case.preprocess_eval_batched((pos, ptype), nl.broadcast(2))
        feats[geom] = (single, batched)
    for got, want in zip(feats[True], feats[False]):
        assert got.keys() == want.keys()
        for key in want:
            if key.startswith("rel_"):
                np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=0,
                                           atol=1e-5, err_msg=key)
            else:
                np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)


def test_case_passes_emit_geometry_to_the_scan(monkeypatch):
    """case_builder hands ``emit_geometry`` to the neighbor list: the
    geometry-emitting scan (K9) runs in K2's place, once per update."""
    calls = {"geometry": 0, "senders": 0}
    real_g, real_s = nlc.neighbor_scan_geometry, nlc.neighbor_scan

    def geometry(*a, **k):
        calls["geometry"] += 1
        return real_g(*a, **k)

    def senders(*a, **k):
        calls["senders"] += 1
        return real_s(*a, **k)

    monkeypatch.setattr(nlc, "neighbor_scan_geometry", geometry)
    monkeypatch.setattr(nlc, "neighbor_scan", senders)
    pos, ptype = _samples(2)
    case = case_builder([1.0] * 3, META, ISL, cfg_neighbors={"emit_geometry": True},
                        device="cpu")
    _, nl = case.allocate_eval((pos[0], ptype[0]))
    case.preprocess_eval_batched((pos, ptype), nl.broadcast(2))
    assert calls == {"geometry": 2, "senders": 0}


@pytest.fixture(scope="module")
def gns_run(tmp_path_factory):
    """A small fused GNS trained for 2 steps by the port's runner."""
    root = tmp_path_factory.mktemp("geometry")
    src = make_synthetic_dataset(str(root), n_particles=216, dim=3, box=1.0, seq_len_train=10,
                                 seq_len_eval=ISL + 3, n_trajs=2)
    # the trainer checkpoints at its eval steps
    cfg = _cfg(root, src, mode="train", **{"train.step_max": 1, "logging.eval_steps": 1})
    runner.train_or_infer(cfg)
    return root, src, f"{root}/ckp/{cfg.logging.run_name}"


def _cfg(root, src, **dots):
    base = {
        "dataset": {"src": src}, "gpu": -1, "dtype": "float64",
        "model": {"name": "gns", "fused_processor": True, "num_mp_steps": 2,
                  "latent_dim": 16, "input_seq_length": ISL},
        "train": {"batch_size": 2, "pushforward": {"steps": [-1], "unrolls": [0],
                                                   "probs": [1]}},
        "eval": {"n_rollout_steps": 3, "train": {"n_trajs": 1},
                 "infer": {"batch_size": 2, "out_type": "none"}},
        "logging": {"log_steps": 1, "eval_steps": 10**6, "ckp_dir": f"{root}/ckp",
                    "run_name": "gns"},
    }
    return merge(defaults, Config(base), from_dotlist([f"{k}={v}" for k, v in dots.items()]))


def test_runner_emit_geometry_gives_the_same_metrics(gns_run):
    """``mode=infer`` from one checkpoint with ``neighbors.emit_geometry``
    on and off (batch 2): every averaged metric within 1e-6 relative. A
    ``val/std*`` entry is the spread of two trajectories' values, half their
    difference, so it is held to 1e-6 of its metric's mean instead (the
    difference of two nearly equal losses loses their leading digits)."""
    root, src, run_dir = gns_run
    got = runner.train_or_infer(_cfg(root, src, mode="infer", load_ckp=run_dir,
                                     **{"neighbors.emit_geometry": True}))
    want = runner.train_or_infer(_cfg(root, src, mode="infer", load_ckp=run_dir))
    assert set(got) == set(want) and "val/loss" in want
    for key in want:
        if key.startswith("val/std"):
            scale = abs(want["val/" + key[len("val/std"):]])
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6 * scale,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=0, err_msg=key)
