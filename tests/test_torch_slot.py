"""Port parity: the cell-sorted slot layout (neighbors ``format: slot``)
against the JAX package on the CPU: the slot scan K7 (plain version) vs
``make_slot_edges_fn`` in interpret mode, the slot graph vs the port's
dense graph, the slot MP step K8 (plain version) and its autograd vs the
JAX mirror and kernel, the slot GNS forward, a slot rollout and slot
training steps at batch 1, and the runner's guards.

The JAX package's batched slot preprocess (``ops/batching.py``) offsets
candidate ids as if they were particle ids; the port takes the
single-sample semantics (batch 1 only), so the rollout and training
comparisons use a size where the stencil width S*C does not exceed N, the
case in which JAX's batch-1 path is right.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.case import case_builder as jax_case_builder
from lagrangebench_tpu.data import H5Dataset as JaxH5Dataset
from lagrangebench_tpu.data.synthetic import make_synthetic_dataset
from lagrangebench_tpu.evaluate import infer as jax_infer
from lagrangebench_tpu.models import GNS as JaxGNS
from lagrangebench_tpu.models.base import make_model_fns
from lagrangebench_tpu.ops import free as jax_free
from lagrangebench_tpu.ops import fused_mp as jax_fmp
from lagrangebench_tpu.ops import neighbors as jax_nb
from lagrangebench_tpu.ops import periodic as jax_periodic
from lagrangebench_tpu.ops.neighbors_pallas import make_slot_edges_fn as jax_make_slot_edges_fn
from lagrangebench_tpu.train import trainer as jax_trainer
from lagrangebench_torch import runner
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.config import Config, merge
from lagrangebench_torch.data import H5Dataset
from lagrangebench_torch.defaults import defaults
from lagrangebench_torch.evaluate import infer
from lagrangebench_torch.models import GNS, gns_input_sizes
from lagrangebench_torch.ops import fused_mp as fmp
from lagrangebench_torch.ops.neighbors import ColumnGrid, make_slot_edges_fn, neighbor_list
from lagrangebench_torch.train import Trainer

F, FE = 32, 3


def _grids(dim, box, cutoff, pbc):
    """The same column grid for both packages."""
    nc = max(int(box // cutoff), 3)
    ncs = [nc] * (dim - 1)
    sizes = [box / nc] * (dim - 1)
    port = ColumnGrid(tuple(ncs), tuple(sizes), int(np.prod(ncs)), tuple([pbc] * dim))
    ref = jax_nb._Grid(cells_per_side=tuple(ncs) + (1,), cell_size=tuple(sizes) + (box,),
                       num_cells=int(np.prod(ncs)), offsets=(), pbc=tuple([pbc] * dim))
    return port, ref


# ---------------------------------------------------------------------------
# K7 and the slot graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pbc", [True, False], ids=["periodic", "free"])
@pytest.mark.parametrize("dim", [2, 3])
def test_slot_scan_plain_matches_make_slot_edges_fn(dim, pbc):
    """K7 plain version (through the port's make_slot_edges_fn) vs the
    Pallas make_slot_edges_fn in interpret mode at the same grid and
    capacities, with padded particles: cand, slot_to_particle,
    particle_to_slot and the overflow flag equal; rel_disp and rel_dist
    within 1e-6."""
    rng = np.random.default_rng(dim * 10 + pbc)
    box, cutoff, n = 1.0, 0.3, 70
    k_cap, col_cap = (24, 24) if dim == 3 else (40, 40)
    npart = n - 9
    pos = rng.uniform(0, box, size=(n, dim))
    port_grid, ref_grid = _grids(dim, box, cutoff, pbc)
    disp = jax_periodic(box)[0] if pbc else jax_free()[0]
    ref_fn = jax_make_slot_edges_fn(disp, cutoff, ref_grid, k_cap, col_cap, box=[box] * dim,
                                    interpret=True)
    ref, ref_ovf = ref_fn(jnp.asarray(pos), npart)
    got, ovf = make_slot_edges_fn(port_grid, k_cap, col_cap, cutoff, [box] * dim)(
        torch.as_tensor(pos), npart)
    assert not bool(ovf) and not bool(ref_ovf)
    for key in ("cand", "slot_to_particle", "particle_to_slot", "bases"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    for key in ("rel_disp", "rel_dist"):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-6,
                                   err_msg=key)
    assert (got["cand"].numpy() < got["bases"].shape[1] * col_cap).any()


def _decode(nl):
    """(receiver, sender) particle pairs of a slot list -> (row, k)."""
    cand = nl.idx.numpy()
    aux = {k: v.numpy() for k, v in nl.aux.items()}
    s2p, bases = aux["slot_to_particle"], aux["bases"]
    n_cols, s = bases.shape
    c = cand.shape[0] // (n_cols + 1)
    edges = {}
    for row in range(n_cols * c):
        for k in np.nonzero(cand[row] < s * c)[0]:
            cd = cand[row, k]
            edges[(int(s2p[row]), int(s2p[bases[row // c, cd // c] * c + cd % c]))] = (row, k)
    return edges, aux


@pytest.mark.parametrize("pbc", [True, False], ids=["periodic", "free"])
@pytest.mark.parametrize("dim", [2, 3])
def test_slot_graph_matches_dense_graph(dim, pbc):
    """neighbor_list(format="slot").allocate against the port's dense list
    on the same sample: equal (receiver, sender) edge sets, geometry equal
    to the min-imaged difference / cutoff within 1e-5, and
    slot_to_particle[particle_to_slot[p]] == p for every valid particle."""
    rng = np.random.default_rng(5 + dim)
    box, cutoff, n = 1.0, 0.25, 120
    npart = n - 11
    pos = rng.uniform(0, box, size=(n, dim))
    dense = neighbor_list(None, [box] * dim, cutoff, pbc=[pbc] * dim).allocate(
        torch.as_tensor(pos), num_particles=npart)
    slot = neighbor_list(None, [box] * dim, cutoff, pbc=[pbc] * dim, format="slot").allocate(
        torch.as_tensor(pos), num_particles=npart)
    assert slot.format == "slot" and not bool(slot.did_buffer_overflow)
    sd = dense.idx.numpy()
    want = {(r, int(s)) for r in range(n) for s in sd[r] if s < n}
    edges, aux = _decode(slot)
    assert set(edges) == want
    for (rp, sp), (row, k) in edges.items():
        d = pos[rp] - pos[sp]
        if pbc:
            d = d - box * np.round(d / box)
        np.testing.assert_allclose(aux["rel_disp"][row, k], d / cutoff, atol=1e-5)
        np.testing.assert_allclose(aux["rel_dist"][row, k, 0], np.linalg.norm(d) / cutoff,
                                   atol=1e-5)
    s2p, p2s = aux["slot_to_particle"], aux["particle_to_slot"]
    assert all(s2p[p2s[p]] == p for p in range(npart))
    n_cols, s = aux["bases"].shape
    c = slot.idx.shape[0] // (n_cols + 1)
    assert (p2s[npart:] == n_cols * c).all()  # K1's sentinel slot
    assert (slot.idx.numpy()[n_cols * c:] == s * c).all()  # the sentinel column's rows


# ---------------------------------------------------------------------------
# K8 and its autograd
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slot_graph():
    """A small 2D slot graph (80 particles, periodic)."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(size=(80, 2))
    nl = neighbor_list(None, [1.0, 1.0], 0.25, format="slot").allocate(torch.as_tensor(pos))
    return nl.idx, nl.aux["bases"]


def _step_inputs(cand, seed, dtype):
    rng = np.random.default_rng(seed)
    n_ext, k = cand.shape
    p = {name: (rng.normal(size=(F, F)) / np.sqrt(F) if name.startswith("w")
                else rng.normal(size=(F,)) * 0.1 + (1.0 if "scale" in name else 0.0))
         .astype(np.float32) for name in fmp.PARAM_NAMES}
    enc = {
        "enc_w1": rng.normal(size=(FE, F)) / 2.0,
        "enc_w2": rng.normal(size=(F, F)) / np.sqrt(F),
        "enc_b1": rng.normal(size=(F,)) * 0.1,
        "enc_b2": rng.normal(size=(F,)) * 0.1,
        "enc_ln_scale": 1.0 + 0.1 * rng.normal(size=(F,)),
        "enc_ln_bias": 0.1 * rng.normal(size=(F,)),
    }
    enc = {k_: v.astype(np.float32) for k_, v in enc.items()}
    arrs = {
        "e": rng.normal(size=(n_ext, k, F)),
        "raw": rng.normal(size=(n_ext, k, FE)),
        "hs": rng.normal(size=(n_ext, F)),
        "hr": rng.normal(size=(n_ext, F)),
        "h": rng.normal(size=(n_ext, F)),
    }
    return {k_: v.astype(dtype) for k_, v in arrs.items()}, p, enc


def _jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tt(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


@pytest.mark.parametrize("use_enc", [False, True], ids=["plain", "encoder"])
def test_slot_step_plain_matches_jax_mirror_float64(slot_graph, use_enc):
    """float64: K8's plain version vs gns_mp_step_slot_reference, atol
    1e-10; and the gather it reads vs slot_gather_reference, exactly."""
    cand, bases = slot_graph
    arrs, p, enc = _step_inputs(cand, 0, np.float64)
    e_in = "raw" if use_enc else "e"
    jc, jb = jnp.asarray(cand.numpy()), jnp.asarray(bases.numpy())
    ref = jax_fmp.gns_mp_step_slot_reference(
        jnp.asarray(arrs[e_in]), jc, jb, jnp.asarray(arrs["hs"]), jnp.asarray(arrs["hr"]),
        jnp.asarray(arrs["h"]), _jx(p), _jx(enc) if use_enc else None)
    t = _tt(arrs)
    got = fmp.gns_mp_step_slot(t[e_in], cand, bases, t["hs"], t["hr"], t["h"], _tt(p),
                               _tt(enc) if use_enc else None)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(
        fmp.slot_gather_plain(t["hs"], cand, bases).numpy(),
        np.asarray(jax_fmp.slot_gather_reference(jnp.asarray(arrs["hs"]), jc, jb)))


@pytest.mark.parametrize("use_enc", [False, True], ids=["plain", "encoder"])
def test_slot_step_plain_matches_pallas_interpret_float32(slot_graph, use_enc):
    """float32: K8's plain version vs the Pallas slot kernel in interpret
    mode, atol = rtol = 1e-5 (float32 sums in another order)."""
    cand, bases = slot_graph
    arrs, p, enc = _step_inputs(cand, 1, np.float32)
    e_in = "raw" if use_enc else "e"
    ref = jax_fmp.gns_mp_step_slot(
        jnp.asarray(arrs[e_in]), jnp.asarray(cand.numpy()), jnp.asarray(bases.numpy()),
        jnp.asarray(arrs["hs"]), jnp.asarray(arrs["hr"]), jnp.asarray(arrs["h"]), _jx(p),
        _jx(enc) if use_enc else None, interpret=True)
    t = _tt(arrs)
    got = fmp.gns_mp_step_slot(t[e_in], cand, bases, t["hs"], t["hr"], t["h"], _tt(p),
                               _tt(enc) if use_enc else None)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_enc", [False, True], ids=["plain", "encoder"])
def test_slot_autograd_matches_jax_grad_float64(slot_graph, use_enc):
    """float64: the gradients of gns_mp_step_slot_autograd (e or the
    encoder's parameters, hs_ext, hr, h and every step parameter) vs
    jax.grad through gns_mp_step_slot (its custom VJP), atol 1e-9."""
    cand, bases = slot_graph
    arrs, p, enc = _step_inputs(cand, 2, np.float64)
    e_in = "raw" if use_enc else "e"
    rng = np.random.default_rng(9)
    we = rng.normal(size=(cand.shape[0], cand.shape[1], F))
    wh = rng.normal(size=(cand.shape[0], F))
    jc, jb = jnp.asarray(cand.numpy()), jnp.asarray(bases.numpy())

    def loss(e, hs, hr, h, p_, enc_):
        eo, ho = jax_fmp.gns_mp_step_slot(e, jc, jb, hs, hr, h, p_, enc_ if use_enc else None,
                                          interpret=True)
        return jnp.sum(eo * we) + jnp.sum(ho * wh)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(
        *(jnp.asarray(arrs[k]) for k in (e_in, "hs", "hr", "h")), _jx(p), _jx(enc))

    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in arrs.items()}
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    et = {k: torch.tensor(v, requires_grad=True) for k, v in enc.items()}
    eo, ho = fmp.gns_mp_step_slot_autograd(
        leaves[e_in], cand, bases, leaves["hs"], leaves["hr"], leaves["h"], pt,
        et if use_enc else None)
    (torch.sum(eo * torch.as_tensor(we)) + torch.sum(ho * torch.as_tensor(wh))).backward()
    for key, g in zip((e_in, "hs", "hr", "h"), ref[:4]):
        np.testing.assert_allclose(leaves[key].grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-9, err_msg=key)
    for name in fmp.BWD_PARAM_ORDER:
        np.testing.assert_allclose(pt[name].grad.numpy(), np.asarray(ref[4][name]), rtol=0,
                                   atol=1e-9, err_msg=name)
    if use_enc:
        for name in fmp.ENC_PARAM_NAMES:
            np.testing.assert_allclose(et[name].grad.numpy(), np.asarray(ref[5][name]),
                                       rtol=0, atol=1e-9, err_msg=name)


# ---------------------------------------------------------------------------
# the slot GNS, rollout and training against the JAX package
# ---------------------------------------------------------------------------

ISL, STEPS, LATENT, MP = 4, 4, 16, 2
META = {
    "bounds": [[0.0, 1.0], [0.0, 1.0]],
    "periodic_boundary_conditions": [True, True],
    "default_connectivity_radius": 0.11,
    "num_particles_max": 256,
    "vel_mean": [0.0, 0.0], "vel_std": [0.01, 0.01],
    "acc_mean": [0.0, 0.0], "acc_std": [0.001, 0.001],
    "dim": 2, "dt": 0.01, "write_every": 1,
}


def _sample(seed, n=256):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(size=(n, 1, 2)) * 0.95 + np.cumsum(
        rng.normal(size=(n, ISL, 2)) * 0.002, axis=1)
    ptype = rng.integers(0, 2, size=n)
    ptype[-7:] = -1  # padding
    return np.mod(pos, 1.0), ptype


def _jax_gns_params(feats, ptype, seed=0):
    model = JaxGNS(particle_dimension=2, latent_size=LATENT, num_mp_steps=MP,
                   use_fused_processor=True, compute_dtype="float64")
    params = model.init(jax.random.PRNGKey(seed), (feats, jnp.asarray(ptype)))["params"]
    rng = np.random.default_rng(1)
    return model, jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        jax.device_get(params))


def _port_gns(dtype="float64"):
    node_in, edge_in = gns_input_sizes(META, ISL)
    return GNS(2, node_in, edge_in, latent_size=LATENT, num_mp_steps=MP, compute_dtype=dtype,
               device="cpu")


def _acc64(model, feats, ptype):
    """The port's acc before the float32 cast (slot order in the slot layout)."""
    seen = {}
    hook = model.decoder.register_forward_hook(lambda m, i, o: seen.setdefault("acc", o))
    with torch.no_grad():
        model(feats, torch.as_tensor(ptype))
    hook.remove()
    return seen["acc"].numpy()


def test_gns_slot_forward_matches_jax_and_dense():
    """From one JAX parameter tree, float64, acc on every valid particle:

    * the port's slot GNS vs JAX's slot GNS on the features of JAX's
      case.allocate_eval: 1e-10;
    * the port's own slot features vs JAX's: the graph and maps equal, the
      node features within 1e-12, the geometry within 1e-6 (JAX's
      interpret mode on the CPU fuses dist^2's last product into an FMA,
      the port's scan does not: rel_dist differs in its last float32 bit
      in a few slots);
    * the port's slot GNS vs its dense GNS on the dense list with
      in-kernel geometry (the same float32 geometry, from K9): 1e-10;
      both layouts share the tree."""
    pos, ptype = _sample(3)
    kw = dict(box=[1.0, 1.0], metadata=META, input_seq_length=ISL)
    jcase = jax_case_builder(cfg_neighbors={"backend": "pallas", "format": "slot"},
                             dtype=jnp.float64, **kw)
    jfeats, jnl = jcase.allocate_eval((pos, ptype))
    model, params = _jax_gns_params(jfeats, ptype)
    _, inter = model.apply({"params": params}, (jfeats, jnp.asarray(ptype)),
                           capture_intermediates=True)
    p2s = np.asarray(jnl.aux["particle_to_slot"])
    ref = np.asarray(inter["intermediates"]["MLP_1"]["__call__"][0])[p2s]
    port = _port_gns()
    port.load_jax_params(params)
    valid = ptype != -1
    jf = {k: torch.tensor(np.asarray(v)) for k, v in jfeats.items()}
    np.testing.assert_allclose(_acc64(port, jf, ptype)[p2s][valid], ref[valid], rtol=0,
                               atol=1e-10)

    case = case_builder(cfg_neighbors={"format": "slot"}, dtype=torch.float64, device="cpu",
                        **kw)
    feats, _ = case.allocate_eval((pos, ptype))
    assert feats.keys() == jf.keys()
    for key in feats:
        exact = not feats[key].is_floating_point()
        np.testing.assert_allclose(feats[key].numpy(), jf[key].numpy(), rtol=0,
                                   atol=0 if exact else 1e-12 if "rel" not in key else 1e-6,
                                   err_msg=key)
    slot = _acc64(port, feats, ptype)[p2s]
    dense_case = case_builder(cfg_neighbors={"emit_geometry": True}, dtype=torch.float64,
                              device="cpu", **kw)
    dense = _acc64(port, dense_case.allocate_eval((pos, ptype))[0], ptype)
    np.testing.assert_allclose(slot[valid], dense[valid], rtol=0, atol=1e-10)


def test_slot_batch_one_equals_single_sample_and_batch_two_raises():
    """The JAX package's fault, as a regression test of the port: at a size
    whose stencil width S*C exceeds N (where JAX's batched preprocess turns
    candidate ids >= N into N), the port's batched slot preprocess at
    batch 1 equals its single-sample preprocess; at batch 2 it raises."""
    pos, ptype = _sample(4, n=20)
    case = case_builder([1.0, 1.0], META, ISL, cfg_neighbors={"format": "slot"},
                        dtype=torch.float64, device="cpu")
    single, nl = case.allocate_eval((pos, ptype))
    n_cols, s = nl.aux["bases"].shape
    c = nl.idx.shape[0] // (n_cols + 1)
    assert s * c > pos.shape[0] and (nl.idx >= pos.shape[0]).any()
    batched, nl_b = case.preprocess_eval_batched((pos[None], ptype[None]), nl.broadcast(1))
    assert nl_b.idx.shape == (1,) + tuple(nl.idx.shape) and nl_b.format == "slot"
    assert single.keys() == batched.keys()
    for key in single:
        np.testing.assert_array_equal(batched[key].numpy(), single[key].numpy(), err_msg=key)
    with pytest.raises(ValueError, match="single-sample"):
        case.preprocess_eval_batched((np.stack([pos, pos]), np.stack([ptype, ptype])),
                                     nl.broadcast(2))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """400 particles in 2D (S*C <= N at its column grid)."""
    root = tmp_path_factory.mktemp("slot")
    return make_synthetic_dataset(str(root), n_particles=400, dim=2, box=1.0,
                                  seq_len_train=10, seq_len_eval=ISL + STEPS, n_trajs=2)


def test_slot_rollout_matches_jax(dataset, tmp_path):
    """infer in the slot layout at batch 1 (preprocess in float64) against
    the JAX infer with the same weights and layout: every metric within
    rtol 1e-4, the predicted positions within 1e-5 (the tolerances of
    tests/test_torch_rollout.py)."""
    cfg = {"batch_size": 1, "metrics": ["mse", "e_kin", "sinkhorn"], "metrics_stride": 1,
           "out_type": "pkl", "n_trajs": -1}
    data = JaxH5Dataset("test", dataset, input_seq_length=ISL, extra_seq_length=STEPS)
    meta = data.metadata
    case_kw = dict(cfg_model={"isotropic_norm": False}, noise_std=0.0)
    jcase = jax_case_builder([1.0] * 2, meta, ISL, cfg_neighbors={"backend": "pallas",
                                                                   "format": "slot"},
                             dtype=jnp.float64, **case_kw)
    pos, ptype = data[0]
    feats, nl = jcase.allocate_eval((pos[:, :ISL], ptype))
    n_cols, s = nl.aux["bases"].shape
    assert s * (nl.idx.shape[0] // (n_cols + 1)) <= pos.shape[0]
    model = JaxGNS(particle_dimension=2, latent_size=LATENT, num_mp_steps=MP,
                   use_fused_processor=True, compute_dtype="float32")
    params = model.init(jax.random.PRNGKey(3), (feats, jnp.asarray(ptype)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        jax.device_get(params))
    ref = jax_infer(model, jcase, data, params=params, cfg_eval_infer=cfg,
                    rollout_dir=str(tmp_path / "jax"), n_rollout_steps=STEPS)

    pcase = case_builder([1.0] * 2, meta, ISL, cfg_neighbors={"format": "slot"},
                         dtype=torch.float64, device="cpu", **case_kw)
    node_in, edge_in = gns_input_sizes(meta, ISL)
    pmodel = GNS(2, node_in, edge_in, latent_size=LATENT, num_mp_steps=MP, device="cpu")
    pmodel.load_jax_params(params)
    ours = infer(pmodel, pcase, H5Dataset("test", dataset, input_seq_length=ISL,
                                          extra_seq_length=STEPS),
                 cfg_eval_infer=cfg, rollout_dir=str(tmp_path / "port"), n_rollout_steps=STEPS,
                 device="cpu")
    assert sorted(ours) == sorted(ref) == ["rollout_0", "rollout_1"]
    for name in ref:
        for key, want in ref[name].items():
            got = ours[name][key]
            if isinstance(want, dict):
                for sub in want:
                    np.testing.assert_allclose(np.asarray(got[sub], np.float64),
                                               np.asarray(want[sub], np.float64), rtol=1e-4,
                                               err_msg=f"{key}/{sub}")
            else:
                np.testing.assert_allclose(np.asarray(got, np.float64),
                                           np.asarray(want, np.float64), rtol=1e-4, err_msg=key)
        assert np.all(np.asarray(ref[name]["mse"]) > 0)
    for i in range(2):
        with open(tmp_path / "jax" / f"rollout_{i}.pkl", "rb") as f:
            want = pickle.load(f)["predicted_rollout"]
        with open(tmp_path / "port" / f"rollout_{i}.pkl", "rb") as f:
            got = pickle.load(f)["predicted_rollout"]
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def _fixed_normal(draw):
    def normal(key, shape, dtype=jnp.float64):
        assert tuple(shape) == draw.shape[-3:], (shape, draw.shape)
        return jnp.asarray(draw, dtype=dtype)

    return normal


def test_slot_training_matches_jax_trainer(dataset, monkeypatch):
    """Three Trainer steps in the slot layout at batch 1 against the JAX
    Trainer (float64 model and preprocess, the same parameters, data order
    and noise draw): losses rtol 1e-7, parameters atol 1e-9. The loss
    tolerance is the float32 edge geometry's: both scans emit it in
    float32, and JAX's interpret mode on the CPU rounds rel_dist's last bit
    otherwise in a few slots (see test_gns_slot_forward_matches_jax_and_dense);
    the rest of the step runs in float64 on both sides."""
    n = 400
    draw = np.random.default_rng(2).normal(size=(n, ISL - 1, 2))
    monkeypatch.setattr(jax.random, "normal", _fixed_normal(draw))
    cfg_train = {"batch_size": 1, "noise_std": 3e-4,
                 "pushforward": {"steps": [-1], "unrolls": [0], "probs": [1]}}
    cfg_eval = {"n_rollout_steps": 2, "train": {"n_trajs": 1, "batch_size": 1}}
    cfg_log = {"log_steps": 100, "eval_steps": 10**6}
    nb_cfg = {"format": "slot"}

    jtrain = JaxH5Dataset("train", dataset, input_seq_length=ISL, extra_seq_length=1)
    jvalid = JaxH5Dataset("valid", dataset, input_seq_length=ISL, extra_seq_length=2)
    meta = jtrain.metadata
    jcase = jax_case_builder([1.0] * 2, meta, ISL, cfg_neighbors=dict(nb_cfg, backend="pallas"),
                             noise_std=3e-4, dtype=jnp.float64)
    model = JaxGNS(particle_dimension=2, latent_size=LATENT, num_mp_steps=MP,
                   use_fused_processor=True, compute_dtype="float64")
    pos, ptype = jtrain[0]
    feats, _ = jcase.allocate_eval((pos[:, :ISL], ptype))
    params = model.init(jax.random.PRNGKey(1), (feats, jnp.asarray(ptype)))["params"]
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64) + 0.05 * rng.normal(size=x.shape),
                          jax.device_get(params))
    jtr = jax_trainer.Trainer(make_model_fns(model), jcase, jtrain, jvalid, cfg_train=cfg_train,
                              cfg_eval=cfg_eval, cfg_logging=cfg_log, input_seq_length=ISL)
    jlosses, step = [], jtr._train_step

    def record(*args, **kw):
        out = step(*args, **kw)
        jlosses.append(float(out[0]))
        return out

    jtr._train_step = record
    jparams, _, _ = jtr.train(step_max=2, params=params)

    ptrain = H5Dataset("train", dataset, input_seq_length=ISL, extra_seq_length=1)
    pvalid = H5Dataset("valid", dataset, input_seq_length=ISL, extra_seq_length=2)
    pcase = case_builder([1.0] * 2, meta, ISL, cfg_neighbors=nb_cfg, noise_std=3e-4,
                         dtype=torch.float64, device="cpu")
    real = pcase.preprocess_batched

    def with_draw(*args, **kw):  # the JAX side's noise, for the batch of 1
        return real(*args, **kw, draw=torch.as_tensor(draw[None]))

    pcase = pcase._replace(preprocess_batched=with_draw)
    pmodel = _port_gns().double()
    pmodel.load_jax_params(params)
    tr = Trainer(pmodel, pcase, ptrain, pvalid, cfg_train=cfg_train, cfg_eval=cfg_eval,
                 cfg_logging=cfg_log, input_seq_length=ISL, device="cpu")
    plosses, pstep = [], tr.train_step

    def precord(*args):
        out = pstep(*args)
        plosses.append(float(out[0]))
        return out

    tr.train_step = precord
    tr.train(step_max=2)
    assert len(plosses) == len(jlosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-7)
    flat_ref = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    for name, p, transposed in pmodel.jax_leaves():
        got = (p.t() if transposed else p).detach().numpy()
        np.testing.assert_allclose(got, flat_ref[name], rtol=0, atol=1e-9, err_msg=name)


# ---------------------------------------------------------------------------
# runner guards
# ---------------------------------------------------------------------------


def _cfg(**dots):
    from lagrangebench_torch.config import from_dotlist

    base = {"dataset": {"src": "unused"}, "gpu": -1, "neighbors": {"format": "slot"},
            "model": {"name": "gns", "fused_processor": True},
            "train": {"batch_size": 1}, "eval": {"train": {"batch_size": 1},
                                                 "infer": {"batch_size": 1}}}
    return merge(defaults, Config(base), from_dotlist([f"{k}={v}" for k, v in dots.items()]))


@pytest.mark.parametrize("dots", [
    {"model.name": "painn"},
    {"model.fused_processor": False},
    {"train.batch_size": 2},
    {"eval.train.batch_size": 2},
    {"eval.infer.batch_size": 2},
    {"mode": "infer", "eval.infer.batch_size": 2},
    {"mode": "train", "eval.train.batch_size": 2},
], ids=["painn", "not_fused", "train_batch", "eval_train_batch", "infer_batch",
        "infer_mode_batch", "train_mode_eval_batch"])
def test_runner_refuses_slot_combinations_it_cannot_run(dots):
    with pytest.raises(ValueError, match="neighbors.format=slot"):
        runner.train_or_infer(_cfg(**dots))


def test_runner_sparse_format_is_not_ported():
    """The fused GNS processor and the fused PaiNN layer refuse the sparse
    layout: they need the dense one, as the JAX package asserts."""
    for name in ("gns", "painn"):
        with pytest.raises(ValueError, match="needs the dense edge layout"):
            runner.train_or_infer(_cfg(**{"neighbors.format": "sparse", "model.name": name}))


@pytest.mark.parametrize("dots", [
    {},
    {"mode": "infer", "train.batch_size": 2, "eval.train.batch_size": 2},
    {"mode": "train", "eval.infer.batch_size": 2},
], ids=["all", "infer_mode", "train_mode"])
def test_runner_accepts_slot_at_batch_one(dots):
    """A slot config with the fused GNS at batch 1 in every stage its mode
    runs passes the guard (a batch size of a stage it skips is not read)."""
    runner._check_ported(_cfg(**dots))


def test_chip_smoke_config_is_the_shipped_gns_config():
    """The GNS config dict chip_smoke.py carries for its slot and geometry
    phases (the card's machine need not have PyYAML) equals
    configs/rpf_3d/gns.yaml resolved over the defaults."""
    import os
    import sys

    from lagrangebench_torch.config import load_with_extends

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    cwd = os.getcwd()
    os.chdir(repo)
    try:
        want = load_with_extends("configs/rpf_3d/gns.yaml", defaults)
    finally:
        os.chdir(cwd)
    assert merge(defaults, Config(chip_smoke.GNS_CONFIG)).to_dict() == want.to_dict()
