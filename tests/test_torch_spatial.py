"""Spatial sharding in the port (``lagrangebench_torch.parallel.spatial``) in
one process: the host helpers, the GNS re-layout and the slab search against
the JAX package's, and a one-slab forward of each model against the port's
unsharded models. float64 on the CPU; the helpers and the search exactly,
the forwards within 1e-10 of the largest value. The four-rank runs are
``tests/test_torch_spatial_ranks.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_torch.checkpoint import flatten_tree
from lagrangebench_torch.data import DataLoader, cycle
from lagrangebench_torch.models import fused_params_from_standard, standard_params_from_fused
from lagrangebench_torch.ops import neighbors as nb
from lagrangebench_torch.parallel import make_mesh
from lagrangebench_torch.parallel import spatial as sp
from lagrangebench_tpu.data.loader import cycle as jax_cycle
from lagrangebench_tpu.models import gns as jax_gns
from lagrangebench_tpu.ops import neighbors as jnb
from lagrangebench_tpu.parallel import spatial as jsp

from . import _torch_spatial_worker as w


def _window(n=300, t=6, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1.0, size=(n, t, 3))
    pos[:7, -1, 0] = [0.0, 0.25, 0.5, 0.75, 0.999999, 0.5 - 1e-12, 1.0]  # slab edges
    ptype = rng.integers(0, 3, size=n).astype(np.int32)
    return pos, ptype


@pytest.mark.parametrize("n_dev", [1, 3, 4])
def test_spatial_partition_equals_jax(n_dev):
    pos, ptype = _window()
    got, want = sp.spatial_partition(pos, ptype, n_dev, 1.0), jsp.spatial_partition(
        pos, ptype, n_dev, 1.0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("multiplier", [1.0, 1.25])
def test_spatial_caps_equal_jax(multiplier):
    pos, _ = _window(n=800)
    for cutoff in (0.09, 0.15):
        assert (sp.spatial_caps(pos[:, -1], [1.0] * 3, cutoff, multiplier)
                == jsp.spatial_caps(pos[:, -1], [1.0] * 3, cutoff, multiplier))


@pytest.mark.parametrize("noise_std", [0.0, 3e-4])
def test_host_noise_equals_jax(noise_std):
    """The same Generator state gives bit-identical noised windows, walls
    and padding unmoved."""
    pos, ptype = _window()
    ptype[-5:] = -1
    got = sp._host_gns_noise(np.random.default_rng(4), pos, ptype, 4, noise_std, [1.0] * 3)
    want = jsp._host_gns_noise(np.random.default_rng(4), pos, ptype, 4, noise_std, [1.0] * 3)
    np.testing.assert_array_equal(got, want)
    kin = (ptype == 1) | (ptype == 2) | (ptype == -1)
    np.testing.assert_array_equal(np.mod(got[kin], 1.0), np.mod(pos[kin], 1.0))


def test_cycle_reshuffles_as_jax():
    """``data.loader.cycle`` walks the epochs of a shuffled loader as the JAX
    package's does on the same seed."""
    data = [(np.full((2, 1), i), np.zeros(1)) for i in range(5)]
    got = cycle(DataLoader(data, batch_size=2, shuffle=True, drop_last=True,
                           rng=np.random.default_rng(1)))
    from lagrangebench_tpu.data.loader import DataLoader as JaxLoader

    want = jax_cycle(JaxLoader(data, batch_size=2, shuffle=True, drop_last=True,
                               rng=np.random.default_rng(1)))
    for _ in range(7):
        np.testing.assert_array_equal(next(got)[0], next(want)[0])


def test_periodic_boxes_only():
    ok = {"periodic_boundary_conditions": [True, True, True]}
    sp._require_periodic(ok, "here")
    for pbc in ([True, False, True], []):
        bad = {"periodic_boundary_conditions": pbc}
        with pytest.raises(ValueError, match="fully periodic") as got:
            sp._require_periodic(bad, "here")
        with pytest.raises(ValueError) as want:
            jsp._require_periodic(bad, "here")
        assert str(got.value) == str(want.value)


def test_segnn_and_egnn_name_their_roadmap_item():
    """SEGNN and EGNN are ported (ROADMAP.md §1 item 7.3); what JAX's
    asserts refuse, the port refuses with ValueError: SEGNN with instance
    norm (it needs statistics over every node), an EGNN whose embedding
    takes more than the velocity magnitudes (the type one-hot of JAX's EGNN
    with ``homogeneous_particles=False``), and a SEGNN or EGNN tree without
    the module to hold it."""
    from lagrangebench_torch.models.utils import LinearXav
    from lagrangebench_torch.utils import NodeType

    kw = dict(box=[1.0] * 3, cutoff=0.1, input_seq_length=4, num_mp_steps=2, k_cap=8,
              cell_cap=8, stats=w.STATS, device="cpu")
    segnn = w.steerable_model("segnn", segnn_norm="instance")
    with pytest.raises(ValueError, match="instance norm"):
        sp._make_core("segnn", make_mesh(1), segnn, **kw)
    egnn = w.steerable_model("egnn")
    egnn.embed = LinearXav(w.ISL - 1 + NodeType.SIZE, w.LATENT).double()
    with pytest.raises(ValueError, match="homogeneous particles"):
        sp._make_core("egnn", make_mesh(1), egnn, **kw)
    for model in ("segnn", "egnn"):
        with pytest.raises(ValueError, match="model_def"):
            sp._make_core(model, make_mesh(1), {}, **kw)
    with pytest.raises(ValueError, match="gns|painn|segnn|egnn"):
        sp._make_core("linear", make_mesh(1), {}, **kw)


def test_standard_params_from_fused_equals_jax_and_inverts():
    """The port's inverse re-layout equals JAX's on a fused tree, exactly,
    and the round trip through ``fused_params_from_standard`` returns every
    leaf bit for bit."""
    fused = w.seeded_model("gns").jax_params()
    got = flatten_tree(standard_params_from_fused(fused, w.MP_STEPS))
    want = flatten_tree(jax_gns.standard_params_from_fused(fused, w.MP_STEPS))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    back = flatten_tree(fused_params_from_standard(
        standard_params_from_fused(fused, w.MP_STEPS), w.MP_STEPS))
    flat = flatten_tree(fused)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def _frame(n_dev, n_loc=160, seed=1):
    """A slab's receivers and candidates in the local frame of a ring of
    ``n_dev`` (box 1, cutoff 0.09): for n_dev >= 3 [0, 3w] not periodic in
    x, the receivers in the middle third; else the periodic box. The last
    rows of each segment are padding."""
    rng = np.random.default_rng(seed)
    w_ = 1.0 / n_dev
    segs = 3 if n_dev >= 3 else n_dev
    cand = rng.uniform(0, 1, size=(segs * n_loc, 3))
    for s in range(segs):
        cand[s * n_loc:(s + 1) * n_loc, 0] = rng.uniform(0, w_, size=n_loc) + (
            (1 if s == 0 else 0 if s == 1 else 2) * w_ if n_dev >= 3 else s * w_)
    cand[3, :] = [w_ if n_dev >= 3 else 0.0, 0.0, 0.5]  # on cell boundaries
    counts = [n_loc - 9, n_loc - 3, n_loc - 17][:segs]
    valid = np.concatenate([np.arange(n_loc) < c for c in counts])
    if n_dev >= 3:
        box, pbc = [3 * w_, 1.0, 1.0], [False, True, True]
    else:
        box, pbc = [1.0] * 3, [True] * 3
    return cand[:n_loc], valid[:n_loc], cand, valid, box, pbc


@pytest.mark.parametrize("caps", [(48, 16), (1, 1)], ids=["fits", "overflows"])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_local_cell_nl_equals_jax(n_dev, caps):
    """The slab search on the frames of rings of 1, 2 and 4 against JAX's
    ``_local_cell_nl``, float64: senders, their validity and the overflow
    flag equal (caps of one neighbor and one cell slot overflow)."""
    k_cap, cell_cap = caps
    recv, rvalid, cand, cvalid, box, pbc = _frame(n_dev)
    cutoff = 0.09
    got = sp._local_cell_nl(torch.as_tensor(recv), torch.as_tensor(rvalid),
                            torch.as_tensor(cand), torch.as_tensor(cvalid),
                            nb.make_grid(box, cutoff, pbc), cell_cap, k_cap, cutoff)
    want = jsp._local_cell_nl(jnp.asarray(recv), jnp.asarray(rvalid), jnp.asarray(cand),
                              jnp.asarray(cvalid), jnb.make_grid(box, cutoff, pbc), cell_cap,
                              k_cap, cutoff)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) == bool(want[2]) == (caps == (1, 1))
    assert got[1].any()


def _one_slab(model, params, pos, ptype, k_cap):
    build = sp.build_spatial_gns_forward if model == "gns" else sp.build_spatial_painn_forward
    fwd = build(make_mesh(1), params, k_cap=k_cap, vel_mean=w.STATS["velocity"]["mean"],
                vel_std=w.STATS["velocity"]["std"], **w.common())
    pos_sh, pt_sh, counts, order = sp.spatial_partition(pos[:, :w.ISL], ptype, 1, w.BOX)
    acc, overflow = fwd(pos_sh[0], pt_sh[0], counts[0])
    assert not overflow
    out = np.zeros((w.N, w.DIM))
    out[order] = acc[:counts[0]].numpy()
    return out


@pytest.mark.parametrize("model", ["gns", "painn"])
def test_one_slab_forward_equals_unsharded(model):
    """A ring of one (the periodic box, no halo) against the port's unsharded
    model on its own neighbor list (the float64 acceleration ahead of the
    model's float32 output cast), within 1e-10 of the largest value."""
    pos, ptype = w.trajectory()
    params = w.seeded_model(model).jax_params()
    if model == "gns":
        params = w.untied(params)
    k_cap = sp.spatial_caps(pos[:, w.ISL - 1], [w.BOX] * w.DIM, w.CUTOFF)[0]
    got = _one_slab(model, params, pos, ptype, k_cap)
    want = w.unsharded(model, params, pos, ptype)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
