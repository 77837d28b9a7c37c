"""Port parity: PaiNN (K6 ``painn_message``, K5 ``painn_layer``, the model in
both layouts, the weight bridge, one training step) against the JAX package
on the CPU, and the model's rotation equivariance.

The JAX kernels run as Pallas in interpret mode. JAX's message block casts
to float32 whatever its inputs (``lagrangebench_tpu/ops/painn_msg.py:43``,
``:58``), and so does its layer kernel (``:256``), while the port keeps
float64 inputs in float64; the float64 cases therefore rebind that module's
``jnp.float32`` to float64 (``_wide_jax``, a test-only monkeypatch) so that
both sides accumulate in float64. Tolerances: float64 1e-10, float32 1e-5.

Under the tests' x64 the JAX GaussianRBF creates float64 ``widths`` and
``offset``; the port keeps float32 parameters, as checkpoints written
without x64 hold, so the JAX trees are cast to float32 first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.case import case_builder as jax_case_builder
from lagrangebench_tpu.config import Config as JaxConfig
from lagrangebench_tpu.models import ensure_fused_params as jax_ensure_fused
from lagrangebench_tpu.models.base import make_model_fns
from lagrangebench_tpu.models.painn import PaiNN as JaxPaiNN
from lagrangebench_tpu.models.painn import painn_fused_params_from_standard as jax_to_fused
from lagrangebench_tpu.ops import painn_msg as jax_painn_msg
from lagrangebench_tpu.train import trainer as jax_trainer
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.checkpoint import flatten_tree
from lagrangebench_torch.config import Config
from lagrangebench_torch.data.synthetic import make_synthetic_arrays
from lagrangebench_torch.models import (
    PaiNN,
    ensure_fused_params,
    painn_fused_params_from_standard,
    painn_standard_params_from_fused,
)
from lagrangebench_torch.ops import painn_msg
from lagrangebench_torch.train import flat_mse_loss

N, K, H, R, L, NV = 40, 6, 16, 5, 2, 3


class _Wide:
    """``jax.numpy`` with ``float32`` meaning float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def wide_jax(monkeypatch):
    monkeypatch.setattr(jax_painn_msg, "jnp", _Wide())


def _close(got, want, dtype, err_msg=""):
    """|got - want| <= tol * max(1, max |want|): float64 1e-10, float32
    1e-5 (gradients sum many float32 terms in other orders)."""
    want = np.asarray(want)
    tol = 1e-10 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=err_msg)


def _leaves_to_numpy(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# K6 and K5: the plain versions and the autograd Functions
# ---------------------------------------------------------------------------

def _msg_inputs(dim, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(N, K, 1)) < 0.8)
    return (rng.normal(size=(N, K, (3 + dim) * H)).astype(dtype),
            (rng.normal(size=(N, K, 3 * H)) * mask).astype(dtype),
            rng.normal(size=(N, K, dim)).astype(dtype))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dim", [2, 3])
def test_painn_message_matches_jax(request, dtype, dim):
    """Values of painn_message_plain and gradients through painn_message's
    autograd Function against JAX painn_message (Pallas interpret mode,
    custom VJP)."""
    if dtype == "float64":
        request.getfixturevalue("wide_jax")
    g, wij, nd = _msg_inputs(dim, dtype)
    rng = np.random.default_rng(1)
    cds, cdv = rng.normal(size=(N, H)), rng.normal(size=(N, dim * H))

    def jloss(g_, w_, n_):
        ds, dv = jax_painn_msg.painn_message(g_, w_, n_, H, interpret=True)
        return jnp.sum(ds * cds) + jnp.sum(dv * cdv), (ds, dv)

    (_, (ds_ref, dv_ref)), grads_ref = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(g), jnp.asarray(wij), jnp.asarray(nd))

    ins = [torch.tensor(x, requires_grad=True) for x in (g, wij, nd)]
    ds, dv = painn_msg.painn_message(*ins, H)
    plain = painn_msg.painn_message_plain(*[x.detach() for x in ins], H)
    assert ds.dtype == getattr(torch, dtype)
    for got, want in ((ds, ds_ref), (dv, dv_ref), (plain[0], ds_ref), (plain[1], dv_ref)):
        _close(got.detach().numpy(), want, dtype)
    (torch.sum(ds * torch.as_tensor(cds, dtype=ds.dtype))
     + torch.sum(dv * torch.as_tensor(cdv, dtype=dv.dtype))).backward()
    for x, want in zip(ins, grads_ref):
        _close(x.grad.numpy(), want, dtype)


def _layer_inputs(dim, dtype, seed=2):
    """K5's inputs: packed (N, (2 + dim) H) node rows and an (N, K) sender
    index with repeated rows and padded slots (fill N, basis scale 0), as
    the model builds them; the parameters in float32."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K))
    senders[:, 1] = senders[:, 0]  # a sender twice in one row
    senders[rng.uniform(size=(N, K)) < 0.25] = N  # padded slots
    scale = rng.uniform(size=(N, K, 1)) * (senders < N)[..., None]
    phi = np.concatenate([rng.normal(size=(N, K, R)), scale], axis=-1)
    arrays = (rng.normal(size=(N, (2 + dim) * H)), phi, rng.normal(size=(N, K, dim)),
              rng.normal(size=(N, H)), rng.normal(size=(N, dim * H)))
    p = {"filt_w": rng.normal(size=(R, 3 * H)) * 0.3, "filt_b": rng.normal(size=(3 * H,)) * 0.1,
         "vmix_w": rng.normal(size=(H, 2 * H)) * 0.3, "mix_w1": rng.normal(size=(2 * H, H)) * 0.2,
         "mix_b1": rng.normal(size=(H,)) * 0.1, "mix_w2": rng.normal(size=(H, 3 * H)) * 0.3,
         "mix_b2": rng.normal(size=(3 * H,)) * 0.1}
    return ([x.astype(dtype) for x in arrays], senders.astype(np.int32),
            {k: v.astype(np.float32) for k, v in p.items()})


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dim", [2, 3])
def test_painn_layer_matches_jax(request, dtype, dim):
    """Values of painn_layer_plain (the gather inside) and gradients (packed
    through the gather, the other inputs and the seven parameters) through
    painn_layer's autograd Function against JAX painn_layer(packed[senders],
    ...) (Pallas interpret mode, custom VJP; the JAX gather clamps the
    padded slots' fill N to row N - 1)."""
    if dtype == "float64":
        request.getfixturevalue("wide_jax")
    arrays, senders, p = _layer_inputs(dim, dtype)
    rng = np.random.default_rng(3)
    cs, cv = rng.normal(size=(N, H)), rng.normal(size=(N, dim * H))

    def jloss(packed_, phi_, n_, s_, v_, p_):
        s_out, v_out = jax_painn_msg.painn_layer(packed_[jnp.asarray(senders)], phi_, n_, s_, v_,
                                                 p_, interpret=True)
        return jnp.sum(s_out * cs) + jnp.sum(v_out * cv), (s_out, v_out)

    jargs = [jnp.asarray(x) for x in arrays] + [{k: jnp.asarray(v) for k, v in p.items()}]
    (_, (s_ref, v_ref)), grads_ref = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(*jargs)

    ins = [torch.tensor(x, requires_grad=True) for x in arrays]
    sidx = torch.as_tensor(senders)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    s_out, v_out = painn_msg.painn_layer(ins[0], sidx, *ins[1:], tp)
    plain = painn_msg.painn_layer_plain(ins[0].detach(), sidx, *[x.detach() for x in ins[1:]],
                                        {k: v.detach() for k, v in tp.items()})
    assert s_out.dtype == getattr(torch, dtype)
    for got, want in ((s_out, s_ref), (v_out, v_ref), (plain[0], s_ref), (plain[1], v_ref)):
        _close(got.detach().numpy(), want, dtype)
    (torch.sum(s_out * torch.as_tensor(cs, dtype=s_out.dtype))
     + torch.sum(v_out * torch.as_tensor(cv, dtype=v_out.dtype))).backward()
    for x, want in zip(ins, grads_ref):
        _close(x.grad.numpy(), want, dtype)
    for name, x in tp.items():
        # float32 parameters: their gradients come back in float32
        assert x.grad.dtype == torch.float32
        _close(x.grad.numpy(), grads_ref[5][name], "float32", err_msg=name)


def test_cpu_tensors_launch_nothing():
    before = (painn_msg.PAINN_MSG.launches, painn_msg.PAINN_LAYER.launches)
    g, wij, nd = (torch.as_tensor(x) for x in _msg_inputs(3, "float32"))
    painn_msg.painn_message(g, wij, nd, H)
    arrays, senders, p = _layer_inputs(3, "float32")
    ins = [torch.as_tensor(x) for x in arrays]
    painn_msg.painn_layer(ins[0], painn_msg.sender_index(torch.as_tensor(senders), N), *ins[1:],
                          {k: torch.as_tensor(v) for k, v in p.items()})
    assert (painn_msg.PAINN_MSG.launches, painn_msg.PAINN_LAYER.launches) == before


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _features(seed=0, dim=3):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K)).astype(np.int32)
    senders[rng.uniform(size=(N, K)) < 0.3] = N  # padded slots
    vel_hist = rng.normal(size=(N, NV * dim)) * 0.1
    rel_disp = np.where((senders < N)[..., None], rng.normal(size=(N, K, dim)) * 0.5, 0.0)
    return {
        "vel_hist": vel_hist,
        "vel_mag": np.linalg.norm(vel_hist.reshape(N, NV, dim), axis=-1),
        "rel_disp": rel_disp,
        "senders": senders,
        "receivers": np.repeat(np.arange(N, dtype=np.int32)[:, None], K, axis=1),
    }, np.zeros(N, np.int32)


def _jax_model(fused, dtype):
    return JaxPaiNN(hidden_size=H, output_size=1, num_mp_steps=L, n_rbf=R, radius=1.0,
                    n_vels=NV, compute_dtype=dtype, use_fused_layer=fused)


def _jax_standard_params(feats, ptype, seed=0):
    """A JAX init tree (standard layout), perturbed so every bias matters,
    cast to float32 leaves."""
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    params = _jax_model(False, "float32").init(jax.random.PRNGKey(seed), sample)["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        jax.device_get(params))


def _port_model(fused, dtype):
    return PaiNN(H, L, R, 1.0, NV, fused=fused, compute_dtype=dtype, device="cpu")


def _port_acc_uncast(model, feats, ptype):
    """acc before the model's final float32 cast (the last readout block)."""
    seen = {}

    def hook(module, inputs, outputs):
        seen["v"] = outputs[1]

    handle = model.readout[-1].register_forward_hook(hook)
    with torch.no_grad():
        model({k: torch.as_tensor(v) for k, v in feats.items()}, torch.as_tensor(ptype))
    handle.remove()
    return seen["v"][..., 0].numpy()


def _jax_acc_uncast(params, fused, dtype, feats, ptype):
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    _, inter = _jax_model(fused, dtype).apply({"params": params}, sample,
                                              capture_intermediates=True)
    return np.asarray(inter["intermediates"]["GatedEquivariantBlock_1"]["__call__"][0][1])[..., 0]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_painn_forward_matches_jax(request, fused, dtype):
    """The PaiNN forward from one JAX init tree (standard, or converted with
    painn_fused_params_from_standard) against the JAX model, with padded
    sender slots."""
    if dtype == "float64":
        request.getfixturevalue("wide_jax")
    feats, ptype = _features()
    params = _jax_standard_params(feats, ptype)
    jparams = jax_to_fused(params, L) if fused else params
    model = _port_model(fused, dtype)
    model.load_jax_params(params)  # the standard tree: converted by the port
    got = _port_acc_uncast(model, feats, ptype)
    want = _jax_acc_uncast(jparams, fused, dtype, feats, ptype)
    assert np.abs(want).max() > 1e-3
    _close(got, want, dtype)


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_weight_bridge_and_leaf_order(fused):
    """jax_params(load_jax_params(tree)) is the tree (in the module's
    layout), and jax_leaves lists the JAX init tree's leaves in
    jax.tree.leaves order, with the JAX shapes."""
    feats, ptype = _features()
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    init = _jax_model(fused, "float32").init(jax.random.PRNGKey(4), sample)["params"]
    flat_init = _leaves_to_numpy(init)
    model = _port_model(fused, "float32")
    leaves = model.jax_leaves()
    assert [name for name, _, _ in leaves] == list(flat_init)
    for name, p, transposed in leaves:
        assert tuple((p.t() if transposed else p).shape) == flat_init[name].shape, name

    params = _jax_standard_params(feats, ptype)
    tree = jax_to_fused(params, L) if fused else params
    for source in (params, jax_to_fused(params, L)):  # either layout loads
        model.load_jax_params(source)
        back = flatten_tree(model.jax_params())
        want = flatten_tree(tree)
        assert back.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_layout_conversions_and_ensure_fused_match_jax():
    feats, ptype = _features()
    params = _jax_standard_params(feats, ptype)
    ours, theirs = painn_fused_params_from_standard(params, L), jax_to_fused(params, L)
    assert flatten_tree(ours).keys() == _leaves_to_numpy(theirs).keys()
    back = flatten_tree(painn_standard_params_from_fused(ours, L))
    for k, v in flatten_tree(params).items():
        np.testing.assert_array_equal(back[k], v)
    cfg = {"name": "painn", "fused_processor": True, "num_mp_steps": L}
    converted = ensure_fused_params(params, Config(cfg))
    want = _leaves_to_numpy(jax_ensure_fused(dict(params), JaxConfig(cfg)))
    assert {k: v for k, v in flatten_tree(converted).items()}.keys() == want.keys()
    assert ensure_fused_params(converted, Config(cfg)) is converted
    assert ensure_fused_params(params, Config(dict(cfg, fused_processor=False))) is params


def _rotation(seed=5):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_rotating_the_inputs_rotates_acc(fused):
    """acc(R x) = R acc(x) for a random rotation (float64: 1e-10)."""
    feats, ptype = _features(seed=6)
    model = _port_model(fused, "float64")
    model.load_jax_params(_jax_standard_params(feats, ptype))
    rot = _rotation()
    turned = dict(feats)
    turned["vel_hist"] = (feats["vel_hist"].reshape(N, NV, 3) @ rot.T).reshape(N, -1)
    turned["rel_disp"] = feats["rel_disp"] @ rot.T
    acc = _port_acc_uncast(model, feats, ptype)
    acc_rot = _port_acc_uncast(model, turned, ptype)
    assert np.abs(acc).max() > 1e-3
    np.testing.assert_allclose(acc_rot, acc @ rot.T, rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

ISL, NP = 4, 125


def _train_batch():
    """Port train preprocess of a batch of 2 (float64, fixed noise draw)."""
    splits, metadata = make_synthetic_arrays(n_particles=NP, dim=3, box=1.0, seq_len_train=12,
                                             seq_len_eval=12, n_trajs=2)
    pos = np.stack([t.transpose(1, 0, 2) for t in splits["train"]])[:, :, : ISL + 1]
    ptype = np.zeros(pos.shape[:2], np.int32)
    ptype[1, -6:] = -1  # padding
    cfg_model = {"isotropic_norm": True, "magnitude_features": True}
    case = case_builder([1.0] * 3, metadata, ISL, cfg_neighbors={"backend": "auto"},
                        cfg_model=cfg_model, dtype=torch.float64, device="cpu")
    _, nbrs = case.allocate_eval((pos[0, :, :ISL], ptype[0]))
    draw = torch.as_tensor(np.random.default_rng(2).normal(size=(2, NP, ISL - 1, 3)))
    feats, targets, _ = case.preprocess_batched(None, (pos, ptype), 3e-4, nbrs.broadcast(2), 0,
                                                draw=draw)
    non_kin = ptype != -1
    node_weight = (non_kin / non_kin.sum(1)[:, None]).reshape(-1)
    return metadata, feats, targets, ptype.reshape(-1), node_weight


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_train_step_loss_and_grads_match_jax(wide_jax, fused):
    """flat_mse_loss of PaiNN and its gradient (through K6's or K5's
    autograd Function) against jax.value_and_grad of the JAX trainer's
    flat_mse_loss on the same batch and noise, float64: loss rtol 1e-12,
    gradients atol 1e-9."""
    metadata, feats, targets, flat_ptype, node_weight = _train_batch()
    radius = metadata["default_connectivity_radius"] * 1.5
    jfeats = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    jmodel = JaxPaiNN(hidden_size=H, output_size=1, num_mp_steps=L, n_rbf=R, radius=radius,
                      n_vels=ISL - 1, compute_dtype="float64", use_fused_layer=fused)
    init, apply = make_model_fns(jmodel)
    params, state = init(jax.random.PRNGKey(0), (jfeats, jnp.asarray(flat_ptype)))
    rng = np.random.default_rng(3)
    params = jax.tree.map(  # float64 parameters on both sides, as the GNS step test
        lambda x: np.asarray(x, np.float64) + 0.05 * rng.normal(size=x.shape), params)
    jtargets = {k: jnp.asarray(v.numpy()) for k, v in targets.items()}
    loss_weight = {"acc": 1.0, "vel": 0.0, "pos": 0.0}
    (loss_ref, _), grads_ref = jax.value_and_grad(jax_trainer.flat_mse_loss, has_aux=True)(
        params, state, jfeats, jnp.asarray(flat_ptype), jtargets, jnp.asarray(node_weight),
        apply, loss_weight)

    model = PaiNN(H, L, R, radius, ISL - 1, fused=fused, compute_dtype="float64",
                  device="cpu").double()
    model.load_jax_params(params)
    loss = flat_mse_loss(model, feats, torch.as_tensor(flat_ptype), targets,
                         torch.as_tensor(node_weight), loss_weight)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-12)
    flat_ref = _leaves_to_numpy(grads_ref)
    leaves = model.jax_leaves()
    assert [name for name, _, _ in leaves] == list(flat_ref)
    for name, p, transposed in leaves:
        g = p.grad.t() if transposed else p.grad
        np.testing.assert_allclose(g.numpy(), flat_ref[name], rtol=1e-7, atol=1e-9, err_msg=name)
