"""Every latent width the JAX package runs, on the CPU: the port's fused GNS
at F = 96 and 100 and its PaiNN (standard and fused) at H = 64 and 100
against the JAX package; the kernels' width map; the padding the CUDA
wrappers apply.

On the card the fused GNS carries its latents zero-padded to the kernels'
instance width (96 and 100 run at 128), every LayerNorm over the true
width, and slices them before the decoder; on the CPU it runs at the true
width. The ``padded`` cases force the card's layout on the CPU
(``GNS._width``), through the plain versions at the padded width, so that
the host half of the CUDA path (the padding of the weights and latents,
the true-width LayerNorm, the slicing of the outputs and of the parameter
gradients) is held against JAX here; the kernels' half runs on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 17).

JAX runs its Pallas kernels in interpret mode, as the JAX package's own
tests run them. Tolerances: the float64 forwards 1e-10 of the largest
magnitude (the same sums in other orders; JAX's PaiNN kernels rebind their
``jnp.float32`` to float64 here, as ``tests/test_torch_painn.py`` does);
the padded against the unpadded port in float64, 1e-12 of the largest
magnitude (the padded channels add exact zeros, so only the order of a few
sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.models import GNS as JaxGNS
from lagrangebench_tpu.models.painn import PaiNN as JaxPaiNN
from lagrangebench_tpu.models.painn import painn_fused_params_from_standard as jax_to_fused
from lagrangebench_tpu.ops import painn_msg as jax_painn_msg
from lagrangebench_torch.models import GNS, PaiNN
from lagrangebench_torch.ops import fused_mp, painn_msg

N, K, DIM, ISL, MP_STEPS = 40, 8, 3, 4, 2


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _perturbed(params, seed, dtype=np.float64):
    """Biases off zero and scales off one, so every parameter matters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x, np.float64)
                                   + 0.05 * rng.normal(size=x.shape)).astype(dtype),
                        jax.device_get(params))


# ---------------------------------------------------------------------------
# the fused GNS at F = 96 and 100
# ---------------------------------------------------------------------------

def _gns_features(seed=0):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K)).astype(np.int32)
    senders[rng.uniform(size=(N, K)) < 0.3] = N  # padded slots
    valid = (senders < N)[..., None]
    rel_disp = np.where(valid, rng.uniform(-1, 1, size=(N, K, DIM)), 0.0)
    feats = {
        "vel_hist": rng.normal(size=(N, (ISL - 1) * DIM)),
        "senders": senders,
        "receivers": np.broadcast_to(np.arange(N, dtype=np.int32)[:, None], (N, K)).copy(),
        "rel_disp": rel_disp,
        "rel_dist": np.linalg.norm(rel_disp, axis=-1, keepdims=True),
    }
    return feats, rng.integers(0, 3, size=N).astype(np.int32)


def _port_gns(f, padded, monkeypatch):
    model = GNS(DIM, node_in=(ISL - 1) * DIM, edge_in=DIM + 1, latent_size=f,
                num_mp_steps=MP_STEPS, compute_dtype="float64", device="cpu").double()
    if padded:  # the card's layout: latents at the kernels' instance width
        monkeypatch.setattr(model, "_width", lambda h: fused_mp.kernel_width(f))
    return model


@pytest.mark.parametrize("padded", [False, True], ids=["true_width", "padded"])
@pytest.mark.parametrize("f", [96, 100])
def test_gns_forward_float64_matches_jax(monkeypatch, f, padded):
    """The fused GNS's acc before the float32 cast, from JAX-initialised
    weights carried across by ``load_jax_params``, against JAX's fused GNS
    at the same width: 1e-10 of the largest magnitude, at the true width
    and in the card's padded layout."""
    feats, ptype = _gns_features()
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    jmodel = JaxGNS(particle_dimension=DIM, latent_size=f, num_mp_steps=MP_STEPS,
                    use_fused_processor=True, compute_dtype="float64")
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), sample)["params"], 1)
    _, inter = jmodel.apply({"params": params}, sample, capture_intermediates=True)
    want = np.asarray(inter["intermediates"]["MLP_1"]["__call__"][0])

    model = _port_gns(f, padded, monkeypatch)
    model.load_jax_params(params)
    assert model.mp_steps[0]["w_e"].shape == (f, f)  # the weights keep the true width
    seen = {}
    hook = model.decoder.register_forward_hook(lambda m, i, o: seen.update(x=i[0], acc=o))
    with torch.no_grad():
        model({k: torch.as_tensor(v) for k, v in feats.items()}, torch.as_tensor(ptype))
    hook.remove()
    assert seen["x"].shape == (N, f)  # sliced back before the decoder
    _close(seen["acc"].numpy(), want, 1e-10)


@pytest.mark.parametrize("f", [96, 100])
def test_gns_padded_training_gradients_match_true_width(monkeypatch, f):
    """One loss's gradients through the fused processor's autograd Function
    (the plain backward at the padded width, the true-width LayerNorm, the
    parameter gradients sliced back) equal those at the true width, float64,
    1e-12 of the largest magnitude, for every parameter."""
    feats, ptype = _gns_features(3)
    grads = []
    for padded in (False, True):
        model = _port_gns(f, padded, monkeypatch)
        out = model({k: torch.as_tensor(v) for k, v in feats.items()}, torch.as_tensor(ptype))
        loss = (out["acc"].double() ** 2).mean()
        params = [p for p in model.parameters() if p.requires_grad]
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
    for a, b in zip(*grads):
        if a is None:
            assert b is None
            continue
        assert a.shape == b.shape
        _close(b.numpy(), a.numpy(), 1e-12)


# ---------------------------------------------------------------------------
# the width map and the padding, as plain Python
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,width", [(1, 64), (32, 64), (64, 64), (65, 128), (96, 128),
                                     (100, 128), (128, 128), (129, 192), (192, 192),
                                     (193, 256), (256, 256)])
def test_kernel_width_map(f, width):
    """Latent width F runs the instance 64 ceil(F / 64); bf16 takes the warp
    design up to 128 and the stream design above, float32 the tile design;
    the stream design's K4 partials are its row ranges' F x F partials and
    its two row kernels' vector sums."""
    assert fused_mp.kernel_width(f) == width and width in fused_mp.INSTANCES
    assert fused_mp._design(torch.bfloat16, width) == ("warp" if width <= 128 else "stream")
    assert fused_mp._design(torch.float32, width) == "tile"
    if width > 128:
        plan = (7, 8, 3, 1)
        assert fused_mp.bwd_partials_floats(1000, 7, True, width, plan) == (
            (2 * 3 + 3 * 1) * width * width + (7 + 8) * 4 * width)


@pytest.mark.parametrize("f", [1025, 2048, 0])
def test_kernel_width_refuses_past_the_limit(f):
    """Past the old limit of 1,024 the card takes every width (at 64 ceil(F /
    64), on the wide path); a width below 1 raises ValueError naming the
    widths the kernels take."""
    if f >= 1:
        assert fused_mp.kernel_width(f, "fused_mp") == -(-f // 64) * 64
        assert fused_mp._design(torch.bfloat16, fused_mp.kernel_width(f)) == "wide"
        return
    with pytest.raises(ValueError, match=r"widths from 1 on"):
        fused_mp.kernel_width(f, "fused_mp")


def test_pad_params_layout():
    """The padded weights: matrices zero in the padded rows and columns,
    enc_w1 in its columns only, every vector (LayerNorm scales included)
    zero past F; a dict already at the width keeps its tensors."""
    g = torch.Generator().manual_seed(0)
    f, w = 100, 128
    p = {name: torch.randn(f, f, generator=g) if name.startswith("w")
         else torch.randn(f, generator=g) for name in fused_mp.PARAM_NAMES}
    p["enc_w1"] = torch.randn(4, f, generator=g)
    q = fused_mp.pad_params(p, w)
    for name, v in q.items():
        rows = 4 if name == "enc_w1" else w
        assert v.shape == ((rows, w) if p[name].dim() == 2 else (w,)), name
        assert torch.equal(v[tuple(slice(0, d) for d in p[name].shape)], p[name]), name
        assert int((v != 0).sum()) == int((p[name] != 0).sum()), name  # zeros elsewhere
    again = fused_mp.pad_params(q, w)
    assert all(again[name] is q[name] for name in q)


def _step_inputs(f, seed=0):
    g = torch.Generator().manual_seed(seed)
    dt = torch.float64
    p = {name: (torch.randn(f, f, generator=g, dtype=dt) / f**0.5 if name.startswith("w")
                else 0.3 * torch.randn(f, generator=g, dtype=dt) + (1.0 if "scale" in name else 0))
         for name in fused_mp.PARAM_NAMES}
    enc = {"enc_w1": torch.randn(4, f, generator=g, dtype=dt),
           "enc_w2": torch.randn(f, f, generator=g, dtype=dt) / f**0.5,
           "enc_b1": torch.randn(f, generator=g, dtype=dt),
           "enc_b2": torch.randn(f, generator=g, dtype=dt),
           "enc_ln_scale": 1 + 0.3 * torch.randn(f, generator=g, dtype=dt),
           "enc_ln_bias": torch.randn(f, generator=g, dtype=dt)}
    n, k = 30, 6
    t = {"raw": torch.randn(n, k, 4, generator=g, dtype=dt),
         "e": torch.randn(n, k, f, generator=g, dtype=dt),
         "hs": torch.randn(n, k, f, generator=g, dtype=dt),
         "hr": torch.randn(n, f, generator=g, dtype=dt),
         "h": torch.randn(n, f, generator=g, dtype=dt),
         "ge": torch.randn(n, k, f, generator=g, dtype=dt),
         "gh": torch.randn(n, f, generator=g, dtype=dt),
         "mask": (torch.rand(n, k, generator=g) < 0.7).to(dt)}
    return t, p, enc


@pytest.mark.parametrize("f", [32, 96, 100])
def test_padded_step_equals_true_width_step(f):
    """The host half of the CUDA path: weights and tensors padded to
    ``kernel_width(F)``, the plain step and its backward at that width with
    the LayerNorms over the true F, then sliced, equal the plain versions at
    the true width (float64, 1e-12 of the largest magnitude); the padded
    channels come out exactly 0."""
    t, p, enc = _step_inputs(f)
    w = fused_mp.kernel_width(f)
    pad = fused_mp.pad_last
    pp, pe = fused_mp.pad_params(p, w), fused_mp.pad_params(enc, w)
    for e, step_enc, pad_enc in ((t["e"], None, None), (t["raw"], enc, pe)):
        want = fused_mp.gns_mp_step_plain(e, t["hs"], t["hr"], t["h"], t["mask"], p, step_enc)
        e_in = e if step_enc is not None else pad(e, w)
        got = fused_mp.gns_mp_step_plain(e_in, pad(t["hs"], w), pad(t["hr"], w),
                                         pad(t["h"], w), t["mask"], pp, pad_enc, latent=f)
        for a, b in zip(got, want):
            _close(a[..., :f].numpy(), b.numpy(), 1e-12)
            assert float(a[..., f:].abs().max()) == 0.0
    want = fused_mp.gns_mp_step_bwd_plain(t["e"], t["hs"], t["hr"], t["h"], t["mask"], p,
                                          t["ge"], t["gh"])
    got = fused_mp.gns_mp_step_bwd_plain(
        *(pad(t[name], w) for name in ("e", "hs", "hr", "h")), t["mask"], pp,
        pad(t["ge"], w), pad(t["gh"], w), latent=f)
    for a, b in zip(got[:4], want[:4]):
        _close(a[..., :f].numpy(), b.numpy(), 1e-12)
        assert float(a[..., f:].abs().max()) == 0.0
    for name in fused_mp.BWD_PARAM_ORDER:
        _close(fused_mp._sliced(got[4][name], want[4][name].shape).numpy(),
               want[4][name].numpy(), 1e-12)


@pytest.mark.parametrize("f", [96, 100])
def test_padded_slot_and_window_steps_equal_true_width(f):
    """K8's and E2's plain versions in the padded form (``latent`` < the
    tensors' width) equal them at the true width, float64, 1e-12 of the
    largest magnitude: the same host half as the dense step."""
    from lagrangebench_torch.experiments import window_select
    from lagrangebench_torch.ops.neighbors import neighbor_list

    rng = np.random.default_rng(0)
    nl = neighbor_list(None, [1.0] * 3, 0.3, format="slot").allocate(
        torch.as_tensor(rng.uniform(0, 1, size=(60, 3))))
    cand, bases = nl.idx, nl.aux["bases"]
    n, k = cand.shape
    w = fused_mp.kernel_width(f)
    pad = fused_mp.pad_last
    _, p, _ = _step_inputs(f, 1)
    g = torch.Generator().manual_seed(2)
    e, hs, hr, h = (torch.randn(*shape, generator=g, dtype=torch.float64)
                    for shape in ((n, k, f), (n, f), (n, f), (n, f)))
    want = fused_mp.gns_mp_step_slot_plain(e, cand, bases, hs, hr, h, p)
    got = fused_mp.gns_mp_step_slot_plain(pad(e, w), cand, bases, pad(hs, w), pad(hr, w),
                                          pad(h, w), fused_mp.pad_params(p, w), latent=f)
    for a, b in zip(got, want):
        _close(a[..., :f].numpy(), b.numpy(), 1e-12)

    n_rows, _, ext_idx, cand, w0s, _, wsub = window_select.build_structure(
        200, 3, 24, 1.45 * 0.1, seed=0)
    cand, w0s = torch.as_tensor(cand), torch.as_tensor(w0s)
    e, hs, hr, h = (torch.randn(*shape, generator=g, dtype=torch.float64)
                    for shape in ((n_rows, 24, f), (n_rows, f), (n_rows, f), (n_rows, f)))
    hs_ext = hs[torch.as_tensor(ext_idx)]
    want = fused_mp.gns_mp_step_window_plain(e, cand, w0s, wsub, hs_ext, hr, h, p)
    got = fused_mp.gns_mp_step_window_plain(pad(e, w), cand, w0s, wsub, pad(hs_ext, w),
                                            pad(hr, w), pad(h, w), fused_mp.pad_params(p, w),
                                            latent=f)
    for a, b in zip(got, want):
        _close(a[..., :f].numpy(), b.numpy(), 1e-12)


# ---------------------------------------------------------------------------
# PaiNN at H = 64 and 100
# ---------------------------------------------------------------------------

PN, PK, R, L, NV = 30, 6, 5, 2, 3


class _Wide:
    """``jax.numpy`` with ``float32`` meaning float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _painn_features(seed=0):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, PN, size=(PN, PK)).astype(np.int32)
    senders[rng.uniform(size=(PN, PK)) < 0.3] = PN  # padded slots
    vel_hist = rng.normal(size=(PN, NV * DIM)) * 0.1
    rel_disp = np.where((senders < PN)[..., None], rng.normal(size=(PN, PK, DIM)) * 0.5, 0.0)
    return {
        "vel_hist": vel_hist,
        "vel_mag": np.linalg.norm(vel_hist.reshape(PN, NV, DIM), axis=-1),
        "rel_disp": rel_disp,
        "senders": senders,
        "receivers": np.repeat(np.arange(PN, dtype=np.int32)[:, None], PK, axis=1),
    }, np.zeros(PN, np.int32)


def _jax_painn(h, fused):
    return JaxPaiNN(hidden_size=h, output_size=1, num_mp_steps=L, n_rbf=R, radius=1.0,
                    n_vels=NV, compute_dtype="float64", use_fused_layer=fused)


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
@pytest.mark.parametrize("h", [64, 100])
def test_painn_forward_float64_matches_jax(monkeypatch, h, fused):
    """PaiNN at hidden width H (standard layer: K6's plain version; fused:
    K5's) from one JAX init tree carried across by ``load_jax_params``,
    against the JAX model at that width, float64: 1e-10 of the largest
    magnitude of acc before its float32 cast."""
    monkeypatch.setattr(jax_painn_msg, "jnp", _Wide())
    feats, ptype = _painn_features()
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    params = _jax_painn(h, False).init(jax.random.PRNGKey(0), sample)["params"]
    params = _perturbed(params, 1, np.float32)  # float32 leaves, as checkpoints hold
    jparams = jax_to_fused(params, L) if fused else params
    _, inter = _jax_painn(h, fused).apply({"params": jparams}, sample,
                                          capture_intermediates=True)
    want = np.asarray(inter["intermediates"]["GatedEquivariantBlock_1"]["__call__"][0][1])

    model = PaiNN(h, L, R, 1.0, NV, fused=fused, compute_dtype="float64", device="cpu")
    model.load_jax_params(params)
    seen = {}
    handle = model.readout[-1].register_forward_hook(lambda m, i, o: seen.update(v=o[1]))
    with torch.no_grad():
        model({k: torch.as_tensor(v) for k, v in feats.items()}, torch.as_tensor(ptype))
    handle.remove()
    assert np.abs(want).max() > 1e-4  # well above the 1e-10 the comparison allows
    _close(seen["v"][..., 0].numpy(), want[..., 0], 1e-10)


@pytest.mark.parametrize("h,vec", [(128, 4), (100, 4), (98, 2), (33, 1), (256, 4)])
def test_painn_widths(h, vec):
    """K6 takes any H, each lane loading ``message_vector(H)`` channels at
    once (aligned rows); K5 takes any H and R, past its narrow instances on
    the tensor-core design (the old limits, H = 1,024 and R = 256, gone)."""
    assert painn_msg.message_vector(h) == vec and h % vec == 0
    assert not hasattr(painn_msg, "MAX_HIDDEN") and not hasattr(painn_msg, "MAX_RBF")
    assert painn_msg.is_tensor_core(1088, 20) and painn_msg.is_tensor_core(h, 264)
