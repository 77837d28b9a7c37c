"""K5 with the sender gather inside, on the CPU: the new interface against
the path it replaces, and the fused PaiNN layer's call into it.

The fused layer used to gather ``g = gather_rows(packed, sidx)`` and hand
the (N, K, (2 + dim) * H) rows to K5; K5 now takes ``packed`` and the
sender index and gathers itself. Its autograd Function's gradients must
equal those of the old path (the gather, then the layer on the gathered
rows) to float rounding: float64 1e-12 and float32 1e-6, relative to the
largest magnitude (the two run the same operations; only the order of the
backward's sums may differ).
"""

import numpy as np
import pytest
import torch

from lagrangebench_torch.models import PaiNN
from lagrangebench_torch.models import painn as painn_model
from lagrangebench_torch.models.utils import gather_rows
from lagrangebench_torch.ops import painn_msg

N, K, H, R, NV = 30, 7, 16, 5, 3


def _inputs(dim, dtype, seed=0):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K))
    senders[:, 2] = senders[:, 1]  # repeated rows
    senders[rng.uniform(size=(N, K)) < 0.3] = N  # padded slots: fill N, scale 0
    scale = rng.uniform(size=(N, K, 1)) * (senders < N)[..., None]
    tensors = {
        "packed": rng.normal(size=(N, (2 + dim) * H)),
        "phi": np.concatenate([rng.normal(size=(N, K, R)), scale], axis=-1),
        "nd": rng.normal(size=(N, K, dim)),
        "s": rng.normal(size=(N, H)),
        "v": rng.normal(size=(N, dim * H)),
    }
    p = {"filt_w": (R, 3 * H), "filt_b": (3 * H,), "vmix_w": (H, 2 * H), "mix_w1": (2 * H, H),
         "mix_b1": (H,), "mix_w2": (H, 3 * H), "mix_b2": (3 * H,)}
    params = {name: torch.tensor(rng.normal(size=shape) * 0.3, dtype=torch.float32)
              for name, shape in p.items()}
    return ({k: torch.tensor(v, dtype=getattr(torch, dtype)) for k, v in tensors.items()},
            torch.as_tensor(senders), params)


def _leaves(t, params):
    return ({k: v.clone().requires_grad_() for k, v in t.items()},
            {k: v.clone().requires_grad_() for k, v in params.items()})


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dim", [2, 3])
def test_layer_gradients_equal_the_gathered_path(dtype, dim):
    """painn_layer(packed, sidx, ...) against gather_rows(packed, sidx) fed
    to the layer on gathered rows: the same outputs, and the same gradients
    of packed, s, v, phi, the directions and the seven parameters."""
    t, senders, params = _inputs(dim, dtype)
    sidx = painn_msg.sender_index(senders, N)
    assert sidx.dtype == torch.int32
    rng = np.random.default_rng(1)
    cot = [torch.tensor(rng.normal(size=(N, H)), dtype=t["s"].dtype),
           torch.tensor(rng.normal(size=(N, dim * H)), dtype=t["s"].dtype)]

    def run(new):
        x, p = _leaves(t, params)
        if new:
            out = painn_msg.painn_layer(x["packed"], sidx, x["phi"], x["nd"], x["s"], x["v"], p)
        else:
            g = gather_rows(x["packed"], sidx.long())
            out = painn_msg.painn_layer_gathered_plain(g, x["phi"], x["nd"], x["s"], x["v"], p)
        sum(torch.sum(o * c) for o, c in zip(out, cot)).backward()
        grads = {k: v.grad for k, v in x.items()}
        grads.update({k: v.grad for k, v in p.items()})
        return [o.detach() for o in out], grads

    out_new, grads_new = run(True)
    out_old, grads_old = run(False)
    tol = 1e-12 if dtype == "float64" else 1e-6
    for a, b in zip(out_new, out_old):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    assert grads_new.keys() == grads_old.keys()
    for name, b in grads_old.items():
        a = grads_new[name]
        assert a.dtype == b.dtype, name
        assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1.0), name


def test_sender_index_clamps_the_fill_to_the_last_row():
    senders = torch.tensor([[0, 4, 5], [5, 5, 2]])
    sidx = painn_msg.sender_index(senders, 5)
    assert sidx.dtype == torch.int32 and sidx.is_contiguous()
    assert sidx.tolist() == [[0, 4, 4], [4, 4, 2]]


def test_plain_layer_gathers_with_the_clamped_index():
    """painn_layer_plain on the raw senders (fill N) equals the layer on
    packed[sender_index(senders)]: the fill reads row N - 1, as a JAX
    gather clamps."""
    t, senders, params = _inputs(3, "float64", seed=2)
    rest = (t["phi"], t["nd"], t["s"], t["v"], params)
    got = painn_msg.painn_layer_plain(t["packed"], senders, *rest)
    rows = t["packed"][painn_msg.sender_index(senders, N).long()]
    want = painn_msg.painn_layer_gathered_plain(rows, *rest)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_layer_takes_a_source_table_of_its_own_size(dim):
    """K5's plain version with M = 3N source rows (a slab and its two halo
    slabs under spatial sharding), senders anywhere in [0, 3N] (fill 3N):
    float64, exactly painn_layer_gathered_plain of packed[rows], the rows
    clamped to M - 1; the Function's gradient of packed has all M rows,
    zero where no slot gathered."""
    t, _, params = _inputs(dim, "float64", seed=5)
    rng = np.random.default_rng(6)
    m = 3 * N
    senders = rng.integers(0, m, size=(N, K))
    senders[rng.uniform(size=(N, K)) < 0.3] = m
    packed = torch.as_tensor(rng.normal(size=(m, (2 + dim) * H)))
    sidx = painn_msg.sender_index(torch.as_tensor(senders), m)
    assert int(sidx.max()) == m - 1
    rest = (t["phi"], t["nd"], t["s"], t["v"], params)
    got = painn_msg.painn_layer_plain(packed, sidx, *rest)
    want = painn_msg.painn_layer_gathered_plain(packed[sidx.long()], *rest)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    x = packed.clone().requires_grad_()
    sum(o.sum() for o in painn_msg.painn_layer(x, sidx, *rest)).backward()
    assert x.grad.shape == (m, (2 + dim) * H)
    unused = np.setdiff1d(np.arange(m), np.asarray(sidx).reshape(-1))
    assert unused.size and float(x.grad[unused].abs().max()) == 0.0


def _features(dim=3, seed=3):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K)).astype(np.int32)
    senders[rng.uniform(size=(N, K)) < 0.3] = N
    vel_hist = rng.normal(size=(N, NV * dim)) * 0.1
    return {
        "vel_hist": torch.as_tensor(vel_hist),
        "vel_mag": torch.as_tensor(np.linalg.norm(vel_hist.reshape(N, NV, dim), axis=-1)),
        "rel_disp": torch.as_tensor(np.where((senders < N)[..., None],
                                             rng.normal(size=(N, K, dim)) * 0.5, 0.0)),
        "senders": torch.as_tensor(senders),
    }


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_layer_calls_k5_with_packed_and_the_index(monkeypatch, dtype):
    """The fused PaiNN forward hands K5's wrapper the (N, (2 + dim) H) node
    rows and the (N, K) int32 sender index, one index per forward for all
    layers, and gathers no sender rows itself."""
    calls, gathers = [], []
    real_layer, real_gather = painn_msg.painn_layer, painn_model.gather_rows

    def layer(packed, sidx, phi, neg_dir, s, v, p):
        calls.append((packed, sidx, phi))
        return real_layer(packed, sidx, phi, neg_dir, s, v, p)

    def gather(src, idx):
        gathers.append(tuple(src.shape))
        return real_gather(src, idx)

    monkeypatch.setattr(painn_msg, "painn_layer", layer)
    monkeypatch.setattr(painn_model, "gather_rows", gather)
    model = PaiNN(H, 2, R, 1.0, NV, fused=True, compute_dtype=dtype, device="cpu")
    feats = _features()
    with torch.no_grad():
        acc = model(feats, torch.zeros(N, dtype=torch.int64))["acc"]
    assert torch.isfinite(acc).all()
    assert gathers == []
    assert len(calls) == 2
    for packed, sidx, phi in calls:
        assert tuple(packed.shape) == (N, 5 * H) and packed.dtype == getattr(torch, dtype)
        assert tuple(sidx.shape) == (N, K) and sidx.dtype == torch.int32
        assert tuple(phi.shape) == (N, K, R + 1)
    assert calls[0][1] is calls[1][1]  # made once per forward
    assert calls[0][1].tolist() == painn_msg.sender_index(feats["senders"], N).tolist()
