"""Port parity: case setup (features, batched eval preprocess, integrate)
against the JAX case functions, on synthetic 3D data, in float64.

The JAX case runs its Pallas neighbor kernel in interpret mode; both sides
build the same dense (N, K) graph, so senders compare for equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.case import case_builder as jax_case_builder
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.data.synthetic import make_synthetic_arrays

ISL = 4


def _setup(pbc: bool):
    splits, metadata = make_synthetic_arrays(
        n_particles=125, dim=3, box=1.0, seq_len_train=12, seq_len_eval=12, n_trajs=2
    )
    metadata = dict(metadata)
    if not pbc:
        metadata["periodic_boundary_conditions"] = [False] * 3
    kw = dict(
        box=[1.0] * 3, metadata=metadata, input_seq_length=ISL,
        cfg_model={"magnitude_features": True}, noise_std=1e-4,
    )
    ref = jax_case_builder(cfg_neighbors={"backend": "pallas"}, dtype=jnp.float64, **kw)
    port = case_builder(cfg_neighbors={"backend": "auto"}, dtype=torch.float64,
                        device="cpu", **kw)
    pos = np.stack([t.transpose(1, 0, 2) for t in splits["test"]])  # (B, N, T, dim)
    ptype = np.zeros(pos.shape[:2], np.int32)
    ptype[1, -7:] = -1  # padding in the second sample
    return ref, port, pos, ptype


_FEATURES = ("vel_hist", "vel_mag", "rel_disp", "rel_dist", "senders", "receivers")


@pytest.mark.parametrize("pbc", [True, False])
def test_allocate_eval_features(pbc):
    """allocate_eval on one sample: equal senders; features within 1e-12."""
    ref, port, pos, ptype = _setup(pbc)
    sample = (pos[0, :, :ISL], ptype[0])
    rf, rn = ref.allocate_eval(sample)
    pf, pn = port.allocate_eval(sample)
    keys = _FEATURES + (() if pbc else ("bound",))
    assert set(keys) <= set(pf)
    for k in keys:
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(rf[k]), rtol=0, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_array_equal(pn.idx.numpy(), np.asarray(rn.idx))


def test_preprocess_eval_batched_and_integrate():
    """The flat super-graph of a batch of 2 and one integration step."""
    ref, port, pos, ptype = _setup(True)
    _, rn = ref.allocate_eval((pos[0, :, :ISL], ptype[0]))
    _, pn = port.allocate_eval((pos[0, :, :ISL], ptype[0]))
    rn_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), rn)
    window = pos[:, :, 1 : ISL + 1]
    rf, rn_b = ref.preprocess_eval_batched((window, ptype), rn_b)
    pf, pn_b = port.preprocess_eval_batched((window, ptype), pn.broadcast(2))
    for k in _FEATURES:
        np.testing.assert_allclose(pf[k].numpy(), np.asarray(rf[k]), rtol=0, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_array_equal(pn_b.idx.numpy(), np.asarray(rn_b.idx))
    np.testing.assert_array_equal(
        pn_b.did_buffer_overflow.numpy(), np.asarray(rn_b.did_buffer_overflow)
    )

    acc = np.random.default_rng(0).normal(size=(2, pos.shape[1], 3))
    want = jax.vmap(ref.integrate)({"acc": jnp.asarray(acc)}, jnp.asarray(window))
    got = port.integrate({"acc": torch.as_tensor(acc)}, torch.as_tensor(window))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    stats = {k: {s: v.numpy() for s, v in d.items()} for k, d in port.normalization_stats.items()}
    for k, d in ref.normalization_stats.items():
        for s, v in d.items():
            np.testing.assert_allclose(stats[k][s], np.asarray(v), rtol=1e-15)
