"""Port parity for the whole slice: ``infer`` with a small fused GNS on a 3D
periodic synthetic dataset (batch 2, 5 rollout steps) against the JAX
``infer`` with ``backend: pallas`` (interpret mode) and the same weights.

Tolerances: predicted positions atol 1e-5 (float32 model on both sides),
metrics rtol 1e-4.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lagrangebench_tpu.case import case_builder as jax_case_builder
from lagrangebench_tpu.data import H5Dataset as JaxH5Dataset
from lagrangebench_tpu.data.synthetic import make_synthetic_dataset
from lagrangebench_tpu.evaluate import infer as jax_infer
from lagrangebench_tpu.models import GNS as JaxGNS
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.data import H5Dataset
from lagrangebench_torch.evaluate import infer
from lagrangebench_torch.models import GNS, gns_input_sizes

ISL, STEPS, LATENT, MP = 4, 5, 16, 2
CFG = {"batch_size": 2, "metrics": ["mse", "e_kin", "sinkhorn"], "metrics_stride": 1,
       "out_type": "pkl", "n_trajs": -1}
CASE = dict(cfg_model={"isotropic_norm": False}, noise_std=0.0)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float64)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    path = make_synthetic_dataset(str(root), n_particles=125, dim=3, box=1.0,
                                  seq_len_train=12, seq_len_eval=ISL + STEPS, n_trajs=2)

    data = JaxH5Dataset("test", path, input_seq_length=ISL, extra_seq_length=STEPS)
    meta = data.metadata
    case = jax_case_builder([1.0] * 3, meta, ISL, cfg_neighbors={"backend": "pallas"},
                            **CASE)
    model = JaxGNS(particle_dimension=3, latent_size=LATENT, num_mp_steps=MP,
                   use_fused_processor=True, compute_dtype="float32")
    pos, ptype = data[0]
    feats, _ = case.allocate_eval((pos[:, :ISL], ptype))
    params = model.init(jax.random.PRNGKey(3), (feats, jnp.asarray(ptype)))["params"]
    rng = np.random.default_rng(0)  # perturb zero biases / unit scales
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        jax.device_get(params),
    )
    jax_dir = str(root / "jax")
    ref = jax_infer(model, case, data, params=params, cfg_eval_infer=CFG,
                    rollout_dir=jax_dir, n_rollout_steps=STEPS)

    pdata = H5Dataset("test", path, input_seq_length=ISL, extra_seq_length=STEPS)
    pcase = case_builder([1.0] * 3, meta, ISL, cfg_neighbors={"backend": "auto"},
                         device="cpu", **CASE)
    node_in, edge_in = gns_input_sizes(meta, ISL)
    pmodel = GNS(3, node_in, edge_in, latent_size=LATENT, num_mp_steps=MP,
                 compute_dtype="float32", device="cpu")
    pmodel.load_jax_params(params)
    port_dir = str(root / "port")
    ours = infer(pmodel, pcase, pdata, cfg_eval_infer=CFG, rollout_dir=port_dir,
                 n_rollout_steps=STEPS, device="cpu")
    return ref, ours, jax_dir, port_dir


def test_predicted_positions_match(runs):
    _, _, jax_dir, port_dir = runs
    for i in range(2):
        with open(os.path.join(jax_dir, f"rollout_{i}.pkl"), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(port_dir, f"rollout_{i}.pkl"), "rb") as f:
            got = pickle.load(f)
        assert got["predicted_rollout"].shape == (ISL + STEPS, 125, 3)
        np.testing.assert_allclose(got["predicted_rollout"],
                                   np.asarray(want["predicted_rollout"]), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["ground_truth_rollout"],
                                      np.asarray(want["ground_truth_rollout"]))
    assert any(f.startswith("metrics") for f in os.listdir(port_dir))


def test_metrics_match(runs):
    ref, ours, _, _ = runs
    assert sorted(ours) == sorted(ref) == ["rollout_0", "rollout_1"]
    for name in ref:
        want, got = _flat(ref[name]), _flat(ours[name])
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0, err_msg=k)
        assert np.all(want["mse"] > 0)  # the model is not a replay
