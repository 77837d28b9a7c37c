"""The port's two-rank training against the JAX package's ``Trainer`` on a
two-device mesh (``make_mesh(2)`` over the virtual CPU devices that
``conftest.py`` sets up), float64, from one parameter tree.

The two packages draw their noise from different generators, so the run is
``noise_std=0``; batches and pushforward unroll counts come from the same
seeded numpy Generator on both sides. With ``tests/test_sharding.py`` (JAX
mesh = JAX single) and ``tests/test_torch_train.py`` (JAX single = port
single) and ``tests/test_torch_parallel.py`` (port single = port mesh) this
closes the chain: parameters within 1e-9 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np

from lagrangebench_tpu.case import case_builder as jax_case_builder
from lagrangebench_tpu.config import Config as JaxConfig
from lagrangebench_tpu.models import setup_model as jax_setup_model
from lagrangebench_tpu.parallel import make_mesh
from lagrangebench_tpu.train import Trainer as JaxTrainer
from lagrangebench_torch.checkpoint import flatten_tree

from . import _torch_dp_worker as w


def test_two_ranks_train_as_the_jax_mesh(tmp_path):
    train_d, valid_d, _ = w.data()
    metadata = train_d.metadata
    cfg_model = JaxConfig({"name": "gns", "fused_processor": False, "compute_dtype": "float64",
                           "num_mp_steps": w.MP_STEPS, "latent_dim": w.LATENT,
                           "num_mlp_layers": 2, "input_seq_length": w.ISL,
                           "magnitude_features": False, "isotropic_norm": False})
    case = jax_case_builder(box=[1.0] * w.DIM, metadata=metadata, input_seq_length=w.ISL,
                            cfg_neighbors={"backend": "pallas"}, cfg_model=cfg_model,
                            noise_std=0.0, dtype=jnp.float64)
    _, init, apply = jax_setup_model(cfg_model, metadata)
    pos, ptype = train_d[0]
    _, features, _, _ = case.allocate(jax.random.PRNGKey(0),
                                      (jnp.asarray(pos), jnp.asarray(ptype)))
    params, _ = init(jax.random.PRNGKey(1), (features, jnp.asarray(ptype)))
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), params)

    trainer = JaxTrainer(
        (init, apply), case, train_d, valid_d,
        cfg_train={"batch_size": w.BATCH, "noise_std": 0.0, "optimizer": {"lr_start": 1e-3},
                   "pushforward": w.PUSHFORWARD},
        cfg_eval={"n_rollout_steps": 3, "train": {"n_trajs": 1}},
        cfg_logging={"log_steps": 1, "eval_steps": 10**9},
        input_seq_length=w.ISL, seed=0, mesh=make_mesh(2),
    )
    want, _, _ = trainer.train(step_max=2, params=params)
    want = flatten_tree(jax.tree.map(np.asarray, want))

    ranks = w.run_ranks([("train", {"processor": "standard", "noise_std": 0.0,
                                    "params": params})], str(tmp_path))
    start = flatten_tree(params)
    assert all(not np.array_equal(want[k], start[k]) for k in want)  # every leaf trained
    top = max(float(np.abs(v).max()) for v in want.values())
    for rank in ranks:
        got = rank[0]
        assert got["count"] == 3 and set(got["params"]) == set(want)
        for k in want:
            np.testing.assert_allclose(got["params"][k], want[k], rtol=0, atol=1e-9 * top,
                                       err_msg=k)
