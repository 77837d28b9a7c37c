"""Port parity: rollout metrics (mse, mae, e_kin, debiased Sinkhorn)
against the JAX MetricsComputer, float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.evaluate import MetricsComputer as JaxMetrics
from lagrangebench_tpu.evaluate import averaged_metrics as jax_averaged
from lagrangebench_tpu.ops import periodic as jax_periodic
from lagrangebench_torch.evaluate import MetricsComputer, averaged_metrics
from lagrangebench_torch.ops import space

META = {"dt": 0.005, "write_every": 10, "dx": 0.1, "dim": 3}


def _rollouts(seed):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0, 1, size=(7, 30, 3))
    pred = np.mod(target + rng.normal(0, 0.02, size=target.shape), 1.0)
    return pred, target


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("stride", [1, 3])
def test_metrics_match_jax(stride):
    """Every metric within rtol 1e-8 (Sinkhorn runs the same iterations;
    logsumexp rounds differently in the last bits)."""
    pred, target = _rollouts(stride)
    names = ["mse", "mae", "e_kin", "sinkhorn"]
    ref = JaxMetrics(names, jax_periodic(jnp.asarray(1.0))[0], META, stride=stride)(
        jnp.asarray(pred), jnp.asarray(target)
    )
    side = torch.tensor(1.0, dtype=torch.float64)
    ours = MetricsComputer(names, space.periodic(side)[0], META, stride=stride)(
        torch.as_tensor(pred), torch.as_tensor(target)
    )
    want, got = _flat(ref), _flat(ours)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=0, err_msg=k)

    avg = averaged_metrics({"rollout_0": _flat_tensors(ours)})
    avg_ref = jax_averaged({"rollout_0": ref})
    assert avg.keys() == avg_ref.keys()
    for k in avg:
        np.testing.assert_allclose(avg[k], avg_ref[k], rtol=1e-8, atol=1e-15)


def _flat_tensors(m):
    return {
        k: ({s: t.numpy() for s, t in v.items()} if isinstance(v, dict) else v.numpy())
        for k, v in m.items()
    }


def test_sinkhorn_of_identical_clouds_is_zero():
    pred, _ = _rollouts(5)
    side = torch.tensor(1.0, dtype=torch.float64)
    m = MetricsComputer(["sinkhorn"], space.periodic(side)[0], META, stride=1)
    s = m(torch.as_tensor(pred), torch.as_tensor(pred))["sinkhorn"]
    np.testing.assert_allclose(s.numpy(), 0.0, atol=1e-12)
