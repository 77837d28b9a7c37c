"""Port parity at GNS-5-64, the narrower of the two published GNS models
(LagrangeBench's baseline table): the fused processor at latent width 64
and 5 message-passing steps, on the CPU against the JAX package.

* The forward, float64: the port's plain path against JAX's fused GNS (its
  CPU mirror), atol 1e-9 on acc before the final float32 cast.
* One training step's loss and gradients, float64, as
  ``tests/test_torch_train.py`` holds GNS-2-16.
* The runner: ``python -m lagrangebench_torch config=<yaml> gpu=-1
  mode=all model.num_mp_steps=5 model.latent_dim=64`` trains and infers on
  a small synthetic dataset; the JAX runner's ``mode=infer`` on the port's
  checkpoint gives the port's metrics, rtol 1e-5.
* The widths the CUDA kernels take (``fused_mp.kernel_width``): 1 to
  256 pass the check (64 and 128 compiled as they are, 96 padded to 128),
  wider ones raise ValueError naming the limit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu import cli as jax_cli
from lagrangebench_tpu.data.synthetic import make_synthetic_dataset
from lagrangebench_tpu.models import GNS as JaxGNS
from lagrangebench_tpu.models.base import make_model_fns
from lagrangebench_tpu.train import trainer as jax_trainer
from lagrangebench_torch import checkpoint, cli
from lagrangebench_torch.case import case_builder
from lagrangebench_torch.config import from_dotlist, load_with_extends, merge
from lagrangebench_torch.data.synthetic import make_synthetic_arrays
from lagrangebench_torch.defaults import defaults
from lagrangebench_torch.models import GNS
from lagrangebench_torch.ops import fused_mp
from lagrangebench_torch.train import flat_mse_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATENT, MP_STEPS = 64, 5  # GNS-5-64
N, K, DIM, ISL = 48, 8, 3, 4
OVERRIDES = [f"model.num_mp_steps={MP_STEPS}", f"model.latent_dim={LATENT}"]


def _features(seed=0):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, N, size=(N, K)).astype(np.int32)
    senders[rng.uniform(size=(N, K)) < 0.3] = N
    valid = (senders < N)[..., None]
    rel_disp = np.where(valid, rng.uniform(-1, 1, size=(N, K, DIM)), 0.0)
    feats = {
        "vel_hist": rng.normal(size=(N, (ISL - 1) * DIM)),
        "senders": senders,
        "receivers": np.broadcast_to(np.arange(N, dtype=np.int32)[:, None], (N, K)).copy(),
        "rel_disp": rel_disp,
        "rel_dist": np.linalg.norm(rel_disp, axis=-1, keepdims=True),
    }
    ptype = rng.integers(0, 3, size=N).astype(np.int32)
    ptype[-5:] = -1  # padding wraps to the last embedding row
    return feats, ptype


def _jax_model():
    return JaxGNS(particle_dimension=DIM, latent_size=LATENT, num_mp_steps=MP_STEPS,
                  use_fused_processor=True, compute_dtype="float64")


def _perturbed(params, seed):
    """Biases off zero and scales off one, so every parameter matters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float64) + 0.05 * rng.normal(size=x.shape),
                        jax.device_get(params))


def _port_model():
    return GNS(DIM, node_in=(ISL - 1) * DIM, edge_in=DIM + 1, latent_size=LATENT,
               num_mp_steps=MP_STEPS, compute_dtype="float64", device="cpu").double()


def test_gns64_forward_float64_matches_jax():
    """GNS-5-64's acc before the float32 cast, from JAX-initialised
    weights carried across by ``load_jax_params``: atol 1e-9."""
    feats, ptype = _features()
    sample = ({k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ptype))
    jmodel = _jax_model()
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), sample)["params"], 1)
    _, inter = jmodel.apply({"params": params}, sample, capture_intermediates=True)
    want = np.asarray(inter["intermediates"]["MLP_1"]["__call__"][0])

    model = _port_model()
    model.load_jax_params(params)
    assert len(model.mp_steps) == MP_STEPS and model.mp_steps[0]["w_e"].shape == (64, 64)
    captured = {}
    hook = model.decoder.register_forward_hook(lambda m, i, o: captured.setdefault("acc", o))
    with torch.no_grad():
        out = model({k: torch.as_tensor(v) for k, v in feats.items()}, torch.as_tensor(ptype))
    hook.remove()
    assert out["acc"].shape == (N, DIM)
    np.testing.assert_allclose(captured["acc"].numpy(), want, rtol=0, atol=1e-9)


def test_gns64_train_step_loss_and_grads_match_jax():
    """flat_mse_loss of GNS-5-64 and its gradient (the fused processor's
    backward) against jax.value_and_grad of the JAX loss on the same
    weights and batch, float64: loss rtol 1e-12, gradients atol 1e-9."""
    n = 125
    splits, metadata = make_synthetic_arrays(n_particles=n, dim=DIM, box=1.0,
                                             seq_len_train=12, seq_len_eval=12, n_trajs=2)
    pos = np.stack([t.transpose(1, 0, 2) for t in splits["train"]])[:, :, :ISL + 1]
    ptype = np.zeros(pos.shape[:2], np.int32)
    ptype[0, :4] = 1  # walls: kinematic, no noise, no loss
    port = case_builder([1.0] * DIM, metadata, ISL, cfg_neighbors={"backend": "auto"},
                        noise_std=3e-4, dtype=torch.float64, device="cpu")
    _, nbrs = port.allocate_eval((pos[0, :, :ISL], ptype[0]))
    draw = torch.as_tensor(np.random.default_rng(2).normal(size=(2, n, ISL - 1, DIM)))
    feats, targets, _ = port.preprocess_batched(None, (pos, ptype), 3e-4, nbrs.broadcast(2), 0,
                                                draw=draw)
    non_kin = ptype == 0
    node_weight = (non_kin / non_kin.sum(1)[:, None]).reshape(-1)
    flat_ptype = ptype.reshape(-1)
    loss_weight = {"acc": 1.0, "vel": 0.0, "pos": 0.0}

    jfeats = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    init, apply = make_model_fns(_jax_model())
    params, state = init(jax.random.PRNGKey(0), (jfeats, jnp.asarray(flat_ptype)))
    params = _perturbed(params, 3)
    jtargets = {k: jnp.asarray(v.numpy()) for k, v in targets.items()}
    (loss_ref, _), grads_ref = jax.value_and_grad(jax_trainer.flat_mse_loss, has_aux=True)(
        params, state, jfeats, jnp.asarray(flat_ptype), jtargets, jnp.asarray(node_weight),
        apply, loss_weight,
    )

    model = _port_model()
    model.load_jax_params(params)
    loss = flat_mse_loss(model, feats, torch.as_tensor(flat_ptype), targets,
                         torch.as_tensor(node_weight), loss_weight)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-12)
    flat_ref = {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
        for path, g in jax.tree_util.tree_flatten_with_path(grads_ref)[0]
    }
    leaves = model.jax_leaves()
    assert [name for name, _, _ in leaves] == list(flat_ref)
    for name, p, transposed in leaves:
        g = p.grad.t() if transposed else p.grad
        np.testing.assert_allclose(g.numpy(), flat_ref[name], rtol=1e-7, atol=1e-9,
                                   err_msg=name)


def _yaml(root, src):
    """A small fused-processor GNS run (GNS-2-16 until the overrides)."""
    text = (
        "extends: LAGRANGEBENCH_DEFAULTS\n"
        "dtype: float64\n"
        f"dataset:\n  src: {src}\n"
        "model:\n  name: gns\n  fused_processor: true\n  num_mp_steps: 2\n  latent_dim: 16\n"
        f"  input_seq_length: {ISL}\n"
        "train:\n  batch_size: 2\n  step_max: 2\n"
        "  pushforward:\n    steps: [-1]\n    unrolls: [0]\n    probs: [1]\n"
        f"eval:\n  n_rollout_steps: 3\n  rollout_dir: {root}/rollouts\n"
        "  train:\n    n_trajs: 1\n"
        "  infer:\n    batch_size: 2\n    metrics: [mse, e_kin, sinkhorn]\n    out_type: none\n"
        f"logging:\n  log_steps: 1\n  eval_steps: 2\n  ckp_dir: {root}/ckp\n"
        "neighbors:\n  backend: auto\n"
    )
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def test_gns64_mode_all_matches_jax_infer(tmp_path):
    """The port's CLI with the GNS-5-64 overrides trains and infers; its
    checkpoint holds 5 steps of 64-wide weights and its config the
    overrides; the JAX runner infers that checkpoint with the port's
    metrics, rtol 1e-5."""
    root = str(tmp_path)
    src = make_synthetic_dataset(root, n_particles=125, dim=3, box=1.0, seq_len_train=12,
                                 seq_len_eval=ISL + 3, n_trajs=2)
    cfg = _yaml(root, src)
    got = cli.main([f"config={cfg}", "gpu=-1", "mode=all", *OVERRIDES])
    (run,) = os.listdir(os.path.join(root, "ckp"))
    run_dir = os.path.join(root, "ckp", run)
    params = checkpoint.load_checkpoint(run_dir)[0]
    widths = {k: np.shape(v) for k, v in params.items() if k.endswith("_w_e")}
    assert sorted(widths) == [f"mp{i}_w_e" for i in range(MP_STEPS)]
    assert set(widths.values()) == {(LATENT, LATENT)}
    want = jax_cli.main([f"config={cfg}", f"load_ckp={run_dir}", "mode=infer", *OVERRIDES])
    assert set(got) == set(want)
    for key in want:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-12, err_msg=key)


def test_shipped_gns_config_with_gns64_overrides():
    """``configs/rpf_3d/gns.yaml`` with the overrides is GNS-5-64 on the
    fused processor in bf16 with the dense K1 + K2 search, as a user gets
    it from the CLI."""
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        cfg = merge(load_with_extends("configs/rpf_3d/gns.yaml", defaults),
                    from_dotlist(OVERRIDES))
    finally:
        os.chdir(cwd)
    m = cfg.model
    assert (m.name, m.num_mp_steps, m.latent_dim) == ("gns", MP_STEPS, LATENT)
    assert m.fused_processor and m.compute_dtype == "bfloat16" and m.num_mlp_layers == 2
    assert cfg.neighbors.backend == "auto" and cfg.neighbors.format == "dense"
    assert LATENT in fused_mp.LATENTS


@pytest.mark.parametrize("f", [64, 128])
def test_check_latent_accepts_the_compiled_widths(f):
    fused_mp.check_latent(f, "fused_mp")


@pytest.mark.parametrize("f", [96, 256])
def test_check_latent_takes_the_other_widths_to_the_limit(f):
    """A width between the compiled instances, or the widest instance,
    runs on the card: the check passes and names the instance that runs
    it (96 padded to 128; 256 itself)."""
    fused_mp.check_latent(f, "fused_mp")
    assert fused_mp.kernel_width(f) == {96: 128, 256: 256}[f]


@pytest.mark.parametrize("f", [1025, 0])
def test_check_latent_refuses_widths_past_the_limit(f):
    """A width below 1 raises ValueError that names the widths the kernels
    take (no fallback to the plain version on the card); past the old limit
    of 1,024 every width is taken (the wide path's row kernels walk a row in
    chunks)."""
    if f >= 1:
        for wide in (f, 1088, 4096):
            fused_mp.check_latent(wide, "fused_mp")
        return
    with pytest.raises(ValueError, match=r"latent width %d .*widths from 1 on" % f):
        fused_mp.check_latent(f, "fused_mp")
