"""The float32 error of K5's tensor-core design against the CPU, across
seeds and widths, and the product it comes from.

    python -m lagrangebench_torch.experiments.k5_error [--tree DIR] [--label NAME]
        [--hidden 320,512] [--seeds 5]

- PaiNN-2-H in the fused layout (``configs/rpf_3d/painn.yaml``'s model
  with 2 layers at hidden width H), weights from each seed: one forward of
  a batch of 2 x 1,000 synthetic RPF-3D-scale particles on the card (K5)
  and on the CPU (its plain version), TF32 off; max |acc_card - acc_cpu| /
  max |acc_cpu|, the reading ``chip_smoke.py``'s PaiNN-2-320 card-vs-CPU
  check gates at 1e-5 (its seed 0).
- Where the error comes from (trees with the tensor-core design, H > 256):
  the first layer's inputs of the seed-0 forward through K5 on the card,
  its intermediates kept (``ops/painn_msg.py`` tc_buffers); then the
  layer's outputs in float64 from the kernel's own results up to stage i
  and the float64 stages after it (0: from the inputs; 1: from the edge
  kernel's s1 and v1; 2: also kVmix's vl, |vr| and sum_d vr_d vl_d; 3:
  also kMix1's z; 4: the kernel's outputs). out_i - out_{i-1} is the error
  stage i adds, carried to the outputs exactly; each printed as max |.| /
  max |out_0| over s_out and v_out, and the whole (out_4 - out_0) beside.

``--tree DIR`` imports ``lagrangebench_torch`` from the checkout at DIR
(as ``mp_times.py``), so that two designs are read on the same data in one
call. Prints one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

N_SAMPLE, DIM, BATCH = 1000, 3, 2


def _cfg(hidden: int):
    from lagrangebench_torch.config import Config, merge
    from lagrangebench_torch.defaults import defaults

    return merge(defaults, Config({"model": {
        "name": "painn", "num_mp_steps": 2, "latent_dim": hidden, "isotropic_norm": True,
        "magnitude_features": True, "fused_processor": True}}))


def _positions(torch, isl: int):
    import numpy as np

    from lagrangebench_torch.data.synthetic import make_synthetic_arrays

    splits, metadata = make_synthetic_arrays(
        n_particles=N_SAMPLE, dim=DIM, box=1.0, dx=1.0 / round(N_SAMPLE ** (1 / DIM)),
        seq_len_train=12, seq_len_eval=isl + 1, n_trajs=BATCH, name="RPF")
    pos = np.stack([t.transpose(1, 0, 2)[:, :isl] for t in splits["test"]])
    return torch.as_tensor(pos, dtype=torch.float32), metadata


def _forward(torch, cfg, pos, metadata, seed, device):
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.models import setup_model

    isl = int(cfg.model.input_seq_length)
    case = case_builder([1.0] * DIM, metadata, isl, cfg_neighbors=cfg.neighbors,
                        cfg_model=cfg.model, noise_std=cfg.train.noise_std, device=device)
    model = setup_model(cfg.model, metadata, seed=seed, device=device)
    pos = pos.to(device)
    ptype = torch.zeros(pos.shape[:2], dtype=torch.int64, device=device)
    _, nbrs = case.allocate_eval((pos[0], ptype[0]))
    with torch.no_grad():
        feats, _ = case.preprocess_eval_batched((pos, ptype), nbrs.broadcast(BATCH))
        return model(feats, ptype.reshape(-1))["acc"].cpu()


def _edge64(torch, painn_msg, packed, sidx, phi, nd, s, v, p):
    """s1 (N, H) and v1 (N, DIM, H) in float64 from the layer's inputs."""
    h, dim, r = s.shape[-1], nd.shape[-1], phi.shape[-1] - 1
    g = packed.double()[sidx.long().clamp(0, packed.shape[0] - 1)]
    w = (phi[..., :r].double() @ p["filt_w"].double() + p["filt_b"].double()) * phi[..., r:]
    s1 = s.double() + painn_msg._clip(torch.sum(w[..., :h] * g[..., :h], dim=1))
    msg1 = w[..., h:2 * h] * g[..., h:2 * h]
    v1 = torch.stack([v.double()[:, d * h:(d + 1) * h] + painn_msg._clip(torch.sum(
        nd[..., d:d + 1].double() * msg1 + w[..., 2 * h:] * g[..., (2 + d) * h:(3 + d) * h],
        dim=1)) for d in range(dim)], dim=1)
    return s1, v1


def _vmix64(torch, v1, p):
    """vl (N, DIM, H), |vr| (N, H) and sum_d vr_d vl_d (N, H) in float64."""
    h = v1.shape[-1]
    vm = v1 @ p["vmix_w"].double()
    vl, vr = vm[..., :h], vm[..., h:]
    return vl, torch.sqrt(torch.sum(vr * vr, dim=1) + 1e-8), torch.sum(vr * vl, dim=1)


def _mix1_64(torch, s1, nrm, p):
    z = torch.cat([s1, nrm], dim=-1) @ p["mix_w1"].double() + p["mix_b1"].double()
    return z * torch.sigmoid(z)


def _out64(painn_msg, z, s1, v1, vl, dot, p):
    h = z.shape[-1]
    m = z @ p["mix_w2"].double() + p["mix_b2"].double()
    s_out = s1 + painn_msg._clip(m[:, :h] + m[:, 2 * h:] * dot)
    v_out = v1 + painn_msg._clip(vl * m[:, None, h:2 * h])
    return s_out, v_out.reshape(v_out.shape[0], -1)


def _stages(torch, painn_msg, args):
    """The per-stage errors of one K5 launch on ``args`` (see the module
    docstring), relative to the float64 outputs' largest magnitude."""
    real, bufs = painn_msg.tc_buffers, []

    def keep(*a, **k):
        bufs.extend(real(*a, **k))
        return tuple(bufs)

    painn_msg.tc_buffers = keep
    try:
        got = painn_msg.painn_layer_kernel(*args)
    finally:
        painn_msg.tc_buffers = real
    torch.cuda.synchronize()
    p = args[-1]
    h = args[4].shape[-1]
    v1k, tsk, zk, vlk, dotk = (b[..., :h].double() for b in bufs)
    s1k, nrmk = tsk[:, 0], tsk[:, 1]
    s1, v1 = _edge64(torch, painn_msg, *args)
    vl, nrm, dot = _vmix64(torch, v1, p)
    outs = [_out64(painn_msg, _mix1_64(torch, s1, nrm, p), s1, v1, vl, dot, p)]
    vl, nrm, dot = _vmix64(torch, v1k, p)
    outs.append(_out64(painn_msg, _mix1_64(torch, s1k, nrm, p), s1k, v1k, vl, dot, p))
    outs.append(_out64(painn_msg, _mix1_64(torch, s1k, nrmk, p), s1k, v1k, vlk, dotk, p))
    outs.append(_out64(painn_msg, zk, s1k, v1k, vlk, dotk, p))
    outs.append(tuple(o.double() for o in got))
    scale = max(float(o.abs().max()) for o in outs[0])

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b)) / scale

    names = ("edge", "kVmix", "kMix1", "kOut")
    out = {name: diff(outs[i + 1], outs[i]) for i, name in enumerate(names)}
    out["all"] = diff(outs[4], outs[0])
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None, help="checkout whose lagrangebench_torch is read")
    ap.add_argument("--label", default=None)
    ap.add_argument("--hidden", default="320,512", help="comma-separated hidden widths")
    ap.add_argument("--seeds", type=int, default=5, help="weight seeds 0 .. N - 1")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.tree or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)
    import torch

    from lagrangebench_torch.ops import painn_msg

    if not torch.cuda.is_available():
        raise RuntimeError("k5_error needs a CUDA device")
    if not painn_msg.__file__.startswith(root):
        raise RuntimeError(f"imported {painn_msg.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"label": args.label or root, "card": torch.cuda.get_device_name(0)}
    for h in (int(x) for x in args.hidden.split(",")):
        cfg = _cfg(h)
        pos, metadata = _positions(torch, int(cfg.model.input_seq_length))
        errs = []
        for seed in range(args.seeds):
            seen, real = [], painn_msg.painn_layer_kernel

            def record(*a, seen=seen, real=real):
                seen.append(a)
                return real(*a)

            painn_msg.painn_layer_kernel = record
            try:
                card = _forward(torch, cfg, pos, metadata, seed, "cuda")
            finally:
                painn_msg.painn_layer_kernel = real
            cpu = _forward(torch, cfg, pos, metadata, seed, "cpu")
            errs.append(float((card - cpu).abs().max() / cpu.abs().max()))
            if seed == 0 and hasattr(painn_msg, "tc_buffers") and seen:
                out[f"stages_{h}"] = _stages(torch, painn_msg, seen[0])
            del seen
        out[f"acc_err_{h}"] = errs
        out[f"acc_err_{h}_max"] = max(errs)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
