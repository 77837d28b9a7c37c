"""Device times of the port's redesigned kernels at the main paths' shapes,
for this checkout or another one.

    python lagrangebench_torch/experiments/mp_times.py [--tree DIR] [--label NAME]
        [--only gns,painn,scan]

- K3 and K4 (the fused GNS message-passing step and its backward): seeded
  random inputs at the GNS rollout shape (16,000 receivers x K = 40, F =
  128, bf16: batch 2 x 8,000 particles): K3's plain step, K3's
  encoder-folded step (raw edge features of width 4) and K4.
- K5 (the fused PaiNN layer) at the PaiNN rollout shape (16,000 receivers
  x K = 40, float32, H = 128, R = 20) on the dense neighbor list of a batch
  of 2 of the synthetic RPF-3D-scale data that ``chip_smoke.py`` drives
  (``data.synthetic.make_synthetic_arrays``, 8,000 particles in 3D), the
  values seeded. A tree whose K5 takes the gathered rows
  ``g`` is timed as ``gather_rows(packed, sidx)`` + K5, the layer's forward
  in that tree; one whose K5 gathers itself as K5 alone. Also the fused
  PaiNN-5-128 forward and forward + backward on those neighbors.
- K2, K9 and K7 (the column-stencil scan) on the inputs the neighbor update
  gives them on the port's own grid positions (``experiments/_setup.py``,
  8,000 particles in 3D, the second sample the first reversed): dense at
  batch 2, dense with the geometry at batch 2, the slot layout at batch 1.
- K1 with what builds the column table around it, at batch 2 and batch 1 of
  the synthetic RPF-3D-scale data: in a tree with ``column_table`` the
  kernel; in an older one its ``_column_table`` (the three-pass K1 and the
  PyTorch ops around it) and ``_with_sentinel``. Also the device time of a
  whole dense neighbor update at batch 2 and the device kernels it
  launches, counted in a torch.profiler trace.
- The GNS-10-128 bf16 dense rollout at batch 2 of the same data, seeded
  weights: ms per step on the host clock (20 steps, three runs after one
  that warms up), the path every rollout's neighbor update runs.

Each is timed with CUDA events with the card's queue filled ahead
(``profiling.device_ms``) and checked against its plain version. ``--tree
DIR`` imports ``lagrangebench_torch`` from the checkout at DIR instead (an
earlier commit unpacked with ``git archive``, or a scratch copy with a
variant of a kernel), so that versions are timed on the same inputs and the
same card, in one call; ``--only`` times a subset. Prints one JSON line.
Needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
from typing import Optional, Sequence

N, K = 16000, 40
N_SAMPLE, DIM, ISL = 8000, 3, 6


def _inputs(fused_mp, torch, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    f, cdt = fused_mp.LATENT, torch.bfloat16
    p = {name: (torch.randn(f, f, generator=g) / f**0.5 if name.startswith("w")
                else 0.1 * torch.randn(f, generator=g) + (1.0 if "scale" in name else 0.0))
         for name in fused_mp.PARAM_NAMES}
    enc = {"enc_w1": torch.randn(4, f, generator=g), "enc_w2": torch.randn(f, f, generator=g) / f**0.5,
           "enc_b1": torch.zeros(f), "enc_b2": torch.zeros(f),
           "enc_ln_scale": torch.ones(f), "enc_ln_bias": torch.zeros(f)}
    t = {"e": torch.randn(N, K, f, generator=g).to(cdt), "raw": torch.randn(N, K, 4, generator=g)}
    for name, shape in (("hs", (N, K, f)), ("hr", (N, f)), ("h", (N, f)), ("ge", (N, K, f)),
                        ("gh", (N, f))):
        t[name] = torch.randn(*shape, generator=g).to(cdt)
    t["mask"] = (torch.rand(N, K, generator=g) < 0.7).to(torch.float32)
    t = {name: v.to(device) for name, v in t.items()}
    p = {name: v.to(device) for name, v in fused_mp.kernel_params(p, cdt).items()}
    enc = {name: v.to(device) for name, v in fused_mp.kernel_params(enc, cdt).items()}
    return t, p, enc


def _err(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))


def _case(torch, device, **cfg_neighbors):
    """A case on the port's grid positions (8,000 particles in 3D) and the
    positions of a batch of 2 (the second sample the first reversed)."""
    import numpy as np

    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.experiments._setup import grid_positions, synthetic_metadata

    case = case_builder([1.0] * DIM, synthetic_metadata(N_SAMPLE, DIM), ISL,
                        cfg_neighbors={"backend": "auto", **cfg_neighbors}, device=device)
    pos = grid_positions(N_SAMPLE, DIM, 1.0, ISL)[:, :ISL]
    pos = torch.as_tensor(np.stack([pos, pos[::-1].copy()]), device=device)
    return case, pos, torch.zeros((2, N_SAMPLE), dtype=torch.int64, device=device)


def _scan_inputs(torch, device):
    """The inputs K2 (batch 2), K9 (batch 2) and K7 (batch 1) take in one
    preprocess each, recorded from the neighbor update."""
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    seen = {}
    names = ("neighbor_scan", "neighbor_scan_geometry", "slot_scan")
    real = {name: getattr(nlc, name) for name in names}

    def recorder(name):
        def call(pos, idx, bases, **kw):
            seen[name] = ((pos.clone(), idx.clone(), bases.clone()), kw)
            return real[name](pos, idx, bases, **kw)
        return call

    for name in names:
        setattr(nlc, name, recorder(name))
    try:
        for cfg, bsz in (({}, 2), ({"emit_geometry": True}, 2), ({"format": "slot"}, 1)):
            case, pos, ptype = _case(torch, device, **cfg)
            _, nbrs = case.allocate_eval((pos[0], ptype[0]))
            with torch.no_grad():
                case.preprocess_eval_batched((pos[:bsz], ptype[:bsz]), nbrs.broadcast(bsz))
    finally:
        for name in names:
            setattr(nlc, name, real[name])
    return {name: seen[name] + (real[name], getattr(nlc, f"{name}_plain")) for name in names}


def _painn_inputs(torch, device, seed=1):
    """K5's float32 inputs at the rollout shape: packed rows, the dense
    senders (fill N) of a batch of 2 of the synthetic RPF-3D-scale data,
    basis, directions, state and parameters, seeded."""
    import numpy as np

    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.data.synthetic import make_synthetic_arrays

    splits, metadata = make_synthetic_arrays(
        n_particles=N_SAMPLE, dim=DIM, box=1.0, dx=1.0 / round(N_SAMPLE ** (1 / DIM)),
        seq_len_train=12, seq_len_eval=ISL + 1, n_trajs=2, name="RPF")
    pos = np.stack([t.transpose(1, 0, 2)[:, :ISL] for t in splits["test"]])
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    ptype = torch.zeros(pos.shape[:2], dtype=torch.int64, device=device)
    case = case_builder([1.0] * DIM, metadata, ISL, cfg_neighbors={"backend": "auto"},
                        cfg_model={"isotropic_norm": True, "magnitude_features": True},
                        device=device)
    _, nbrs = case.allocate_eval((pos[0], ptype[0]))
    with torch.no_grad():
        feats, _ = case.preprocess_eval_batched((pos, ptype), nbrs.broadcast(2))
    senders = feats["senders"]
    n, k = senders.shape
    g = torch.Generator().manual_seed(seed)
    h, r = 128, 20
    mask = (senders < n).float().cpu()
    t = {"packed": torch.randn(n, (2 + DIM) * h, generator=g),
         "phi": torch.cat([torch.rand(n, k, r, generator=g),
                           torch.rand(n, k, 1, generator=g) * mask[..., None]], dim=-1),
         "nd": torch.randn(n, k, DIM, generator=g), "s": torch.randn(n, h, generator=g),
         "v": torch.randn(n, DIM * h, generator=g)}
    p = {"filt_w": torch.randn(r, 3 * h, generator=g) / r**0.5,
         "filt_b": 0.1 * torch.randn(3 * h, generator=g),
         "vmix_w": torch.randn(h, 2 * h, generator=g) / h**0.5,
         "mix_w1": torch.randn(2 * h, h, generator=g) / (2 * h) ** 0.5,
         "mix_b1": 0.1 * torch.randn(h, generator=g),
         "mix_w2": torch.randn(h, 3 * h, generator=g) / h**0.5,
         "mix_b2": 0.1 * torch.randn(3 * h, generator=g)}
    t = {name: v.to(device) for name, v in t.items()}
    p = {name: v.to(device) for name, v in p.items()}
    return feats, senders, t, p


def _time_painn(torch, device, out):
    """K5 (with the gather in front of it where the tree's K5 takes the
    gathered rows) and the fused PaiNN-5-128 forward and train step."""
    from lagrangebench_torch.models import PaiNN
    from lagrangebench_torch.models.utils import gather_rows
    from lagrangebench_torch.ops import painn_msg
    from lagrangebench_torch.profiling import device_ms

    feats, senders, t, p = _painn_inputs(torch, device)
    n, k = senders.shape
    rest = (t["phi"], t["nd"], t["s"], t["v"], p)
    gather_in = "sidx" in inspect.signature(painn_msg.painn_layer_kernel).parameters
    idx = torch.clamp(senders, max=n - 1)
    if gather_in:
        sidx = idx.to(torch.int32).contiguous()
        args = (t["packed"], sidx) + rest
        out["k5_form"] = "K5 (gathers the sender rows)"
        got, want = painn_msg.painn_layer_kernel(*args), painn_msg.painn_layer_plain(*args)

        def layer():
            return painn_msg.painn_layer_kernel(*args)
    else:
        rows = idx.long()
        out["k5_form"] = "gather_rows + K5"
        g = gather_rows(t["packed"], rows)
        got, want = painn_msg.painn_layer_kernel(g, *rest), painn_msg.painn_layer_plain(g, *rest)
        out["k5_kernel_only_ms"] = device_ms(lambda: painn_msg.painn_layer_kernel(g, *rest), 20, 3)
        del g

        def layer():
            return painn_msg.painn_layer_kernel(gather_rows(t["packed"], rows), *rest)
    torch.cuda.synchronize()
    out["k5_N"], out["k5_K"] = n, k
    out["k5_max_rel_err"] = max(float((a - b).abs().max() / b.abs().max())
                                for a, b in zip(got, want))
    out["k5_ms"] = device_ms(layer, 20, 3)
    # bf16 on the same values: the relative 2-norm against the plain version
    bf = {name: v.to(torch.bfloat16) for name, v in t.items()}
    pb = painn_msg.layer_kernel_params(p, torch.bfloat16)
    rest_bf = (bf["phi"], bf["nd"], bf["s"], bf["v"], pb)
    lead = (bf["packed"], sidx) if gather_in else (gather_rows(bf["packed"], rows),)
    got = painn_msg.painn_layer_kernel(*lead, *rest_bf)
    want = painn_msg.painn_layer_plain(*lead, *rest_bf)
    torch.cuda.synchronize()
    out["k5_bf16_rel_l2"] = max(float((a.float() - b.float()).norm() / b.float().norm())
                                for a, b in zip(got, want))

    model = PaiNN(128, 5, 20, 1.5 * 0.0725, ISL - 1, fused=True, device=device)
    ptype = torch.zeros(n, dtype=torch.int64, device=device)

    def forward():
        return model(feats, ptype)["acc"]

    def train_step():
        model.zero_grad(set_to_none=True)
        forward().square().mean().backward()

    with torch.no_grad():
        out["painn_fused_forward_ms"] = device_ms(forward, 10, 2)
    out["painn_fused_forward_backward_ms"] = device_ms(train_step, 5, 2)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None, help="checkout whose lagrangebench_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", default="gns,painn,scan,k1,rollout",
                    help="comma-separated groups: gns (K3, K4), painn (K5), scan (K2, K7, K9), "
                         "k1 (K1 and the table build, the neighbor update), rollout (the "
                         "GNS-10-128 dense rollout)")
    args = ap.parse_args(argv)
    groups = set(args.only.split(","))
    root = os.path.abspath(args.tree or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)
    import torch

    from lagrangebench_torch.ops import fused_mp

    if not torch.cuda.is_available():
        raise RuntimeError("mp_times needs a CUDA device")
    if not fused_mp.__file__.startswith(root):
        raise RuntimeError(f"imported {fused_mp.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    out = {"label": args.label or root, "card": torch.cuda.get_device_name(0), "N": N, "K": K}
    if "gns" in groups:
        _time_gns(fused_mp, torch, device, out)
    if "painn" in groups:
        _time_painn(torch, device, out)
    if "scan" in groups:
        _time_scans(torch, device, out)
    if "k1" in groups:
        _time_k1(torch, device, out)
    if "rollout" in groups:
        _time_rollout(torch, device, out)
    print(json.dumps(out))
    return out


def _time_gns(fused_mp, torch, device, out):
    """K3 (plain and encoder-folded) and K4 on seeded random inputs."""
    from lagrangebench_torch.profiling import device_ms

    t, p, enc = _inputs(fused_mp, torch, device)
    plain = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], p)
    folded = (t["raw"], t["hs"], t["hr"], t["h"], t["mask"], p, enc)
    bwd = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], p, t["ge"], t["gh"])
    for name, fn, ref, call in (
        ("k3_plain", fused_mp.gns_mp_step, fused_mp.gns_mp_step_plain, plain),
        ("k3_encoder", fused_mp.gns_mp_step, fused_mp.gns_mp_step_plain, folded),
        ("k4", fused_mp.gns_mp_step_bwd, fused_mp.gns_mp_step_bwd_plain, bwd),
    ):
        got, want = fn(*call), ref(*call)
        torch.cuda.synchronize()
        n_out = 2 if name != "k4" else 4
        out[f"{name}_max_abs_err"] = _err(got[:n_out], want[:n_out])
        out[f"{name}_ms"] = device_ms(lambda: fn(*call), 20, 3)


def _time_scans(torch, device, out):
    """K2, K9 and K7 on the inputs of one update each, against their plain
    versions (ids exact)."""
    from lagrangebench_torch.profiling import device_ms

    for name, ((pos, idx, bases), kw, fn, ref) in _scan_inputs(torch, device).items():
        key = {"neighbor_scan": "k2", "neighbor_scan_geometry": "k9", "slot_scan": "k7"}[name]
        got, want = fn(pos, idx, bases, **kw), ref(pos, idx, bases, **kw)
        torch.cuda.synchronize()
        out[f"{key}_table"] = list(pos.shape)
        out[f"{key}_max_abs_err"] = max(float((a.double() - b.double()).abs().max())
                                        for a, b in zip(got, want))
        out[f"{key}_ms"] = device_ms(lambda: fn(pos, idx, bases, **kw), 50, 5)


def _rpf_batch(torch, device, frames=ISL, cfg_model=None):
    """A dense case on the synthetic RPF-3D-scale data (8,000 particles in
    3D, ``data.synthetic``), the test split's first ``frames`` frames at
    batch 2, and the metadata."""
    import numpy as np

    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.data.synthetic import make_synthetic_arrays

    splits, metadata = make_synthetic_arrays(
        n_particles=N_SAMPLE, dim=DIM, box=1.0, dx=1.0 / round(N_SAMPLE ** (1 / DIM)),
        seq_len_train=12, seq_len_eval=frames + 1, n_trajs=2, name="RPF")
    pos = np.stack([t.transpose(1, 0, 2)[:, :frames] for t in splits["test"]])
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    ptype = torch.zeros(pos.shape[:2], dtype=torch.int64, device=device)
    case = case_builder([1.0] * DIM, metadata, ISL, cfg_neighbors={"backend": "auto"},
                        cfg_model=cfg_model, device=device)
    return case, pos, ptype, metadata


def _time_rollout(torch, device, out, steps=20, runs=3):
    """ms per step (host clock, synchronized) of a GNS-10-128 bf16 rollout
    on the dense layout at batch 2, seeded weights: the path every neighbor
    update of the rollout runs."""
    import time

    from lagrangebench_torch.config import Config
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.models import build_gns

    cfg = Config({"name": "gns", "fused_processor": True, "compute_dtype": "bfloat16",
                  "num_mp_steps": 10, "latent_dim": 128, "num_mlp_layers": 2,
                  "input_seq_length": ISL, "magnitude_features": False,
                  "isotropic_norm": False})
    case, pos, ptype, metadata = _rpf_batch(torch, device, ISL + steps, cfg)
    model = build_gns(cfg, metadata, ISL, seed=0, device=device)
    _, nbrs = case.allocate_eval((pos[0, :, :ISL], ptype[0]))
    nbrs = nbrs.broadcast(2)
    times = []
    for _ in range(runs + 1):  # the first run warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout_batch(model, case, pos[:, :, :ISL], ptype, nbrs, pos[:, :, ISL:])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    out["gns_rollout_b2_ms_per_step"] = times[1:]


def _device_events(torch, fn, calls=1):
    """The device events (kernels, memsets, copies) of ``calls`` calls of
    ``fn``, in order, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.events()
              if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA]
    return sorted(events, key=lambda ev: ev.time_range.start)


def update_kernels(torch, update) -> list:
    """Names of the device kernels (and memsets and copies) one call of
    ``update`` launches, in order."""
    return [ev.name for ev in _device_events(torch, update)]


def kernel_us(torch, fn, key, calls=50) -> float:
    """Mean duration (us) of the device kernels whose name holds ``key``,
    per call of ``fn``, from a torch.profiler trace: the kernel's own time,
    without the gaps between launches."""
    events = _device_events(torch, fn, calls)
    return sum(ev.time_range.elapsed_us() for ev in events if key in ev.name) / calls


def _time_k1(torch, device, out):
    """K1 with the table build around it at batch 2 and 1 (the inputs of one
    eval preprocess each, recorded), and one dense neighbor update at batch
    2: its device time and its device kernels."""
    from lagrangebench_torch.ops import neighbors as nb
    from lagrangebench_torch.ops import neighbors_cuda as nlc
    from lagrangebench_torch.profiling import device_ms

    case, pos, ptype, _ = _rpf_batch(torch, device)
    new = hasattr(nlc, "column_table")
    owner, name = (nlc, "column_table") if new else (nb, "_column_table")
    real, seen = getattr(owner, name), []

    def record(*args):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return real(*args)

    _, nbrs = case.allocate_eval((pos[0], ptype[0]))
    setattr(owner, name, record)
    try:
        with torch.no_grad():
            for bsz in (2, 1):
                seen.clear()
                case.preprocess_eval_batched((pos[:bsz], ptype[:bsz]), nbrs.broadcast(bsz))
                args = seen[0]
                if new:
                    def build():
                        return nlc.column_table(*args)
                else:
                    def build():
                        _, _, table, table_pos = nb._column_table(*args)
                        return nb._with_sentinel(table, table_pos, args[2].shape[1])
                out[f"k1_b{bsz}_form"] = "column_table" if new else "_column_table + _with_sentinel"
                out[f"k1_b{bsz}_ms"] = device_ms(build, 100, 10)
                out[f"k1_b{bsz}_kernel_us"] = kernel_us(torch, build, "bin_")
    finally:
        setattr(owner, name, real)

    nbrs_b = nbrs.broadcast(2)
    most_recent, npart = pos[:, :, ISL - 1], (ptype != -1).sum(dim=1)

    def update():
        return nbrs_b.update(most_recent, num_particles=npart)

    with torch.no_grad():
        names = update_kernels(torch, update)
        out["update_b2_ms"] = device_ms(update, 100, 5)
    out["update_b2_device_kernels"] = len(names)
    out["update_b2_kernel_names"] = names


if __name__ == "__main__":
    main()
