"""Device times of the port's redesigned kernels at the main paths' shapes,
for this checkout or another one.

    python lagrangebench_torch/experiments/mp_times.py [--tree DIR] [--label NAME]
        [--only gns,painn,scan,k1,rollout[,segnn][,train][,k5][,k4]] [--latent F] [--hidden H]
        [--model-latent F] [--train-batch B]

- K3 and K4 (the fused GNS message-passing step and its backward): seeded
  random inputs at the GNS rollout shape (16,000 receivers x K = 40, F =
  ``--latent``, any width from 1 to 1,024 (128 by default; 64 is GNS-5-64's
  width; above 256 the wide path, ``csrc/mp_wide.cuh``; a width that is not
  a multiple of 64 is timed with the wrapper's padding and slicing of its
  tensors), bf16: batch 2 x 8,000 particles):
  K3's plain step, K3's encoder-folded step (raw edge features of width 4)
  and K4 (also each of K4's kernels' device time, from a torch.profiler
  trace); with K3's weights, K8 (plain and encoder-folded) on a seeded
  slot layout of the GNS-10 slot rollout's size (14,960 rows x K = 40) and
  E2 on the window probe's structure (8,960 rows x K = 24).
- K5 (the fused PaiNN layer) and K6 (the message block) at the PaiNN
  rollout shape (16,000 receivers x K = 40, float32, H = ``--hidden``, 1 to
  1,024 (K5's tensor-core design past 256), 128 by default, R = 20; K5 also
  in bf16 on the same values; each of its kernels' device time, from a
  torch.profiler trace) on the dense neighbor list of a batch
  of 2 of the synthetic RPF-3D-scale data that ``chip_smoke.py`` drives
  (``data.synthetic.make_synthetic_arrays``, 8,000 particles in 3D), the
  values seeded; K5's plain version's time beside it. A tree whose K5 takes
  the gathered rows
  ``g`` is timed as ``gather_rows(packed, sidx)`` + K5, the layer's forward
  in that tree; one whose K5 gathers itself as K5 alone. Also the fused
  PaiNN-5-H forward and forward + backward on those neighbors.
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
- K4 alone (``k4``): the gns group's K4 and its kernels' split, without K3,
  K8 and E2.
- The GNS-10-128 bf16 dense rollout (GNS-10-F with ``--model-latent F``) at
  batch 2 of the same data, seeded weights: ms per step on the host clock (20 steps, three runs after one
  that warms up), the path every rollout's neighbor update runs; then the
  dense and the slot rollouts at batch 1.
- SEGNN-10-64 float32 (the model of ``configs/rpf_3d/segnn.yaml``) on the
  same data, seeded weights: ms per rollout step at batch 2 on the host
  clock (as the GNS rollout), and the device time, peak memory and twelve
  longest kernels (summed by name) of one forward and backward at batch 1
  (a training step without the optimizer).
- GNS-10-128 (GNS-10-F with ``--model-latent F``) bf16 training on the
  dense layout at batch 2 (``--train-batch``) of the same data through
  ``train.Trainer`` (noise 3e-4, 12 steps, one pushforward unroll
  from step 4, the loss read every step), seeded weights: the step times on
  the host clock (``profiling.StepTimer``) and their medians over the steps
  without and with the unroll, as ``chip_smoke.py``'s train path reads them.

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
GNS_MP_STEPS, GNS_LATENT = 10, 128  # GNS-10-128 of the rollout and train groups


def _inputs(fused_mp, torch, device, seed=0, f=None):
    """K3's and K4's seeded inputs at latent width f (GNS_LATENT unless
    given), bf16."""
    g = torch.Generator().manual_seed(seed)
    f, cdt = f or GNS_LATENT, torch.bfloat16
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


def _painn_inputs(torch, device, seed=1, h=128):
    """K5's float32 inputs at the rollout shape and hidden width h: packed
    rows, the dense senders (fill N) of a batch of 2 of the synthetic
    RPF-3D-scale data, basis, directions, state and parameters, seeded."""
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
    r = 20
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


def _time_painn(torch, device, out, hidden=128, full=True):
    """K5 (with the gather in front of it where the tree's K5 takes the
    gathered rows; float32, then bf16 on the same values), K6, and the
    fused PaiNN-5-H forward and train step, at hidden width H = ``hidden``;
    K5 alone with ``full=False``."""
    from lagrangebench_torch.models import PaiNN
    from lagrangebench_torch.models.utils import gather_rows
    from lagrangebench_torch.ops import painn_msg
    from lagrangebench_torch.profiling import device_ms

    feats, senders, t, p = _painn_inputs(torch, device, h=hidden)
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
    out["k5_kernels_us"] = kernel_breakdown(torch, layer)
    if gather_in:  # the plain version on the card, for the kernel table
        out["k5_plain_ms"] = device_ms(lambda: painn_msg.painn_layer_plain(*args), 5, 1)
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
    out["k5_bf16_ms"] = device_ms(lambda: painn_msg.painn_layer_kernel(*lead, *rest_bf), 20, 3)
    out["k5_bf16_kernels_us"] = kernel_breakdown(
        torch, lambda: painn_msg.painn_layer_kernel(*lead, *rest_bf))
    del got, want, bf, rest_bf, lead
    if not full:
        return

    # K6 on seeded float32 rows [x, v] and filters masked like the basis
    gen = torch.Generator().manual_seed(2)
    g6 = torch.randn(n, k, (3 + DIM) * hidden, generator=gen).to(device)
    wij = (torch.randn(n, k, 3 * hidden, generator=gen).to(device)
           * (senders < n).float()[..., None]).contiguous()
    got = painn_msg.painn_message_kernel(g6, wij, t["nd"], hidden)
    want = painn_msg.painn_message_plain(g6, wij, t["nd"], hidden)
    torch.cuda.synchronize()
    out["k6_max_abs_err"] = _err(got, want)
    out["k6_ms"] = device_ms(lambda: painn_msg.painn_message_kernel(g6, wij, t["nd"], hidden),
                             20, 3)
    del g6, wij, got, want

    model = PaiNN(hidden, 5, 20, 1.5 * 0.0725, ISL - 1, fused=True, device=device)
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
                         "GNS-10-128 rollouts: dense at batch 2, dense and slot at batch 1), "
                         "segnn (SEGNN-10-64's rollout and "
                         "training forward and backward; not by default: a tree older than "
                         "slice 9 has no SEGNN), train (GNS-10-128 training steps through "
                         "the Trainer; not by default), k5 (K5 alone, float32 and bf16: "
                         "the painn group without K6 and the model), k4 (K4 alone, split "
                         "by kernel)")
    ap.add_argument("--latent", type=int, default=GNS_LATENT,
                    help="the latent width of the gns group's K3 and K4 inputs (a width the "
                         "tree's kernels take: 128, 64 from slice 15 on, 1 to 256 from "
                         "slice 16 on, 1 to 1,024 from slice 18 on)")
    ap.add_argument("--hidden", type=int, default=128,
                    help="the hidden width of the painn group's K5, K6 and PaiNN-5-H (128, "
                         "the shipped width, in every tree; 1 to 256 from slice 16 on, 1 "
                         "to 1,024 from slice 18 on)")
    ap.add_argument("--model-latent", type=int, default=GNS_LATENT,
                    help="the latent width of the rollout and train groups' GNS-10")
    ap.add_argument("--train-batch", type=int, default=2,
                    help="the train group's batch size")
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
    out = {"label": args.label or root, "card": torch.cuda.get_device_name(0), "N": N, "K": K,
           "latent": args.latent, "hidden": args.hidden}
    if "gns" in groups or "k4" in groups:
        _time_gns(fused_mp, torch, device, out, args.latent, full="gns" in groups)
    if "painn" in groups or "k5" in groups:
        _time_painn(torch, device, out, args.hidden, full="painn" in groups)
    if "scan" in groups:
        _time_scans(torch, device, out)
    if "k1" in groups:
        _time_k1(torch, device, out)
    out["model_latent"] = args.model_latent
    if "rollout" in groups:
        _time_rollout(torch, device, out, latent=args.model_latent)
    if "segnn" in groups:
        _time_segnn(torch, device, out)
    if "train" in groups:
        out["train_batch"] = args.train_batch
        _time_train(torch, device, out, latent=args.model_latent, batch=args.train_batch)
    print(json.dumps(out))
    return out


def _time_gns(fused_mp, torch, device, out, latent=None, full=True):
    """K3 (plain and encoder-folded) and K4 on seeded random inputs at
    width ``latent`` (GNS_LATENT unless given); K8 and E2 too with
    ``full``, K4 alone without."""
    from lagrangebench_torch.profiling import device_ms

    t, p, enc = _inputs(fused_mp, torch, device, f=latent)
    plain = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], p)
    folded = (t["raw"], t["hs"], t["hr"], t["h"], t["mask"], p, enc)
    bwd = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], p, t["ge"], t["gh"])
    at_true_width = getattr(fused_mp, "at_true_width", None)

    def kernel(name):  # a tree without at_true_width takes only its instance widths
        if at_true_width is None:
            return getattr(fused_mp, name)
        return lambda *a: at_true_width(name, *a, latent=t["hs"].shape[-1])

    for name, fn, ref, call in (
        ("k3_plain", kernel("gns_mp_step"), fused_mp.gns_mp_step_plain, plain),
        ("k3_encoder", kernel("gns_mp_step"), fused_mp.gns_mp_step_plain, folded),
        ("k4", kernel("gns_mp_step_bwd"), fused_mp.gns_mp_step_bwd_plain, bwd),
    )[0 if full else 2:]:
        got, want = fn(*call), ref(*call)
        torch.cuda.synchronize()
        n_out = 2 if name != "k4" else 4
        out[f"{name}_max_abs_err"] = _err(got[:n_out], want[:n_out])
        out[f"{name}_ms"] = device_ms(lambda: fn(*call), 20, 3)
        if name == "k4":  # K4's launches, split by kernel
            out["k4_kernels_us"] = kernel_breakdown(torch, lambda: fn(*call))
    del t, plain, folded, bwd
    if full:
        _time_slot_window(fused_mp, torch, device, out, p, enc, latent)


def _slot_inputs(torch, device, f, seed=2, n_cols=934, c=16, s=27, k=K):
    """K8's seeded inputs in the slot layout at the GNS-10 slot rollout's
    size (n_ext = (n_cols + 1) c = 14,960 rows of K = 40 candidates): a
    stencil table of random columns, candidates in [0, S c) with a quarter
    of them fill (S c), the sentinel column's all fill; bf16."""
    g = torch.Generator().manual_seed(seed)
    n = (n_cols + 1) * c
    cand = torch.randint(0, s * c, (n, k), generator=g, dtype=torch.int32)
    cand = torch.where(torch.rand(n, k, generator=g) < 0.25, s * c, cand)
    cand[-c:] = s * c
    bases = torch.randint(0, n_cols, (n_cols, s), generator=g, dtype=torch.int32)
    t = {"e": torch.randn(n, k, f, generator=g), "raw": torch.randn(n, k, 4, generator=g),
         "hs_ext": torch.randn(n, f, generator=g), "hr": torch.randn(n, f, generator=g),
         "h": torch.randn(n, f, generator=g)}
    t = {name: (v if name == "raw" else v.to(torch.bfloat16)).to(device) for name, v in t.items()}
    return t, cand.to(device), bases.to(device)


def _time_slot_window(fused_mp, torch, device, out, p, enc, latent=None):
    """K8 (plain and encoder-folded) on ``_slot_inputs`` and E2 on the
    window probe's 8,000-particle structure (``window_select``), with K3's
    weights, at width ``latent``, bf16."""
    from lagrangebench_torch.experiments import window_select as ws
    from lagrangebench_torch.profiling import device_ms

    f = latent or GNS_LATENT
    t, cand, bases = _slot_inputs(torch, device, f)
    at_true_width = getattr(fused_mp, "at_true_width", None)

    def kernel(name):
        if at_true_width is None:
            return getattr(fused_mp, name)
        return lambda *a: at_true_width(name, *a, latent=f)

    for name, call in (("k8_plain", (t["e"], cand, bases, t["hs_ext"], t["hr"], t["h"], p)),
                       ("k8_encoder", (t["raw"], cand, bases, t["hs_ext"], t["hr"], t["h"], p,
                                       enc))):
        got, want = kernel("gns_mp_step_slot")(*call), fused_mp.gns_mp_step_slot_plain(*call)
        torch.cuda.synchronize()
        out[f"{name}_max_abs_err"] = _err(got, want)
        out[f"{name}_ms"] = device_ms(lambda: kernel("gns_mp_step_slot")(*call), 20, 3)
    del t
    n_rows, _, ext_idx, cand, w0s, _, wsub = ws.build_structure()
    g = torch.Generator().manual_seed(3)
    e, h, hr, hs = (torch.randn(*shape, generator=g).to(torch.bfloat16).to(device)
                    for shape in ((n_rows, ws.K, f), (n_rows, f), (n_rows, f), (n_rows, f)))
    call = (e, torch.as_tensor(cand, device=device), torch.as_tensor(w0s, device=device),
            int(wsub), hs[torch.as_tensor(ext_idx, device=device)], hr, h, p)
    got = kernel("gns_mp_step_window")(*call)
    want = fused_mp.gns_mp_step_window_plain(*call)
    torch.cuda.synchronize()
    out["e2_max_abs_err"] = _err(got, want)
    out["e2_ms"] = device_ms(lambda: kernel("gns_mp_step_window")(*call), 20, 3)


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


def _time_rollout(torch, device, out, steps=20, runs=3, latent=None):
    """ms per step (host clock, synchronized) of a GNS-10-``latent`` bf16
    rollout (GNS_LATENT unless given), seeded weights: on the dense layout at batch 2, the path every neighbor
    update of the rollout runs, then at batch 1 on the dense and the slot
    layouts (``chip_smoke.py``'s "dense b1" and "slot b1")."""
    import time

    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.config import Config
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.models import build_gns

    cfg = Config({"name": "gns", "fused_processor": True, "compute_dtype": "bfloat16",
                  "num_mp_steps": GNS_MP_STEPS, "latent_dim": latent or GNS_LATENT,
                  "num_mlp_layers": 2,
                  "input_seq_length": ISL, "magnitude_features": False,
                  "isotropic_norm": False})
    case, pos, ptype, metadata = _rpf_batch(torch, device, ISL + steps, cfg)
    slot_case = case_builder([1.0] * DIM, metadata, ISL,
                             cfg_neighbors={"backend": "auto", "format": "slot"},
                             cfg_model=cfg, device=device)
    model = build_gns(cfg, metadata, ISL, seed=0, device=device)

    def per_step(case, b):
        _, nbrs = case.allocate_eval((pos[0, :, :ISL], ptype[0]))
        nbrs = nbrs.broadcast(b)
        times = []
        for _ in range(runs + 1):  # the first run warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rollout_batch(model, case, pos[:b, :, :ISL], ptype[:b], nbrs, pos[:b, :, ISL:])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / steps)
        return times[1:]

    out["gns_rollout_b2_ms_per_step"] = per_step(case, 2)
    out["gns_rollout_b1_ms_per_step"] = {"dense": per_step(case, 1),
                                         "slot": per_step(slot_case, 1)}


def _time_train(torch, device, out, steps=12, unroll_from=4, runs=2, latent=None, batch=2):
    """ms per step (host clock, synchronized, ``profiling.StepTimer``) of
    GNS-10-``latent`` (GNS_LATENT unless given) bf16 training on the dense
    layout at batch ``batch``, seeded weights, ``runs`` trainers in turn;
    the step after the first allocation is the first timed. Keys
    ``gns_train_b{batch}_ms`` and ``gns_train_b{batch}_median_ms``."""
    import contextlib
    import io

    import numpy as np

    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.config import Config
    from lagrangebench_torch.data import ArrayDataset
    from lagrangebench_torch.data.synthetic import make_synthetic_arrays
    from lagrangebench_torch.models import build_gns
    from lagrangebench_torch.train import Trainer

    cfg = Config({"name": "gns", "fused_processor": True, "compute_dtype": "bfloat16",
                  "num_mp_steps": GNS_MP_STEPS, "latent_dim": latent or GNS_LATENT,
                  "num_mlp_layers": 2,
                  "input_seq_length": ISL, "magnitude_features": False,
                  "isotropic_norm": False})
    splits, metadata = make_synthetic_arrays(
        n_particles=N_SAMPLE, dim=DIM, box=1.0, dx=1.0 / round(N_SAMPLE ** (1 / DIM)),
        seq_len_train=12, seq_len_eval=ISL + 3, n_trajs=2, name="RPF")
    types = [np.zeros(N_SAMPLE, np.int64)] * 2
    data = {split: ArrayDataset(split, splits[split], types, metadata, input_seq_length=ISL,
                                extra_seq_length=1 if split == "train" else 3)
            for split in ("train", "valid")}
    runs_ms = []
    for _ in range(runs):
        case = case_builder([1.0] * DIM, metadata, ISL, cfg_neighbors={"backend": "auto"},
                            cfg_model=cfg, device=device)
        model = build_gns(cfg, metadata, ISL, seed=0, device=device)
        trainer = Trainer(
            model, case, data["train"], data["valid"],
            cfg_train={"batch_size": batch, "noise_std": 3e-4, "optimizer": {"lr_start": 5e-4},
                       "pushforward": {"steps": [-1, unroll_from - 1], "unrolls": [0, 1],
                                       "probs": [0, 1]}},
            cfg_eval={"n_rollout_steps": 3, "train": {"n_trajs": 1}},
            cfg_logging={"log_steps": 1, "eval_steps": 10**9},
            input_seq_length=ISL, seed=0, device=device,
        )
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.train(step_max=steps - 1)
        runs_ms.append([round(d * 1e3, 3) for d in trainer.timer.durations])
    out[f"gns_train_b{batch}_ms"] = runs_ms
    out[f"gns_train_b{batch}_median_ms"] = [
        {"no_unroll": float(np.median(d[:unroll_from - 1])),
         "one_unroll": float(np.median(d[unroll_from:]))} for d in runs_ms]


def _time_segnn(torch, device, out, steps=20, runs=3):
    """SEGNN-10-64 float32 on the dense layout, seeded weights: ms per
    rollout step at batch 2 (host clock, synchronized), and one forward and
    backward of the acceleration's mean square at batch 1: device ms
    (``profiling.device_ms``), peak memory (GiB allocated) and the twelve
    kernels of longest device time, summed by name."""
    import time

    from lagrangebench_torch.config import Config
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.models import setup_model
    from lagrangebench_torch.profiling import device_ms

    cfg = Config({"name": "segnn", "num_mp_steps": 10, "latent_dim": 64, "num_mlp_layers": 2,
                  "input_seq_length": ISL, "magnitude_features": False, "isotropic_norm": True,
                  "compute_dtype": "float32", "lmax_attributes": 1, "lmax_hidden": 1,
                  "segnn_norm": "none", "velocity_aggregate": "avg"})
    case, pos, ptype, metadata = _rpf_batch(torch, device, ISL + steps, cfg)
    model = setup_model(cfg, metadata, seed=0, device=device)
    _, nbrs = case.allocate_eval((pos[0, :, :ISL], ptype[0]))
    times = []
    with torch.no_grad():
        for _ in range(runs + 1):  # the first run warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rollout_batch(model, case, pos[:, :, :ISL], ptype, nbrs.broadcast(2),
                          pos[:, :, ISL:])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / steps)
    out["segnn_rollout_b2_ms_per_step"] = times[1:]
    with torch.no_grad():
        feats, _ = case.preprocess_eval_batched((pos[:1, :, :ISL], ptype[:1]), nbrs)
    flat_ptype = ptype[:1].reshape(-1)

    def fwd_bwd():
        model(feats, flat_ptype)["acc"].square().mean().backward()

    out["segnn_fwd_bwd_b1_ms"] = device_ms(fwd_bwd, iters=5, warmup=1)
    per = {}
    for ev in _device_events(torch, fwd_bwd):
        key = ev.name[:70]
        per[key] = per.get(key, 0.0) + ev.time_range.elapsed_us() / 1e3
    out["segnn_fwd_bwd_b1_top_kernels_ms"] = dict(sorted(per.items(), key=lambda kv: -kv[1])[:12])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd()
    torch.cuda.synchronize()
    out["segnn_fwd_bwd_b1_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30


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


def kernel_breakdown(torch, fn, calls=10) -> dict:
    """Device us per call of ``fn`` by kernel (its name without the
    namespace and the argument list: a template's instance apart), from a
    torch.profiler trace."""
    out = {}
    for ev in _device_events(torch, fn, calls):
        name = ev.name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
        out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / calls
    return out


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
