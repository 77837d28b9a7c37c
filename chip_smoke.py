#!/usr/bin/env python3
"""Smoke run of lagrangebench_torch on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds every CUDA kernel of the port from ``csrc/`` (one
   nvcc per source, all at once).
2. Inference (slice 1). Runs K1, K2 and K3 against their plain PyTorch
   versions on the card, on the inputs the path gives them (captured from
   one preprocess and one model forward at the slice's shapes: GNS-10-128,
   8,000 particles in 3D, batch 2): K1 and K2 must match exactly; K3 within
   stated tolerances in bf16 and in float32 with TF32 off. Times each with
   CUDA events. Then drives ``infer`` (seeded bf16 weights saved to and
   reloaded from ``params.npz``, synthetic RPF-3D-scale trajectories, batch
   2, 20 rollout steps, metrics mse, e_kin and Sinkhorn) with the launch
   counters zeroed just before and read just after, times a rollout (ms
   per step), profiles three steps by kernel group, and holds a small
   float32 rollout on the card against the plain path on the CPU.
3. Training (slice 2). Runs K4 (the fused step's backward) against its
   plain version on inputs captured from one training backward at the same
   shapes (a plain step and the encoder step), in bf16 and in float32, checks
   that two launches give bit-identical weight gradients, and times it.
   Then drives ``Trainer.train`` for 12 steps (GNS-10-128 bf16, batch 2,
   pushforward unlocking one unroll after step 3) with the counters zeroed
   around it; checks the launch counts, finite losses and changed
   parameters; saves a checkpoint with the optimizer state and resumes a
   new trainer from it for one step; prints ms per train step and a
   torch.profiler split of one unroll step; and holds a 3-step float32
   training run on the card against the same run on the CPU.
4. Prints one ``{"kernels": [...]}`` line (launch counts from the training
   run), the card line, and last ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, without a CUDA device or outside the
repository. Needs one card and no network.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_BF16 = 989e12  # tensor-core FLOP/s
PEAK_FP32 = 67e12  # CUDA-core float32 FLOP/s

N_PARTICLES, DIM, BOX, DX = 8000, 3, 1.0, 0.05
BATCH, N_STEPS, ISL, LATENT, MP_STEPS = 2, 20, 6, 128, 10
K3_TOL = {"bfloat16": 0.125, "float32": 1e-4}  # max |kernel - plain|
# K4 against its plain version, set by the output's dtype. bf16 outputs (de,
# dhs, dhr, dh): |kernel - plain| / |plain| in the 2-norm over each tensor.
# Their max-norm is printed, not gated: the two sum agg in other orders, its
# bf16 rounding then flips relu(node_first) for the few receivers where it
# is within an ulp of 0, and a flip changes all K rows of that receiver by
# O(1) (the count of elements off by more than 1e-2 of the largest
# magnitude is printed). float32 weight gradients and every output of the
# float32 instance (TF32 off): max |kernel - plain| / max |plain|.
K4_TOL = {"bf16_out": 1e-2, "bf16_grads": 1e-4, "float32": 1e-4}
TRAIN_STEPS, UNROLL_FROM = 12, 4  # steps 0-3 unroll 0, steps 4-11 unroll 1


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "unknown (nvidia-smi failed)"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "unknown (nvidia-smi failed)"


def cuda_time(fn, iters=20, warmup=3):
    """Mean ms of fn() on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def make_data(n_particles, seq_len, n_trajs=BATCH, split="test"):
    """Synthetic trajectories in memory and their metadata: the eval split
    (windows of ``seq_len``) or, with ``split="train"``, the train split
    (windows of ISL + 2 frames: one pushforward unroll)."""
    import numpy as np

    from lagrangebench_torch.data import ArrayDataset
    from lagrangebench_torch.data.synthetic import make_synthetic_arrays

    side = round(n_particles ** (1 / DIM))
    splits, metadata = make_synthetic_arrays(
        n_particles=n_particles, dim=DIM, box=BOX, dx=BOX / side,
        seq_len_train=12, seq_len_eval=seq_len, n_trajs=n_trajs, name="RPF",
    )
    types = [np.zeros(n_particles, np.int64)] * n_trajs
    if split == "train":
        return ArrayDataset("train", splits["train"], types, metadata, input_seq_length=ISL,
                            extra_seq_length=1), metadata
    data = ArrayDataset(split, splits[split], types, metadata,
                        input_seq_length=ISL, extra_seq_length=seq_len - ISL)
    return data, metadata


def build_case_model(metadata, device, dtype="bfloat16", mp_steps=MP_STEPS, seed=0):
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.config import Config
    from lagrangebench_torch.models import build_gns

    cfg_model = Config({
        "name": "gns", "fused_processor": True, "compute_dtype": dtype,
        "num_mp_steps": mp_steps, "latent_dim": LATENT, "num_mlp_layers": 2,
        "input_seq_length": ISL, "magnitude_features": False, "isotropic_norm": False,
    })
    box = [BOX] * DIM
    case = case_builder(box, metadata, ISL, cfg_neighbors={"backend": "auto"},
                        cfg_model=cfg_model, device=device)
    model = build_gns(cfg_model, metadata, ISL, seed=seed, device=device)
    return case, model


def capture_kernel_inputs(case, model, data):
    """Inputs of K1, K2 and K3 (steps 0 and 1) from one batched preprocess
    and one forward, run on the plain versions (no kernel launch)."""
    import numpy as np
    import torch

    from lagrangebench_torch.ops import fused_mp, neighbors_cuda

    seen = {}
    real = (neighbors_cuda.binning, neighbors_cuda.neighbor_scan, fused_mp.gns_mp_step)

    def rec_bin(cid, num_cells, cap):
        seen.setdefault("binning", ((cid.clone(), num_cells, cap), {}))
        return neighbors_cuda.binning_plain(cid, num_cells, cap)

    def rec_scan(pos, idx, bases, **kw):
        seen.setdefault("neighbor_scan", ((pos.clone(), idx.clone(), bases.clone()), kw))
        return neighbors_cuda.neighbor_scan_plain(pos, idx, bases, **kw)

    def rec_mp(e, hs, hr, h, mask, p, enc=None):
        key = "fused_mp_enc" if enc is not None else "fused_mp"
        args = tuple(t.clone() for t in (e, hs, hr, h, mask.to(torch.float32)))
        seen.setdefault(key, (args + (p, enc), {}))
        return fused_mp.gns_mp_step_plain(e, hs, hr, h, mask, p, enc)

    pos, ptype = data[0]
    _, nbrs = case.allocate_eval((pos[:, :ISL], ptype))
    batch = [data[i] for i in range(BATCH)]
    pos_b = torch.as_tensor(np.stack([b[0] for b in batch]), device=case.device)
    ptype_b = torch.as_tensor(np.stack([b[1] for b in batch]), device=case.device)
    neighbors_cuda.binning, neighbors_cuda.neighbor_scan, fused_mp.gns_mp_step = (
        rec_bin, rec_scan, rec_mp)
    try:
        with torch.no_grad():
            feats, nb_b = case.preprocess_eval_batched(
                (pos_b[:, :, :ISL], ptype_b), nbrs.broadcast(BATCH))
            model(feats, ptype_b.reshape(-1))
    finally:
        neighbors_cuda.binning, neighbors_cuda.neighbor_scan, fused_mp.gns_mp_step = real
    return seen, nb_b.capacity


def bound(name, args, kw):
    """(bound_ms, bound_by) from the bytes each input/output moves once and
    the operations these inputs need, at H100 peaks."""
    import torch

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))

    if name == "binning":
        cid = args[0]
        byts, ops, peak = nbytes(cid) * 2 + 4, cid.numel() * 4, PEAK_FP32
    elif name == "neighbor_scan":
        pos, idx, bases = args
        q, s = bases.shape
        cap, dim, k = pos.shape[1], pos.shape[2], kw["k_cap"]
        receivers = int((pos[:, :, 0] < 1e8).sum())  # binned particles
        per_cand = 2 * dim + (dim - 1) + 5 * sum(map(bool, kw["pbc"])) + 1
        byts = nbytes(pos, idx, bases) + q * cap * k * 4 + q * 4
        ops, peak = receivers * s * cap * per_cand, PEAK_FP32
    elif name == "fused_mp_bwd":
        e, hs, hr, h, mask, p, ge, gh = args
        n, k, f = e.shape
        rows = n * k
        # the function's products: the forward it must redo (2 edge, 3 node)
        # and the backward (4 edge, 6 node), at 2 F^2 FLOP per row each
        ops, peak = (rows * 6 + n * 9) * 2 * f * f, PEAK_BF16
        used = [v for name_, v in p.items() if name_ not in ("w_s", "w_r")]
        out_bytes = 2 * nbytes(e) + nbytes(hr, h) + sum(v.numel() * 4 for v in used)
        byts = nbytes(e, hs, hr, h, mask, ge, gh) + out_bytes + nbytes(*used)
    else:
        e, hs, hr, h, mask, p, enc = args
        n, k, f = hs.shape
        rows = n * k
        flops = rows * 2 * (2 * f * f) + n * 3 * (2 * f * f)
        if enc is not None:
            flops += rows * 2 * (e.shape[-1] * f + f * f)
        weights = sum(v.numel() * v.element_size() for v in p.values())
        byts = nbytes(e, hs, hr, h, mask) + rows * f * hs.element_size() \
            + nbytes(h) + weights
        ops, peak = flops, PEAK_BF16
    t_bytes, t_ops = byts / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_kernels(seen):
    """Phase 2: every kernel vs its plain version on the card; timings."""
    import torch

    from lagrangebench_torch.ops import fused_mp, neighbors_cuda

    funcs = {
        "binning": (neighbors_cuda.binning, neighbors_cuda.binning_plain, neighbors_cuda.BINNING),
        "neighbor_scan": (neighbors_cuda.neighbor_scan, neighbors_cuda.neighbor_scan_plain,
                          neighbors_cuda.NEIGHBOR_SCAN),
        "fused_mp": (fused_mp.gns_mp_step, fused_mp.gns_mp_step_plain, fused_mp.FUSED_MP),
        "fused_mp_enc": (fused_mp.gns_mp_step, fused_mp.gns_mp_step_plain,
                         fused_mp.FUSED_MP_ENC),
    }
    rows, ok = {}, True
    for name, (kern, plain, handle) in funcs.items():
        args, kw = seen[name]
        got = kern(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        if name.startswith("fused_mp"):
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            passed = err <= K3_TOL["bfloat16"]
            # float32 with TF32 off: the same inputs, parameters in float32
            a32 = [t.float() if t.is_floating_point() else t for t in args[:5]]
            p32 = fused_mp.kernel_params(args[5], torch.float32)
            e32 = fused_mp.kernel_params(args[6], torch.float32) if args[6] else None
            g32 = kern(*a32, p32, e32)
            w32 = plain(*a32, p32, e32)
            torch.cuda.synchronize()
            err32 = max(float((a - b).abs().max()) for a, b in zip(g32, w32))
            passed &= err32 <= K3_TOL["float32"]
            log(f"{name}: bf16 max|kernel-plain| {err:.4g} (tol {K3_TOL['bfloat16']}), "
                f"float32 (TF32 off) {err32:.3g} (tol {K3_TOL['float32']})")
        else:
            err = max(float((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
            passed = err == 0
            log(f"{name}: max|kernel-plain| {err} (must be 0)")
        ok &= passed
        ms = cuda_time(lambda: kern(*args, **kw))
        plain_ms = cuda_time(lambda: plain(*args, **kw), iters=5, warmup=1)
        bms, by = bound(name, args, kw)
        rows[name] = {
            "name": name, "route": "cuda", "source": handle.source_path,
            "replaces": handle.replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
        }
        log(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by})")
    return rows, ok


def main_path(device):
    """Phase 3: infer() through params.npz with the counters zeroed."""
    import numpy as np
    import torch

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.evaluate import infer
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.ops import fused_mp, neighbors_cuda

    kernels = [neighbors_cuda.BINNING, neighbors_cuda.NEIGHBOR_SCAN,
               fused_mp.FUSED_MP, fused_mp.FUSED_MP_ENC]
    data, metadata = make_data(N_PARTICLES, ISL + N_STEPS)
    case, model = build_case_model(metadata, device)
    seen, k_cap = capture_kernel_inputs(case, model, data)
    log(f"slice shapes: B*N = {BATCH * N_PARTICLES}, K = {k_cap}, "
        f"column table {tuple(seen['neighbor_scan'][0][0].shape)}")
    rows, ok = compare_kernels(seen)

    with tempfile.TemporaryDirectory() as ckp:
        checkpoint.save_checkpoint(ckp, model.jax_params(), {}, {"step": 0, "loss": None})
        _, fresh = build_case_model(metadata, device, seed=1)
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = infer(fresh, case, data, load_ckp=ckp, n_rollout_steps=N_STEPS,
                        cfg_eval_infer={"metrics": ["mse", "e_kin", "sinkhorn"],
                                        "metrics_stride": 10, "batch_size": BATCH,
                                        "out_type": "none"},
                        device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.name: k.launches for k in kernels}
    log(f"infer: {wall:.2f} s wall (allocation, rollout, metrics); launches {counts}")
    for kern in kernels:
        rows[kern.name]["launches"] = kern.launches

    attempts = counts["fused_mp_enc"] // N_STEPS
    expect = {"binning": attempts * (N_STEPS + 1), "neighbor_scan": attempts * (N_STEPS + 1),
              "fused_mp": attempts * N_STEPS * (MP_STEPS - 1),
              "fused_mp_enc": attempts * N_STEPS}
    if attempts < 1 or counts != expect:
        log(f"FAIL: launch counts {counts}, expected {expect}")
        ok = False
    finite = all(
        np.isfinite(np.asarray(v["predicted"] if isinstance(v, dict) else v)).all()
        for m in metrics.values() for v in m.values()
    )
    if len(metrics) != BATCH or not finite:
        log(f"FAIL: metrics not finite or missing: {list(metrics)}")
        ok = False
    for name, m in metrics.items():
        log(f"{name}: mse(1..{N_STEPS}) mean {float(np.mean(m['mse'])):.4g}, "
            f"e_kin mse {float(m['e_kin']['mse']):.4g}, sinkhorn {np.asarray(m['sinkhorn'])}")

    # ms per rollout step: the same batch, timed end to end on the host clock
    batch = [data[i] for i in range(BATCH)]
    pos = torch.as_tensor(np.stack([b[0] for b in batch]), device=device)
    ptype = torch.as_tensor(np.stack([b[1] for b in batch]), device=device)
    _, nbrs = case.allocate_eval((pos[0, :, :ISL], ptype[0]))
    nbrs = nbrs.broadcast(BATCH)
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, _, _ = rollout_batch(fresh, case, pos[:, :, :ISL], ptype, nbrs,
                                    pos[:, :, ISL:])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / N_STEPS)
    log(f"rollout: {step_ms} ms per step (batch {BATCH} x {N_PARTICLES} particles, "
        f"GNS-{MP_STEPS}-{LATENT} bf16)")
    if tuple(preds.shape) != (BATCH, N_STEPS, N_PARTICLES, DIM) or not torch.isfinite(preds).all():
        log("FAIL: rollout predictions have the wrong shape or are not finite")
        ok = False
    profile_steps(fresh, case, pos, ptype, nbrs)
    return rows, ok, min(step_ms)


def profile_steps(model, case, pos, ptype, nbrs, steps=3):
    """Device time per rollout step by kernel group, and the device's idle
    share of the window, from torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lagrangebench_torch.evaluate.rollout import rollout_batch

    groups = {"fused_mp": "K3 fused_mp", "neighbor_scan": "K2 neighbor_scan",
              "bin_": "K1 binning", "gemm": "GEMM (torch.matmul)",
              "nvjet": "GEMM (torch.matmul)", "index": "gather/scatter (torch index ops)",
              "scatter": "gather/scatter (torch index ops)",
              "gather": "gather/scatter (torch index ops)"}
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rollout_batch(model, case, pos[:, :, :ISL], ptype, nbrs,
                          pos[:, :, ISL:ISL + steps])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:  # the profiler is a report, not a gate
        log(f"profile: not measured (profiler failed: {e})")
        return
    per = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0)
        if dev <= 0 or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        group = next((g for k, g in groups.items() if k in name), "other (elementwise, copies)")
        per[group] = per.get(group, 0.0) + dev / 1e3 / steps
    busy = sum(per.values()) * steps * 1e3
    if busy <= 0:
        log("profile: no device time in the trace (not measured)")
        return
    log("profile (ms of device time per rollout step): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(per.items(), key=lambda kv: -kv[1])}))
    log(f"profile: window {wall_us / 1e3 / steps:.3f} ms per step on the host clock, "
        f"device busy {busy / wall_us:.1%}, idle {1 - busy / wall_us:.1%}")


def reference_check(device):
    """A small float32 rollout through the kernels agrees with the plain
    path on the CPU (TF32 off): 1,000 particles, GNS-2-128, 3 steps."""
    import numpy as np
    import torch

    from lagrangebench_torch.evaluate.rollout import rollout_batch

    data, metadata = make_data(1000, ISL + 3)
    preds = []
    for dev in (device, "cpu"):
        case, model = build_case_model(metadata, dev, dtype="float32", mp_steps=2)
        batch = [data[i] for i in range(BATCH)]
        pos = torch.as_tensor(np.stack([b[0] for b in batch]), device=case.device)
        ptype = torch.as_tensor(np.stack([b[1] for b in batch]), device=case.device)
        _, nbrs = case.allocate_eval((pos[0, :, :ISL], ptype[0]))
        p, ovf, _ = rollout_batch(model, case, pos[:, :, :ISL], ptype, nbrs.broadcast(BATCH),
                                  pos[:, :, ISL:])
        preds.append(p.cpu())
    err = float((preds[0] - preds[1]).abs().max())
    log(f"reference: max |cuda - cpu| position after 3 steps {err:.3g} (tol 1e-5)")
    return err <= 1e-5


def train_setup(device, n_particles=N_PARTICLES, dtype="bfloat16", mp_steps=MP_STEPS,
                seed=0, lr=5e-4, pushforward=None):
    """A Trainer on synthetic data: seeded weights, batch 2, noise 3e-4."""
    from lagrangebench_torch.train import Trainer

    train, metadata = make_data(n_particles, ISL + 3, split="train")
    valid, _ = make_data(n_particles, ISL + 3, split="valid")
    case, model = build_case_model(metadata, device, dtype=dtype, mp_steps=mp_steps, seed=seed)
    pushforward = pushforward or {"steps": [-1, UNROLL_FROM - 1], "unrolls": [0, 1],
                                  "probs": [0, 1]}
    trainer = Trainer(
        model, case, train, valid,
        cfg_train={"batch_size": BATCH, "noise_std": 3e-4, "optimizer": {"lr_start": lr},
                   "pushforward": pushforward},
        cfg_eval={"n_rollout_steps": 3, "train": {"n_trajs": 1}},
        cfg_logging={"log_steps": 1, "eval_steps": 10**9},
        input_seq_length=ISL, seed=seed, device=device,
    )
    return trainer, model, case


def record_steps(trainer):
    """Wrap trainer.train_step and case.allocate: returns the list of
    (unroll_steps, loss) per attempt and a one-item list counting
    allocations."""
    steps, allocs = [], [0]
    real_step, real_alloc = trainer.train_step, trainer.case.allocate

    def train_step(raw, nbrs, noise_std, unroll_steps):
        out = real_step(raw, nbrs, noise_std, unroll_steps)
        steps.append((unroll_steps, float(out[0])))
        return out

    def allocate(*args, **kw):
        allocs[0] += 1
        return real_alloc(*args, **kw)

    trainer.train_step = train_step
    trainer.case = trainer.case._replace(allocate=allocate)
    return steps, allocs


def capture_bwd_inputs(trainer):
    """K4's inputs from one training backward (unroll 0) at the slice's
    shapes: the step before the last (a plain step whose e' feeds the next
    step) and the encoder step (the last backward call)."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    calls = []
    real = fused_mp.gns_mp_step_bwd

    def rec(*args):
        keep = len(calls) in (1, MP_STEPS - 1)
        calls.append(tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args)
                     if keep else None)
        return real(*args)

    pos, ptype = next(iter(trainer.loader_train))
    raw = trainer._batch((pos, ptype))
    _, _, nbrs = trainer.case.allocate(trainer.generator, (pos[0], ptype[0]))
    fused_mp.gns_mp_step_bwd = rec
    try:
        trainer.train_step(raw, nbrs.broadcast(BATCH), 3e-4, 0)
    finally:
        fused_mp.gns_mp_step_bwd = real
    torch.cuda.synchronize()
    return {"plain step": calls[1], "encoder step": calls[-1]}, (raw, nbrs)


def compare_bwd(sets):
    """K4 against its plain version (bf16 and float32), bit-identical weight
    gradients over two launches, and its time."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    ok, worst = True, 0.0

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)

    for label, args in sets.items():
        for dt in (torch.bfloat16, torch.float32):
            a = [t.to(dt) if i != 4 else t for i, t in enumerate(args[:5])]
            p = fused_mp.kernel_params(args[5], dt)
            g = [t.to(dt) for t in args[6:]]
            got = fused_mp.gns_mp_step_bwd(*a, p, *g)
            want = fused_mp.gns_mp_step_bwd_plain(*a, p, *g)
            again = fused_mp.gns_mp_step_bwd(*a, p, *g)
            torch.cuda.synchronize()
            out_err = max(rel(x, y) for x, y in zip(got[:4], want[:4]))
            out_l2 = max(float((x.float() - y.float()).norm() / y.float().norm())
                         for x, y in zip(got[:4], want[:4]))
            off = sum(int(((x.float() - y.float()).abs() > 1e-2 * y.float().abs().max()).sum())
                      for x, y in zip(got[:4], want[:4]))
            size = sum(y.numel() for y in want[:4])
            grad_err = max(rel(got[4][n], want[4][n]) for n in fused_mp.BWD_PARAM_ORDER)
            same = all(torch.equal(got[4][n], again[4][n]) for n in fused_mp.BWD_PARAM_ORDER)
            if dt == torch.bfloat16:
                passed = out_l2 <= K4_TOL["bf16_out"] and grad_err <= K4_TOL["bf16_grads"]
                worst = max(worst, float(max((x.float() - y.float()).abs().max()
                                             for x, y in zip(got[:4], want[:4]))))
            else:
                passed = max(out_err, grad_err) <= K4_TOL["float32"]
            passed &= same
            ok &= passed
            log(f"fused_mp_bwd ({label}, {str(dt)[6:]}): outputs rel err 2-norm {out_l2:.3g}, "
                f"max-norm {out_err:.3g} ({off} of {size} elements beyond 1e-2); weight grads "
                f"max-norm {grad_err:.3g}; two launches "
                f"bit-identical: {same}{'' if passed else '  FAIL'}")
    args = sets["plain step"]
    p = fused_mp.kernel_params(args[5], torch.bfloat16)
    call = (*args[:5], p, *args[6:])
    ms = cuda_time(lambda: fused_mp.gns_mp_step_bwd(*call))
    plain_ms = cuda_time(lambda: fused_mp.gns_mp_step_bwd_plain(*call), iters=3, warmup=1)
    bms, by = bound("fused_mp_bwd", call, {})
    n, k, _ = args[0].shape
    log(f"fused_mp_bwd: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by}) "
        f"at N = {n}, K = {k}")
    row = {"name": "fused_mp_bwd", "route": "cuda",
           "source": fused_mp.FUSED_MP_BWD.source_path,
           "replaces": fused_mp.FUSED_MP_BWD.replaces, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None}
    return row, ok


def train_path(device):
    """Slice 2: K4 checks, Trainer.train at GNS-10-128 with the counters
    zeroed around it, checkpoint and resume, timings and a profile."""
    import numpy as np
    import torch

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.ops import fused_mp, neighbors_cuda

    kernels = [neighbors_cuda.BINNING, neighbors_cuda.NEIGHBOR_SCAN, fused_mp.FUSED_MP,
               fused_mp.FUSED_MP_ENC, fused_mp.FUSED_MP_BWD]
    trainer, _, _ = train_setup(device)
    sets, (raw, nbrs) = capture_bwd_inputs(trainer)
    row, ok = compare_bwd(sets)
    del sets

    trainer, model, _ = train_setup(device)
    steps, allocs = record_steps(trainer)
    before = [p.detach().clone() for p in model.parameters()]
    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(step_max=TRAIN_STEPS - 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    log(f"train: {TRAIN_STEPS} steps in {wall:.2f} s wall (allocation included); "
        f"launches {counts}")
    passes = sum(1 + u for u, _ in steps)
    expect = {"binning": passes + allocs[0], "neighbor_scan": passes + allocs[0],
              "fused_mp": (MP_STEPS - 1) * passes, "fused_mp_enc": passes,
              "fused_mp_bwd": MP_STEPS * len(steps)}
    unrolls = [u for u, _ in steps]
    want_unrolls = [int(i >= UNROLL_FROM) for i in range(TRAIN_STEPS)]
    if counts != expect or (len(steps) == TRAIN_STEPS and unrolls != want_unrolls):
        log(f"FAIL: launch counts {counts}, expected {expect} (unrolls {unrolls})")
        ok = False
    losses = [loss for _, loss in steps]
    changed = sum(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    log(f"train: losses {[round(x, 5) for x in losses]}; {changed} of {len(before)} "
        f"parameter tensors changed")
    if not np.all(np.isfinite(losses)) or changed != len(before):
        log("FAIL: non-finite loss or unchanged parameters")
        ok = False
    d = np.asarray(trainer.timer.durations) * 1e3  # d[i]: step i + 1, synchronized
    if len(d) >= TRAIN_STEPS - 1:
        log(f"train: ms per step (host clock, synchronized): unroll steps 5-11 median "
            f"{np.median(d[UNROLL_FROM:]):.2f} (all {np.round(d[UNROLL_FROM:], 2).tolist()}), "
            f"steps 1-3 median {np.median(d[:3]):.2f} (all {np.round(d[:3], 2).tolist()}) "
            f"[batch {BATCH} x {N_PARTICLES} particles, GNS-{MP_STEPS}-{LATENT} bf16]")
    row["launches"] = counts["fused_mp_bwd"]

    with tempfile.TemporaryDirectory() as ckp:
        checkpoint.save_checkpoint(ckp, model.jax_params(), {},
                                   {"step": TRAIN_STEPS, "loss": None},
                                   opt_state=trainer.optimizer.state_leaves())
        resumed, model2, _ = train_setup(device, seed=1)
        rsteps, _ = record_steps(resumed)
        resumed.train(step_max=TRAIN_STEPS, load_ckp=ckp)
        unchanged = all(torch.equal(a, b)
                        for a, b in zip(resumed.optimizer.nu, trainer.optimizer.nu))
    count_ok = resumed.optimizer.count == TRAIN_STEPS + 1 and len(rsteps) == 1
    log(f"resume: one step from the checkpoint, loss {rsteps[0][1] if rsteps else None}, "
        f"adam count {resumed.optimizer.count}")
    if not count_ok or not np.isfinite(rsteps[0][1]) or unchanged:
        log("FAIL: the resumed trainer did not take exactly one updating step")
        ok = False

    profile_train_step(trainer, raw, nbrs)
    return row, ok, counts


def profile_train_step(trainer, raw, nbrs):
    """Device time of one unroll training step by kernel group, and the
    device's idle share, from torch.profiler (a report, not a gate)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    groups = [("fused_mp_bwd", "K4 fused_mp_bwd"), ("reduce_partials", "K4 fused_mp_bwd"),
              ("fused_mp", "K3 fused_mp"), ("neighbor_scan", "K2 neighbor_scan"),
              ("bin_", "K1 binning"), ("gemm", "GEMM (torch.matmul)"),
              ("nvjet", "GEMM (torch.matmul)"), ("cutlass", "GEMM (torch.matmul)"),
              ("foreach", "AdamW (foreach ops)"), ("multi_tensor", "AdamW (foreach ops)"),
              ("index", "gather/scatter (torch index ops)"),
              ("scatter", "gather/scatter (torch index ops)"),
              ("gather", "gather/scatter (torch index ops)")]
    nbrs_b = nbrs.broadcast(BATCH)
    trainer.train_step(raw, nbrs_b, 3e-4, 1)  # warm
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(raw, nbrs_b, 3e-4, 1)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:
        log(f"train profile: not measured (profiler failed: {e})")
        return
    per = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0)
        if dev <= 0 or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        group = next((g for k, g in groups if k in name), "other (elementwise, copies)")
        per[group] = per.get(group, 0.0) + dev / 1e3
    busy = sum(per.values()) * 1e3
    if busy <= 0:
        log("train profile: no device time in the trace (not measured)")
        return
    log("train profile (ms of device time, one step with one unroll): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(per.items(), key=lambda kv: -kv[1])}))
    log(f"train profile: {wall_us / 1e3:.3f} ms on the host clock, device busy "
        f"{busy / wall_us:.1%}, idle {1 - busy / wall_us:.1%}")


def train_reference_check(device):
    """Three float32 training steps on the card agree with the same steps
    on the CPU (TF32 off, the same host-drawn noise): 1,000 particles,
    GNS-2-128, batch 2, one pushforward unroll from step 1, lr 1e-4 (the
    config default). Not run under torch.use_deterministic_algorithms: the
    sender gather's backward adds with atomics, and the tolerances (losses
    1e-5 relative, parameters 1e-5 absolute) hold with any order of those
    float32 sums. Adam divides each gradient by its own running scale, so
    where a gradient nearly cancels, float32 summation noise moves the
    parameter by a share of lr: the difference grows with lr."""
    import numpy as np

    from lagrangebench_torch import checkpoint

    pf = {"steps": [-1, 0], "unrolls": [0, 1], "probs": [0, 1]}
    losses, params = [], []
    for dev in (device, "cpu"):
        trainer, model, _ = train_setup(dev, n_particles=1000, dtype="float32", mp_steps=2,
                                        lr=1e-4, pushforward=pf)
        steps, _ = record_steps(trainer)
        trainer.train(step_max=2)
        losses.append(np.asarray([loss for _, loss in steps]))
        params.append(checkpoint.flatten_tree(model.jax_params()))
    loss_err = float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1])))
    par_err, worst = max((float(np.max(np.abs(params[0][k] - params[1][k]))), k)
                         for k in params[1])
    log(f"train reference: 3 float32 steps, cuda vs cpu: losses {losses[0].tolist()} vs "
        f"{losses[1].tolist()}, max rel diff {loss_err:.3g} (tol 1e-5); parameters max abs "
        f"diff {par_err:.3g} at {worst} (tol 1e-5)")
    return len(losses[0]) == 3 and loss_err <= 1e-5 and par_err <= 1e-5


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from lagrangebench_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: lagrangebench_torch not found next to this script ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, TF32 matmul off")
    t0 = time.perf_counter()
    times = build.build(["binning", "neighbor_scan", "fused_mp", "fused_mp_bwd"])
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall, per source {times}")

    with torch.no_grad():
        rows, ok, step_ms = main_path("cuda")
        ok &= reference_check("cuda")
    log(f"inference path: {step_ms:.3f} ms per rollout step")
    bwd_row, train_ok, counts = train_path("cuda")
    ok &= train_ok
    ok &= train_reference_check("cuda")
    for name, row in rows.items():
        row["launches"] = counts[name]
    rows["fused_mp_bwd"] = bwd_row
    log(json.dumps({"kernels": list(rows.values())}))
    log(card)
    if not ok:
        print("chip_smoke: FAILED (see above)", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
