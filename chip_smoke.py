#!/usr/bin/env python3
"""Smoke run of lagrangebench_torch on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds every CUDA kernel of the port from ``csrc/`` (one
   nvcc per source, all at once); prints the registers and spills of the
   fused GNS kernels, K5 and the scans from nvcc's report.
2. Inference (slice 1). Runs K1 (the column table), K2 and K3 against
   their plain PyTorch versions on the card, on the inputs the path gives
   them (captured from one preprocess and one model forward at the slice's
   shapes: GNS-10-128, 8,000 particles in 3D, batch 2): K1 and K2 must
   match exactly (K1 also on the first sample alone, with half the
   capacity so that columns overflow, and on float64 positions on column
   boundaries; timed beside its bound and the launch floor of an empty
   kernel); K3 within stated tolerances in bf16 and in float32 with TF32
   off. Times each with CUDA events. Then drives ``infer`` (seeded bf16 weights saved to and
   reloaded from ``params.npz``, synthetic RPF-3D-scale trajectories, batch
   2, 20 rollout steps, metrics mse, e_kin and Sinkhorn) with the launch
   counters zeroed just before and read just after, times a rollout (ms
   per step), profiles three steps by kernel group, and holds a small
   float32 rollout on the card against the plain path on the CPU, and
   prints the device kernels of one dense neighbor update.
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
4. PaiNN (slice 3). Runs K6 (the message block) and K5 (the fused layer)
   against their plain versions on inputs captured from one PaiNN-5-128
   forward of each layout (8,000 particles in 3D, batch 2): float32 with
   TF32 off and bf16, timed. Then drives ``runner.train_or_infer`` with the
   shipped ``configs/rpf_3d/painn.yaml`` (``PAINN_CONFIG``) on synthetic
   RPF-3D-scale splits: ``mode=all`` (10 training steps, then 20-step infer
   with mse, e_kin and Sinkhorn) in the standard layout, K6 counted at 5
   launches per forward pass and K5 at none; then ``mode=infer`` with
   ``model.fused_processor=true`` from that checkpoint (converted by
   ``ensure_fused_params``), K5 counted at 5 x 20 per attempt and K6 at
   none, held to the standard layout, with no sender ``gather_rows`` and
   no (N, K, (2 + dim) H) tensor made on the fused forward (K5 gathers the
   sender rows itself); 3 training steps of the fused model, timed.
   Prints ms per train step and per rollout step, profiles a rollout step of
   each layout and a train step, and holds a small float32 PaiNN (1,000
   particles, 2 layers, both layouts) on the card against the CPU: a
   3-step rollout and 3 training steps.
5. Slot layout and in-kernel geometry (slice 4). Runs K7 (the slot scan),
   K9 (the geometry-emitting scan) and K8 (the slot MP step, plain and
   encoder-folded, bf16 and float32) against their plain versions on the
   inputs of one slot preprocess and forward of GNS-10-128 (8,000
   particles in 3D, batch 1; K9 at batch 2), timed, and the whole slot
   update (K1, K7, the maps) on the card against the CPU. Then drives
   ``runner.train_or_infer`` with the shipped ``configs/rpf_3d/gns.yaml``
   (``GNS_CONFIG``) from a checkpoint of seeded bf16 weights: ``mode=infer``
   with ``neighbors.format=slot`` at batch 1 (path A: K7 once per step and
   allocation, K8 ten times per forward, K2 and K3 none) and with
   ``neighbors.emit_geometry=true`` at batch 2 (path C: K9 in K2's place);
   holds the slot layout to the dense one and geometry on to off in float32
   from the same weights; takes 3 slot training steps (path B); prints ms
   per rollout step of slot and dense at batch 1 and of geometry on and off
   at batch 2, and a profile of a slot rollout step; and holds a small
   float32 slot rollout on the card against the CPU.
6. The experiments (slice 5). Runs E1 (the row gather) against its plain
   version, equal, in every form at the probe's shape (h 8192 x 128, idx
   8192 x 24; bf16 and float32; (R, K), transposed (K, R) and flat
   indices; the gather and the float32 sum of 24) and on the real neighbor
   indices of an 8,000-particle 3D case; and E2 (the windowed-select MP
   step) against its plain version (K3's limits, bf16 and float32) on the
   probe's 8,000-particle structure, printing E2 against K3 on the decoded
   gather; times both, E1 beside ``torch.index_select``. Then runs
   ``window_select.main`` and ``gather_variants.main`` (all six variants)
   with the counters zeroed around them: E1 must launch, E2 50 times per
   timed loop plus its one check; prints ms per MP step of (b) ``hs[ext_idx]``
   + E2 and (a) ``hs[senders]`` + K3, and the gather times.
7. EGNN, the standard GNS processor and Linear (slice 8). Drives
   ``runner.train_or_infer`` with the shipped ``configs/rpf_3d/egnn.yaml``
   (``EGNN_CONFIG``, EGNN-5-128 float32) on the synthetic splits:
   ``mode=all``, 10 training steps and a 20-step infer (mse, e_kin,
   Sinkhorn), K1 and K2 counted once per neighbor update and K3 at none;
   checks finite losses and changed parameters, prints ms per train and
   rollout step and profiles a rollout step; holds a small float32 EGNN
   (1,000 particles, 2 layers) on the card against the CPU (a 3-step
   rollout, 3 training steps). Then ``configs/rpf_3d/gns.yaml`` with
   ``model.fused_processor=false`` (``mode=infer``, batch 2, from a
   checkpoint of seeded weights in the standard layout), held to the
   fused processor from the same weights in float32 (1e-4), with ms per
   rollout step of both processors; then Linear (``mode=all``, 3 steps).
8. SEGNN (slice 9). Drives ``runner.train_or_infer`` with the shipped
   ``configs/rpf_3d/segnn.yaml`` (``SEGNN_CONFIG``, SEGNN-10-64 float32) on
   the synthetic splits: ``mode=all``, 10 training steps at batch 1 and a
   20-step infer at batch 2 (mse, e_kin, Sinkhorn), K1 and K2 counted once
   per neighbor update and every other kernel at none; checks finite
   losses and changed parameters, prints ms per train and rollout step, the
   peak memory of a training step (``torch.cuda.max_memory_allocated``) and
   profiles of a training step and a rollout step by kernel group. Then
   holds small SEGNNs (2 layers, about 1,000 particles) on the card against
   the CPU: 3D periodic, and 2D with walls, two particle types and lmax 2,
   each a 3-step float32 rollout and 3 float32 training steps; and one bf16
   forward and backward.
9. The sparse layout and the cell-list and all-pairs searches (slice 10;
   no kernel: the JAX package computes them in plain XLA). (a) At 8,000
   particles in 3D, batch 2: the cell list's dense list on the card equals
   the CPU's; its rows equal K1 + K2's as sets; the sparse cell list holds
   the dense list's pairs; all-pairs (dense and sparse) equals a
   brute-force search at 1,000 particles in a box under three cells; the
   overflow flags rise at half the capacities; one neighbor update of each
   backend and format timed. (b) ``runner.train_or_infer`` with
   ``configs/rpf_3d/gns.yaml``, the standard processor and
   ``neighbors.format=sparse`` (the cell list; ``mode=all``, 10 training
   steps at batch 2, a 20-step infer): no kernel launches, every neighbor
   list on the cell list, finite losses and changed parameters; ms per
   train and rollout step, profiles of both, the sparse aggregation timed
   (float32 accumulation against a bf16 ``index_add_``); float32 sparse vs
   dense from the same weights; a small float32 sparse GNS on the card
   against the CPU. (c) ``configs/WaterDrop_2d/gns.yaml`` (``WATERDROP_CONFIG``:
   dense, the cell list) ``mode=infer`` on 2D data with walls and padded
   particles, held to the same weights on K1 + K2; the fused GNS (K3) and
   PaiNN's K6 and K5 on a cell-list list (K a multiple of 4, K1 + K2's of
   8) held to K1 + K2's, float32. (d) The shipped PaiNN,
   EGNN and SEGNN configs with ``neighbors.format=sparse``, ``mode=infer``
   for 5 steps, each held to the dense layout and timed beside it.
10. Prints one ``{"kernels": [...]}`` line (launch counts from the GNS
   training run for K1-K4, from the PaiNN runs for K6 and K5, from paths A
   and C for K7, K8 and K9, from the experiments for E1 and E2), the card
   line, and last ``{"ok": true, "device": {...}}``.

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
# float32 instance (TF32 off): max |kernel - plain| / max |plain|. The same
# flip happens in float32 where node_first is within float32 rounding of 0
# (the kernel adds h @ W_nh and agg @ W_na in one sum, the plain version
# rounds each): a receiver with |node_first| <= NF_TIE x its largest
# magnitude (in float64) passes if it matches the plain version with that
# relu resolved either way.
K4_TOL = {"bf16_out": 1e-2, "bf16_grads": 1e-4, "float32": 1e-4}
NF_TIE = 1e-6
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
    """Mean ms of device time per fn() call on the current stream, by CUDA
    events with the queue filled ahead, so that a short kernel's time is
    not its host launch overhead (``lagrangebench_torch.profiling.device_ms``)."""
    from lagrangebench_torch.profiling import device_ms

    return device_ms(fn, iters, warmup)


def ptxas_report(build, names=("fused_mp", "fused_mp_bwd")):
    """Each kernel's registers, spills and stack from nvcc's -Xptxas -v
    report (the ``.log`` beside each built library), one line per kernel,
    named by its mangled identifier and template arguments."""
    import re

    for name in names:
        with open(build._lib_path(name) + ".log") as f:
            text = f.read()
        for block in text.split("Compiling entry function ")[1:]:
            mangled = block.split("'")[1]
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)  # after the anonymous namespace
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", block)
            if m and regs and spill:
                ident = mangled[m.end():m.end() + int(m.group(1))]
                targs = re.match(r"I\w*?EE", mangled[m.end() + len(ident):])
                log(f"ptxas {name}.cu {ident}{targs.group(0) if targs else ''}: "
                    f"{regs.group(1)} registers, stack {spill.group(1)} B, spill stores "
                    f"{spill.group(2)} B, loads {spill.group(3)} B")


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
    real = (neighbors_cuda.column_table, neighbors_cuda.neighbor_scan, fused_mp.gns_mp_step)

    def rec_table(position, num_particles, grid, col_cap):
        seen.setdefault("column_table",
                        ((position.clone(), num_particles.clone(), grid, col_cap), {}))
        return neighbors_cuda.column_table_plain(position, num_particles, grid, col_cap)

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
    neighbors_cuda.column_table, neighbors_cuda.neighbor_scan, fused_mp.gns_mp_step = (
        rec_table, rec_scan, rec_mp)
    try:
        with torch.no_grad():
            feats, nb_b = case.preprocess_eval_batched(
                (pos_b[:, :, :ISL], ptype_b), nbrs.broadcast(BATCH))
            model(feats, ptype_b.reshape(-1))
    finally:
        neighbors_cuda.column_table, neighbors_cuda.neighbor_scan, fused_mp.gns_mp_step = real
    return seen, nb_b.capacity


def scan_pairs(pos, bases, n_cols):
    """(receiver, candidate) pairs a column-stencil scan must test on these
    inputs: binned receivers of each column times the binned particles of
    its stencil columns (empty slots hold no particle and need no test)."""
    import torch

    occ = (pos[:, :, 0] < 1e8).sum(dim=1)  # binned particles per table row
    q = bases.shape[0]
    recv_rows = torch.arange(q, device=pos.device)
    recv_rows = recv_rows // n_cols * (n_cols + 1) + recv_rows % n_cols
    return int((occ[recv_rows] * occ[bases.long()].sum(dim=1)).sum())


def bound(name, args, kw):
    """(bound_ms, bound_by) from the bytes each input/output moves once and
    the operations these inputs need, at H100 peaks. The scans' work is
    their candidate pairs (``scan_pairs``); ``kw["hits"]`` adds the
    geometry of K9's and K7's hits."""
    import torch

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))

    if name == "column_table":
        # positions and counts in; slots, the table (ids and float32
        # positions, sentinel columns included) and the flags out
        position, npart, grid, cap = args
        bsz, n, dim = position.shape
        table = bsz * (grid.n_cols + 1) * cap * (4 + 4 * dim)
        byts = nbytes(position) + 4 * bsz + 4 * bsz * n + table + bsz
        ops, peak = 0, PEAK_FP32
    elif name in ("neighbor_scan", "neighbor_scan_geometry", "slot_scan"):
        pos, idx, bases = args
        q, s = bases.shape
        cap, dim, k = pos.shape[1], pos.shape[2], kw["k_cap"]
        per_cand = 2 * dim + (dim - 1) + 5 * sum(map(bool, kw["pbc"])) + 1
        ops, peak = scan_pairs(pos, bases, kw["n_cols"]) * per_cand, PEAK_FP32
        rows = q * cap + (cap if name == "slot_scan" else 0)  # K7: + the sentinel rows
        per_slot = 1 + (dim + 1 if name != "neighbor_scan" else 0)  # id (+ geometry)
        byts = nbytes(pos, idx, bases) + rows * k * per_slot * 4 + q * 4
        ops += kw.get("hits", 0) * (dim + 2)  # dim products, a sqrt and a product
    elif name in ("fused_mp_slot", "fused_mp_slot_enc"):
        e, cand, bases, hs, hr, h, p, enc = args
        n, k = cand.shape
        f = hs.shape[1]
        rows = n * k
        ops = rows * 2 * (2 * f * f) + n * 3 * (2 * f * f)
        if enc is not None:
            ops += rows * 2 * (e.shape[-1] * f + f * f)
        weights = sum(v.numel() * v.element_size() for v in p.values())
        weights += sum(v.numel() * v.element_size() for v in (enc or {}).values())
        byts = nbytes(e, cand, bases, hs, hr, h) + rows * f * hs.element_size() \
            + nbytes(h) + weights
        peak = PEAK_BF16
    elif name == "row_gather":  # E1: kw["reps"] float32 additions per element
        h, idx = args
        rows, f, reps = idx.numel(), h.shape[1], kw.get("reps", 1)
        byts = nbytes(idx) + rows * f * h.element_size() + nbytes(h)
        ops, peak = (rows * f * reps if reps > 1 else 0), PEAK_FP32
    elif name == "fused_mp_window":
        e, cand, w0s, _, hs, hr, h, p = args
        n, k, f = e.shape
        weights = sum(v.numel() * v.element_size() for name_, v in p.items()
                      if name_ not in ("w_s", "w_r"))
        byts = nbytes(e, cand, w0s, hs, hr, h) + nbytes(e, h) + weights
        ops, peak = (n * k * 2 + n * 3) * 2 * f * f, PEAK_BF16
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


def compare_column_table(seen):
    """K1 (the column table) against its plain version on the card, every
    output exactly equal (slots, ids, positions, the flag): on the captured
    inputs at batch 2 (B*N = 16,000) and their first sample (batch 1, the
    slot path's shape), with half the capacity (columns overflow), and on
    float64 positions, a third of them on column boundaries (twice the
    capacity, so that every particle lands in the table). Timed at both
    batch sizes beside its bound and the launch floor (an empty kernel)."""
    import torch

    from lagrangebench_torch.ops import neighbors_cuda as nlc
    from lagrangebench_torch.profiling import launch_floor_ms

    (position, npart, grid, cap), _ = seen
    on_edge = position.double()
    idx = torch.arange(position.shape[1], device=position.device)[::3]
    for d, (cps, size) in enumerate(zip(grid.cols_per_side, grid.col_size)):
        on_edge[:, idx, d] = (idx // (cps + 1) ** d % (cps + 1)).double()[None] * size
    cases = {"batch 2": (position, npart, cap), "batch 1": (position[:1], npart[:1], cap),
             "overflow (cap / 2)": (position, npart, cap // 2),
             "float64 on column boundaries (cap x 2)": (on_edge, npart, 2 * cap)}
    ok, flags, err = True, {}, 0.0
    for label, (pos, n, c) in cases.items():
        got = nlc.column_table(pos, n, grid, c)
        want = nlc.column_table_plain(pos, n, grid, c)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        err = max([err] + [float((a.double() - b.double()).abs().max())
                           for a, b in zip(got, want)])
        flags[label] = bool(want[3])
        log(f"column_table {label} ({tuple(pos.shape)}, {pos.dtype}, cap {c}): slots, ids, "
            f"positions, flag equal {same}; flag {bool(got[3])}"
            f"{'' if all(same) else '  FAIL'}")
        ok &= all(same)
    if flags != {label: label.startswith("overflow") for label in cases}:
        log(f"FAIL: only the overflow case may overflow: {flags}")
        ok = False
    args = (position, npart, grid, cap)
    ms = cuda_time(lambda: nlc.column_table(*args), iters=200, warmup=10)
    ms1 = cuda_time(lambda: nlc.column_table(position[:1], npart[:1], grid, cap), iters=200,
                    warmup=10)
    plain_ms = cuda_time(lambda: nlc.column_table_plain(*args), iters=20, warmup=2)
    floor = launch_floor_ms()
    bms, by = bound("column_table", args, {})
    bms1, _ = bound("column_table", (position[:1], npart[:1], grid, cap), {})
    log(f"column_table: {ms:.5f} ms at batch 2, {ms1:.5f} at batch 1 (plain {plain_ms:.4f} ms; "
        f"bound {bms:.6f} / {bms1:.6f} ms by {by}; launch floor, an empty kernel, "
        f"{floor:.5f} ms)")
    row = {"name": "column_table", "route": "cuda", "source": nlc.COLUMN_TABLE.source_path,
           "replaces": nlc.COLUMN_TABLE.replaces, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None}
    return row, ok


def main_path(device):
    """Phase 3: infer() through params.npz with the counters zeroed."""
    import numpy as np
    import torch

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.evaluate import infer
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.experiments.mp_times import update_kernels
    from lagrangebench_torch.ops import fused_mp, neighbors_cuda

    kernels = [neighbors_cuda.COLUMN_TABLE, neighbors_cuda.NEIGHBOR_SCAN,
               fused_mp.FUSED_MP, fused_mp.FUSED_MP_ENC]
    data, metadata = make_data(N_PARTICLES, ISL + N_STEPS)
    case, model = build_case_model(metadata, device)
    seen, k_cap = capture_kernel_inputs(case, model, data)
    log(f"slice shapes: B*N = {BATCH * N_PARTICLES}, K = {k_cap}, "
        f"column table {tuple(seen['neighbor_scan'][0][0].shape)}")
    k1_row, ok = compare_column_table(seen.pop("column_table"))
    rows, passed = compare_kernels(seen)
    rows, ok = {"column_table": k1_row, **rows}, ok & passed

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
    expect = {"column_table": attempts * (N_STEPS + 1),
              "neighbor_scan": attempts * (N_STEPS + 1),
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
    most_recent, npart = pos[:, :, ISL - 1], (ptype != -1).sum(dim=1)
    names = update_kernels(torch, lambda: nbrs.update(most_recent, num_particles=npart))
    log(f"one dense neighbor update at batch {BATCH}: {len(names)} device kernels {names}")
    return rows, ok, min(step_ms)


def profile_steps(model, case, pos, ptype, nbrs, steps=3, isl=ISL, label="profile",
                  rename=None):
    """Device time per rollout step by kernel group, and the device's idle
    share of the window, from torch.profiler (CUPTI). ``rename`` relabels
    groups (K7 and K8 share K2's and K3's sources and names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lagrangebench_torch.evaluate.rollout import rollout_batch

    groups = {"fused_mp": "K3 fused_mp", "painn_msg": "K6 painn_msg",
              "painn_layer": "K5 painn_layer", "neighbor_scan": "K2 neighbor_scan",
              "bin_": "K1 column_table", "gemm": "GEMM (torch.matmul)",
              "nvjet": "GEMM (torch.matmul)", "cutlass": "GEMM (torch.matmul)",
              "index": "gather/scatter (torch index ops)",
              "scatter": "gather/scatter (torch index ops)",
              "gather": "gather/scatter (torch index ops)"}
    groups.update(rename or {})
    rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs, pos[:, :, isl:isl + 1])  # warm
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs,
                          pos[:, :, isl:isl + steps])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:  # the profiler is a report, not a gate
        log(f"{label}: not measured (profiler failed: {e})")
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
        log(f"{label}: no device time in the trace (not measured)")
        return
    log(f"{label} (ms of device time per rollout step): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(per.items(), key=lambda kv: -kv[1])}))
    log(f"{label}: window {wall_us / 1e3 / steps:.3f} ms per step on the host clock, "
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


def node_first64(args, p):
    """node_first = h @ W_nh + agg @ W_na + bn1 of K4's inputs in float64:
    the plain step's node pre-activation without its roundings."""
    import torch

    e, hs, hr, h, mask = (t.double() for t in args[:5])
    p = {name: v.double() for name, v in p.items()}
    x1 = torch.relu(e @ p["w_e"] + hs + hr[:, None] + p["b1"]) @ p["w2"] + p["b2"]
    del e, hs
    xhat = (x1 - x1.mean(-1, keepdim=True)) * torch.rsqrt(
        x1.var(-1, unbiased=False, keepdim=True) + 1e-5)
    agg = ((xhat * p["ln1_scale"] + p["ln1_bias"]) * mask[..., None]).sum(1)
    return h @ p["w_nh"] + agg @ p["w_na"] + p["bn1"]


def float32_out_err(args, p, grads, got, want):
    """K4's float32 outputs against the plain version: max |kernel - plain| /
    max |plain| over de, dhs, dhr, dh, where a receiver with a float32 tie
    of relu(node_first) (``NF_TIE``) takes the smallest error over the plain
    version as it is and with bn1 moved so that each tie, or all of them,
    lies at +band or at -band (on that receiver alone: its outputs depend on
    no other receiver). Returns the error and the ties as (receiver,
    feature, node_first)."""
    import itertools

    import torch

    from lagrangebench_torch.ops import fused_mp

    tops = [float(y.abs().max()) for y in want[:4]]
    per = torch.stack([(x - y).abs().reshape(x.shape[0], -1).amax(1) / top
                       for x, y, top in zip(got[:4], want[:4], tops)]).amax(0)
    nf = node_first64(args, p)
    band = NF_TIE * float(nf.abs().max())
    at = torch.nonzero(nf.abs() <= band).tolist()
    ties = [(i, j, float(nf[i, j])) for i, j in at]
    for i in sorted({i for i, _ in at}):
        feats = [j for r, j in at if r == i]
        sub = [t[i:i + 1] for t in args[:5]]
        best = float(per[i])
        flips = [[j] for j in feats] + ([feats] if len(feats) > 1 else [])
        for flip, side in itertools.product(flips, (band, -band)):
            q = dict(p)
            q["bn1"] = p["bn1"].clone()
            for j in flip:  # node_first of this receiver moves to +-band
                q["bn1"][j] += side - float(nf[i, j])
            outs = fused_mp.gns_mp_step_bwd_plain(*sub, q, *(t[i:i + 1] for t in grads))
            best = min(best, max(float((x[i] - y[0]).abs().max()) / top
                                 for x, y, top in zip(got[:4], outs[:4], tops)))
        per[i] = best
    return float(per.max()), ties


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
                tied = ""
            else:
                tie_err, ties = float32_out_err(a, p, g, got, want)
                passed = max(tie_err, grad_err) <= K4_TOL["float32"]
                listed = [(i, j, f"{v:.3g}") for i, j, v in ties]
                tied = (f"; relu(node_first) float32 ties {listed}, outputs max-norm with "
                        f"the ties resolved either way {tie_err:.3g}")
            passed &= same
            ok &= passed
            log(f"fused_mp_bwd ({label}, {str(dt)[6:]}): outputs rel err 2-norm {out_l2:.3g}, "
                f"max-norm {out_err:.3g} ({off} of {size} elements beyond 1e-2); weight grads "
                f"max-norm {grad_err:.3g}{tied}; two launches "
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

    kernels = [neighbors_cuda.COLUMN_TABLE, neighbors_cuda.NEIGHBOR_SCAN, fused_mp.FUSED_MP,
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
    expect = {"column_table": passes + allocs[0], "neighbor_scan": passes + allocs[0],
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


def profile_train_step(trainer, raw, nbrs, batch=BATCH, unroll=1, label="train profile",
                       extra=None):
    """Device time of one training step (``unroll`` pushforward unrolls) by
    kernel group (``extra``: more (substring, group) pairs, matched after
    the others), and the device's idle share, from torch.profiler (a
    report, not a gate)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    groups = [("fused_mp_bwd", "K4 fused_mp_bwd"), ("fused_mp", "K3 fused_mp"),
              ("painn_msg", "K6 painn_msg"), ("painn_layer", "K5 painn_layer"),
              ("neighbor_scan", "K2 neighbor_scan"), ("bin_", "K1 column_table"),
              ("gemm", "GEMM (torch.matmul)"), ("nvjet", "GEMM (torch.matmul)"),
              ("cutlass", "GEMM (torch.matmul)"),
              ("foreach", "AdamW (foreach ops)"), ("multi_tensor", "AdamW (foreach ops)"),
              ("index", "gather/scatter (torch index ops)"),
              ("scatter", "gather/scatter (torch index ops)"),
              ("gather", "gather/scatter (torch index ops)")] + list((extra or {}).items())
    nbrs_b = nbrs.broadcast(batch)
    trainer.train_step(raw, nbrs_b, 3e-4, unroll)  # warm
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(raw, nbrs_b, 3e-4, unroll)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:
        log(f"{label}: not measured (profiler failed: {e})")
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
        log(f"{label}: no device time in the trace (not measured)")
        return
    log(f"{label} (ms of device time, one step with {unroll} unroll): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(per.items(), key=lambda kv: -kv[1])}))
    log(f"{label}: {wall_us / 1e3:.3f} ms on the host clock, device busy "
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


# ---------------------------------------------------------------------------
# slice 3: PaiNN-5-128 through the runner (K6 standard layout, K5 fused)
# ---------------------------------------------------------------------------

# configs/rpf_3d/base.yaml and configs/rpf_3d/painn.yaml, resolved (this
# machine need not have PyYAML); tests/test_torch_runner.py holds it equal to
# load_with_extends("configs/rpf_3d/painn.yaml") over the defaults
PAINN_CONFIG = {
    "dataset": {"src": "datasets/3D_RPF_8000_10kevery100"},
    "logging": {"wandb_project": "rpf_3d"},
    "model": {"name": "painn", "num_mp_steps": 5, "latent_dim": 128, "isotropic_norm": True,
              "magnitude_features": True},
    "train": {"optimizer": {"lr_start": 1.0e-4}},
}
PAINN_STEP_MAX, PAINN_ROLLOUT = 10, 20
# K6 and K5 against their plain versions. float32 (TF32 off): max |kernel -
# plain| <= 1e-4 x max |plain| (both sum in float32, in other orders). bf16:
# relative 2-norm over each output, max-norm printed. K6's bf16 inputs are
# widened to float32 on both sides, which then differ only in summation
# order: 1e-5. K5 rounds s1, v1_d, ts and z to bf16 before their products
# and its outputs to bf16; a sum in another order that lands on the other
# side of a rounding boundary moves a value by one bf16 ulp (2^-8 of it), a
# rare event that reads ~1.5e-5 here. A kernel that skipped one of those
# roundings would move every value it feeds by up to half an ulp, ~1e-3:
# 1e-4 lies between. The phase also prints what the plain version reads
# with none of those roundings (float32 arithmetic on the same bf16 values),
# and requires it above the limit.
PAINN_TOL = {"float32": 1e-4, "painn_msg_bf16": 1e-5, "painn_layer_bf16": 1e-4}
# The fused layout against the standard layout, from the same checkpoint:
# the same function in float32 with the filters and K-sums summed in other
# orders. One forward on the same inputs: max |fused - standard| <= 1e-4 x
# max |standard| (acc); the first rollout step's MSE (val/mse1): 1e-4
# relative. Later steps are printed, not gated: float32 differences grow
# step by step along the rollout. The phase prints that growth for the
# fused model through K5 against the same model through the plain version:
# a kernel that is right drifts from its plain version as the two layouts
# drift from each other.
PAINN_FUSED_RTOL = 1e-4


def shipped_cfg(config, **overrides):
    """The port's defaults, a shipped config, then ``overrides`` (dotted
    keys), as the CLI merges them."""
    from lagrangebench_torch.config import Config, from_dotlist, merge
    from lagrangebench_torch.defaults import defaults

    dots = [f"{k}={v}" for k, v in overrides.items()]
    cli = from_dotlist(dots) if dots else Config()
    return merge(defaults, Config(config), cli)


def painn_cfg(**overrides):
    return shipped_cfg(PAINN_CONFIG, **overrides)


def runner_data(cfg, n_particles=N_PARTICLES, n_trajs=BATCH):
    """Synthetic RPF-3D-scale (train, valid, test) splits windowed as the
    runner's ``setup_data`` windows the H5 splits."""
    import numpy as np

    from lagrangebench_torch.data import ArrayDataset
    from lagrangebench_torch.data.synthetic import make_synthetic_arrays

    isl = int(cfg.model.input_seq_length)
    steps = max(int(cfg.eval.n_rollout_steps), 1)
    side = round(n_particles ** (1 / DIM))
    splits, metadata = make_synthetic_arrays(
        n_particles=n_particles, dim=DIM, box=BOX, dx=BOX / side, seq_len_train=12,
        seq_len_eval=isl + steps, n_trajs=n_trajs, name="RPF",
    )
    types = [np.zeros(n_particles, np.int64)] * n_trajs
    extra = {"train": max(cfg.train.pushforward.unrolls), "valid": steps, "test": steps}
    return tuple(ArrayDataset(split, splits[split], types, metadata, input_seq_length=isl,
                              extra_seq_length=extra[split])
                 for split in ("train", "valid", "test"))


def painn_case_model(cfg, metadata, device, seed=0):
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.models import setup_model

    case = case_builder([BOX] * DIM, metadata, cfg.model.input_seq_length,
                        cfg_neighbors=cfg.neighbors, cfg_model=cfg.model,
                        noise_std=cfg.train.noise_std, device=device)
    return case, setup_model(cfg.model, metadata, seed=seed, device=device)


def capture_painn_inputs(device):
    """K6's and K5's inputs from one PaiNN-5-128 forward of each layout at
    the slice's shapes (batch 2 x 8,000 particles, 3D, float32), the fused
    model carrying the standard one's weights; run on the plain versions."""
    import numpy as np
    import torch

    from lagrangebench_torch.ops import painn_msg

    cfg = painn_cfg()
    _, _, test = runner_data(cfg)
    case, std = painn_case_model(cfg, test.metadata, device)
    _, fused = painn_case_model(painn_cfg(**{"model.fused_processor": True}), test.metadata,
                                device)
    fused.load_jax_params(std.jax_params())
    isl = int(cfg.model.input_seq_length)
    batch = [test[i] for i in range(BATCH)]
    pos = torch.as_tensor(np.stack([b[0] for b in batch]), device=device)
    ptype = torch.as_tensor(np.stack([b[1] for b in batch]), device=device)
    _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
    seen = {}
    real = painn_msg.painn_message, painn_msg.painn_layer

    def rec_msg(g, wij, nd, h):
        seen.setdefault("painn_msg", (g.clone(), wij.clone(), nd.clone(), h))
        return painn_msg.painn_message_plain(g, wij, nd, h)

    def rec_layer(packed, sidx, phi, nd, s, v, p):
        kp = painn_msg.layer_kernel_params(p, s.dtype)
        seen.setdefault("painn_layer",
                        tuple(t.clone() for t in (packed, sidx, phi, nd, s, v)) + (kp,))
        return painn_msg.painn_layer_plain(packed, sidx, phi, nd, s, v, p)

    painn_msg.painn_message, painn_msg.painn_layer = rec_msg, rec_layer
    try:
        with torch.no_grad():
            feats, _ = case.preprocess_eval_batched((pos[:, :, :isl], ptype), nbrs.broadcast(BATCH))
            std(feats, ptype.reshape(-1))
            fused(feats, ptype.reshape(-1))
    finally:
        painn_msg.painn_message, painn_msg.painn_layer = real
    return seen


def painn_bound(name, args):
    """(bound_ms, bound_by) of K6 / K5 on these inputs: each input and
    output moved once at 3.35 TB/s (K5's inputs are the node rows
    ``packed`` and the sender index: it gathers the rows itself), the FLOPs
    they need at 67 TFLOP/s (CUDA-core float32, the unit both kernels run
    their products on)."""
    import torch

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))

    if name == "painn_msg":
        g, wij, nd, h = args
        n, k, dim = nd.shape
        edges = n * k
        byts = nbytes(g, wij, nd) + n * (1 + dim) * h * 4
        ops = edges * (4 + 4 * dim) * h  # ds: 2H; msg1, msg2: 2H; dv: 4H per axis
    else:
        packed, sidx, phi, nd, s, v, p = args
        n, k, dim = nd.shape
        h, r = s.shape[-1], phi.shape[-1] - 1
        edges = n * k
        byts = nbytes(packed, sidx, phi, nd, s, v) + nbytes(*p.values()) + nbytes(s, v)
        edge_ops = 2 * r * 3 * h + 2 * 3 * h + 3 * h + (1 + 4 * dim) * h
        node_ops = dim * 2 * h * 2 * h + 2 * 2 * h * h + 2 * h * 3 * h + 20 * dim * h
        ops = edges * edge_ops + n * node_ops
    t_bytes, t_ops = byts / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_painn_kernels(seen):
    """K6 and K5 against their plain versions (float32 and bf16), timed at
    the path's float32 shapes."""
    import torch

    from lagrangebench_torch.ops import painn_msg

    rows, ok = {}, True
    funcs = {"painn_msg": (painn_msg.painn_message_kernel, painn_msg.painn_message_plain,
                           painn_msg.PAINN_MSG),
             "painn_layer": (painn_msg.painn_layer_kernel, painn_msg.painn_layer_plain,
                             painn_msg.PAINN_LAYER)}
    for name, (kern, plain, handle) in funcs.items():
        args = seen[name]
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        rel = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, want))
        passed = rel <= PAINN_TOL["float32"]
        if name == "painn_msg":
            bf = tuple(t.to(torch.bfloat16) for t in args[:3]) + (args[3],)
        else:
            bf = tuple(t.to(torch.bfloat16) if t.is_floating_point() else t
                       for t in args[:6]) + (
                painn_msg.layer_kernel_params(args[6], torch.bfloat16),)
        gb, wb = kern(*bf), plain(*bf)
        torch.cuda.synchronize()

        def l2_of(outs):
            return max(float((a.float() - b.float()).norm() / b.float().norm())
                       for a, b in zip(outs, wb))

        l2 = l2_of(gb)
        mx = max(float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
                 for a, b in zip(gb, wb))
        passed &= l2 <= PAINN_TOL[f"{name}_bf16"]
        unrounded = ""
        if name == "painn_layer":
            # the plain version with none of its inner bf16 roundings
            wide = plain(*(t.float() if t.is_floating_point() else t for t in bf[:6]),
                         {k: v.float() for k, v in bf[6].items()})
            l2_wide = l2_of([t.to(torch.bfloat16) for t in wide])
            passed &= l2_wide > PAINN_TOL[f"{name}_bf16"]
            unrounded = f"; without the inner bf16 roundings it reads {l2_wide:.3g}"
        ok &= passed
        log(f"{name}: float32 (TF32 off) max|kernel-plain| {err:.3g}, {rel:.3g} of the largest "
            f"(tol {PAINN_TOL['float32']}); bf16 relative 2-norm {l2:.3g} (tol "
            f"{PAINN_TOL[name + '_bf16']}), max-norm {mx:.3g}{unrounded}"
            f"{'' if passed else '  FAIL'}")
        ms = cuda_time(lambda: kern(*args))
        plain_ms = cuda_time(lambda: plain(*args), iters=5, warmup=1)
        bms, by = painn_bound(name, args)
        n, k, _ = args[0 if name == "painn_msg" else 2].shape
        log(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by}, "
            f"CUDA-core float32 peak) at N = {n}, K = {k}, float32")
        rows[name] = {"name": name, "route": "cuda", "source": handle.source_path,
                      "replaces": handle.replaces, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None}
    return rows, ok


class _Recorder:
    """Wraps the runner's case_builder, setup_model and Trainer to keep what
    they made, and counts model forward passes (every model class) and
    neighbor allocations of the cases it made."""

    def __init__(self):
        import lagrangebench_torch.runner as runner
        from lagrangebench_torch.models import EGNN, GNS, SEGNN, GNSStandard, Linear, PaiNN

        self.runner, self.model_classes = runner, (PaiNN, GNS, GNSStandard, EGNN, Linear, SEGNN)
        self.cases, self.models, self.trainers, self.losses = [], [], [], []
        self.forwards = self.allocations = 0

    def __enter__(self):
        runner, rec = self.runner, self
        self.saved = (runner.case_builder, runner.setup_model, runner.Trainer)
        self.saved_forwards = [cls.forward for cls in self.model_classes]
        real_case, real_model, real_trainer = self.saved

        def counted(fn):
            def call(*a, **k):
                rec.allocations += 1
                return fn(*a, **k)
            return call

        def case_builder(*a, **k):
            case = real_case(*a, **k)
            rec.cases.append(case._replace(allocate=counted(case.allocate),
                                           allocate_eval=counted(case.allocate_eval)))
            return rec.cases[-1]

        def setup_model(*a, **k):
            rec.models.append(real_model(*a, **k))
            return rec.models[-1]

        class Trainer(real_trainer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.trainers.append(self)
                step = self.train_step

                def train_step(*args):
                    out = step(*args)
                    rec.losses.append(float(out[0]))
                    return out

                self.train_step = train_step

        def counting(real_forward):
            def forward(model, *a, **k):
                rec.forwards += 1
                return real_forward(model, *a, **k)
            return forward

        runner.case_builder, runner.setup_model, runner.Trainer = case_builder, setup_model, Trainer
        for cls, real_forward in zip(self.model_classes, self.saved_forwards):
            cls.forward = counting(real_forward)
        return self

    def __exit__(self, *exc):
        runner = self.runner
        runner.case_builder, runner.setup_model, runner.Trainer = self.saved
        for cls, real_forward in zip(self.model_classes, self.saved_forwards):
            cls.forward = real_forward


def _metrics_ok(metrics, label):
    import numpy as np

    finite = bool(metrics) and all(np.isfinite(v) for v in metrics.values())
    keys = {"val/loss", "val/e_kin", "val/sinkhorn"}
    if not finite or not keys <= set(metrics):
        log(f"FAIL: {label} metrics missing or not finite: {metrics}")
        return False
    return True


def first_window(case, test):
    """Features and flat particle types of the test batch's first window."""
    import numpy as np
    import torch

    isl = test.input_seq_length
    batch = [test[i] for i in range(BATCH)]
    pos = torch.as_tensor(np.stack([b[0] for b in batch]), device=case.device)[:, :, :isl]
    ptype = torch.as_tensor(np.stack([b[1] for b in batch]), device=case.device)
    _, nbrs = case.allocate_eval((pos[0], ptype[0]))
    with torch.no_grad():
        feats, _ = case.preprocess_eval_batched((pos, ptype), nbrs.broadcast(BATCH))
    return feats, ptype.reshape(-1)


def painn_forward_diff(std_model, fused_model, case, test):
    """max |acc_fused - acc_std| / max |acc_std| on the test batch's first
    window (both layouts through their kernels)."""
    import torch

    feats, ptype = first_window(case, test)
    with torch.no_grad():
        a = std_model(feats, ptype)["acc"]
        b = fused_model(feats, ptype)["acc"]
    return float((b - a).abs().max() / a.abs().max())


class SenderGathers:
    """Records the row width of every ``gather_rows`` call the PaiNN
    model's forward makes (``models.painn.gather_rows``); the fused layout
    must make none at K5's (2 + dim) H: K5 gathers the sender rows itself."""

    def __enter__(self):
        from lagrangebench_torch.models import painn

        self.module, self.real, self.widths = painn, painn.gather_rows, []

        def gather(src, idx):
            self.widths.append(src.shape[-1])
            return self.real(src, idx)

        painn.gather_rows = gather
        return self

    def __exit__(self, *exc):
        self.module.gather_rows = self.real

    def k5_rows(self) -> int:
        return self.widths.count((2 + DIM) * LATENT)


def made_tensor_shapes(fn) -> set:
    """The shape of every tensor an aten operation returns while fn() runs
    (a TorchDispatchMode over the call; the kernels' own launches allocate
    through torch.empty and show up too)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    shapes = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    shapes.add(tuple(t.shape))
            return out

    with Record():
        fn()
    return shapes


def painn_path(device):
    """Slice 3: K6/K5 checks, then PaiNN-5-128 through runner.train_or_infer:
    the standard layout trains and infers (mode=all), the fused layout
    infers from its checkpoint (mode=infer) and trains 3 steps; launch
    counts, metrics, timings and profiles."""
    import numpy as np
    import torch

    from lagrangebench_torch import runner
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.ops import painn_msg
    from lagrangebench_torch.train import Trainer

    seen = capture_painn_inputs(device)
    n, k, _ = seen["painn_msg"][0].shape
    log(f"PaiNN slice shapes: B*N = {n}, K = {k}, H = {seen['painn_msg'][3]}")
    rows, ok = compare_painn_kernels(seen)
    del seen

    kernels = (painn_msg.PAINN_MSG, painn_msg.PAINN_LAYER)
    layers = int(PAINN_CONFIG["model"]["num_mp_steps"])
    with tempfile.TemporaryDirectory() as tmp:
        # the trainer checkpoints at eval steps (as the JAX trainer does), so
        # the one in-training eval is the last step; eval.train.n_trajs must
        # fit the 2 synthetic validation trajectories
        common = {"eval.n_rollout_steps": PAINN_ROLLOUT, "eval.infer.n_trajs": BATCH,
                  "eval.train.n_trajs": 1, "eval.rollout_dir": f"{tmp}/rollouts",
                  "logging.ckp_dir": f"{tmp}/ckp", "logging.eval_steps": PAINN_STEP_MAX}
        if str(device) == "cpu":  # a rehearsal on the CPU; the card is the runner's default
            common["gpu"] = -1
        cfg = painn_cfg(mode="all", **{"train.step_max": PAINN_STEP_MAX}, **common)
        data = runner_data(cfg)
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Recorder() as rec:
            metrics = runner.train_or_infer(cfg, data=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {kern.name: kern.launches for kern in kernels}
        log(f"painn standard (mode=all): {wall:.1f} s wall, {rec.forwards} forward passes, "
            f"launches {counts}; losses {[round(x, 5) for x in rec.losses]}")
        log(f"painn standard metrics: {metrics}")
        rows["painn_msg"]["launches"] = counts["painn_msg"]
        if counts != {"painn_msg": layers * rec.forwards, "painn_layer": 0} or rec.forwards < 1:
            log(f"FAIL: launch counts {counts}, expected K6 = {layers} x {rec.forwards}, K5 = 0")
            ok = False
        if len(rec.losses) != PAINN_STEP_MAX + 1 or not np.all(np.isfinite(rec.losses)):
            log("FAIL: the standard run did not take finite training steps")
            ok = False
        ok &= _metrics_ok(metrics, "standard")
        d = np.asarray(rec.trainers[0].timer.durations) * 1e3
        log(f"painn train: ms per step (host clock, synchronized) median {np.median(d):.2f} "
            f"(all {np.round(d, 2).tolist()}) [batch 1 x {N_PARTICLES} particles, "
            f"PaiNN-{layers}-128 float32, standard layout]")
        std_model, case = rec.models[0], rec.cases[0]
        trainer = rec.trainers[0]
        run_dir = os.path.join(cfg.logging.ckp_dir, cfg.logging.run_name)

        cfg2 = painn_cfg(mode="infer", load_ckp=run_dir,
                         **{"model.fused_processor": True}, **common)
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        with _Recorder() as rec2, SenderGathers() as gathers2:
            metrics2 = runner.train_or_infer(cfg2, data=data)
        torch.cuda.synchronize()
        counts2 = {kern.name: kern.launches for kern in kernels}
        attempts = rec2.forwards // PAINN_ROLLOUT
        log(f"painn fused (mode=infer from the standard checkpoint): {rec2.forwards} forward "
            f"passes, launches {counts2}, sender gather_rows at K5's width "
            f"{gathers2.k5_rows()} (must be 0)")
        if gathers2.k5_rows():
            log("FAIL: the fused forward gathered the sender rows outside K5")
            ok = False
        log(f"painn fused metrics: {metrics2}")
        rows["painn_layer"]["launches"] = counts2["painn_layer"]
        if attempts < 1 or counts2 != {"painn_msg": 0,
                                       "painn_layer": layers * PAINN_ROLLOUT * attempts}:
            log(f"FAIL: launch counts {counts2}, expected K5 = {layers} x {PAINN_ROLLOUT} x "
                f"{attempts}, K6 = 0")
            ok = False
        ok &= _metrics_ok(metrics2, "fused")
        fused_model = rec2.models[0]
        rel = {key: abs(metrics2[key] - metrics[key]) / max(abs(metrics[key]), 1e-30)
               for key in metrics}
        log("painn fused vs standard metrics, relative difference: "
            + json.dumps({k: float(f"{v:.3g}") for k, v in rel.items()}))
        acc_err = painn_forward_diff(std_model, fused_model, rec.cases[0], data[2])
        log(f"painn fused vs standard: one forward max|acc diff| {acc_err:.3g} of the largest, "
            f"val/mse1 {rel['val/mse1']:.3g} (tol {PAINN_FUSED_RTOL} each)")
        ok &= acc_err <= PAINN_FUSED_RTOL and rel["val/mse1"] <= PAINN_FUSED_RTOL
        feats, flat_ptype = first_window(rec.cases[0], data[2])
        n_rows, k_cap = feats["senders"].shape
        gathered = (n_rows, k_cap, (2 + DIM) * LATENT)
        with torch.no_grad():
            shapes = made_tensor_shapes(lambda: fused_model(feats, flat_ptype))
        log(f"painn fused forward: a {gathered} tensor made {gathered in shapes} (must be False)")
        if gathered in shapes:
            log("FAIL: the fused forward made the gathered sender rows")
            ok = False
        del feats

        # how float32 differences grow along a rollout of the same weights:
        # the fused model against the standard one, and the fused model
        # through K5 against itself through the plain layer (a report, not a
        # gate); differences are taken across the periodic box
        test = data[2]
        isl = int(cfg.model.input_seq_length)
        batch = [test[i] for i in range(BATCH)]
        pos = torch.as_tensor(np.stack([b[0] for b in batch]), device=device)
        ptype = torch.as_tensor(np.stack([b[1] for b in batch]), device=device)
        _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
        nbrs = nbrs.broadcast(BATCH)
        preds = {}
        for label, model in (("standard", std_model), ("fused", fused_model),
                             ("fused plain", fused_model)):
            real_layer = painn_msg.painn_layer
            if label == "fused plain":
                painn_msg.painn_layer = painn_msg.painn_layer_plain
            try:
                preds[label], _, _ = rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs,
                                                   pos[:, :, isl:])
            finally:
                painn_msg.painn_layer = real_layer

        def drift(a, b):
            d = torch.remainder(a - b + BOX / 2, BOX) - BOX / 2
            return [float(f"{x:.3g}") for x in d.abs().amax(dim=(0, 2, 3)).tolist()]

        log(f"painn rollout drift, max |position difference| per step: fused (K5) vs standard "
            f"{drift(preds['fused'], preds['standard'])}; fused (K5) vs fused (plain layer) "
            f"{drift(preds['fused'], preds['fused plain'])}")
        del preds

        # three training steps on the fused model
        _, valid, _ = data
        train_cfg = painn_cfg(**common)
        tr = Trainer(fused_model, case, data[0], valid, cfg_train=train_cfg.train,
                     cfg_eval=train_cfg.eval, cfg_logging={"log_steps": 1, "eval_steps": 10**9},
                     input_seq_length=int(train_cfg.model.input_seq_length), device=device)
        steps, _ = record_steps(tr)
        before = [p.detach().clone() for p in fused_model.parameters()]
        for kern in kernels:
            kern.launches = 0
        with _Recorder() as rec3, SenderGathers() as gathers3:
            tr.train(step_max=2)
        passes = rec3.forwards
        counts3 = {kern.name: kern.launches for kern in kernels}
        changed = sum(not torch.equal(a, b) for a, b in zip(before, fused_model.parameters()))
        losses = [loss for _, loss in steps]
        d = np.asarray(tr.timer.durations) * 1e3
        log(f"painn fused training: losses {losses}, {changed} of {len(before)} parameter "
            f"tensors changed, {passes} forward passes, launches {counts3}, forward sender "
            f"gather_rows at K5's width {gathers3.k5_rows()} (must be 0); ms per step (host "
            f"clock, synchronized, steps 1-2) {np.round(d, 2).tolist()} [batch 1 x "
            f"{N_PARTICLES} particles, PaiNN-{layers}-128 float32, fused layout]")
        if (len(losses) != 3 or not np.all(np.isfinite(losses)) or changed != len(before)
                or counts3 != {"painn_msg": 0, "painn_layer": layers * passes}
                or gathers3.k5_rows()):
            log("FAIL: fused training steps")
            ok = False

        # ms per rollout step and the profiles
        step_ms = {}
        for label, model in (("standard", std_model), ("fused", fused_model)):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                preds, _, _ = rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs,
                                            pos[:, :, isl:])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3 / PAINN_ROLLOUT)
            step_ms[label] = min(times)
            log(f"painn rollout ({label}): {[round(t, 3) for t in times]} ms per step (batch "
                f"{BATCH} x {N_PARTICLES} particles, PaiNN-{layers}-128 float32)")
            if not torch.isfinite(preds).all():
                log(f"FAIL: {label} rollout predictions are not finite")
                ok = False
        for label, model in (("standard", std_model), ("fused", fused_model)):
            profile_steps(model, case, pos, ptype, nbrs, steps=1, isl=isl,
                          label=f"painn {label} rollout")
        pos_t, ptype_t = next(iter(trainer.loader_train))
        raw = trainer._batch((pos_t, ptype_t))
        _, _, tnbrs = trainer.case.allocate(trainer.generator, (pos_t[0], ptype_t[0]))
        profile_train_step(trainer, raw, tnbrs, batch=1, unroll=0,
                           label="painn standard train")
    return rows, ok, step_ms


def painn_reference_check(device):
    """A small float32 PaiNN (1,000 particles, 2 layers, H = 128) on the
    card against the CPU (TF32 off), both layouts: a 3-step rollout
    (positions 1e-5 absolute) and 3 training steps fed the same host-drawn
    noise (losses 1e-5 relative, parameters 1e-5 absolute)."""
    import numpy as np
    import torch

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.train import Trainer

    ok = True
    for fused in (False, True):
        cfg = painn_cfg(**{"model.num_mp_steps": 2, "model.fused_processor": fused,
                           "eval.n_rollout_steps": 3, "eval.train.n_trajs": 1,
                           "train.batch_size": 2})
        train, valid, test = runner_data(cfg, n_particles=1000)
        isl = int(cfg.model.input_seq_length)
        preds, losses, params = [], [], []
        for dev in (device, "cpu"):
            case, model = painn_case_model(cfg, test.metadata, dev)
            batch = [test[i] for i in range(BATCH)]
            pos = torch.as_tensor(np.stack([b[0] for b in batch]), device=case.device)
            ptype = torch.as_tensor(np.stack([b[1] for b in batch]), device=case.device)
            _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
            p, _, _ = rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs.broadcast(BATCH),
                                    pos[:, :, isl:isl + 3])
            preds.append(p.cpu())
            tr = Trainer(model, case, train, valid, cfg_train=cfg.train, cfg_eval=cfg.eval,
                         cfg_logging={"log_steps": 1, "eval_steps": 10**9},
                         input_seq_length=isl, device=dev)
            steps, _ = record_steps(tr)
            tr.train(step_max=2)
            losses.append(np.asarray([loss for _, loss in steps]))
            params.append(checkpoint.flatten_tree(model.jax_params()))
        pos_err = float((preds[0] - preds[1]).abs().max())
        loss_err = float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1])))
        par_err, worst = max((float(np.max(np.abs(params[0][k] - params[1][k]))), k)
                             for k in params[1])
        passed = (pos_err <= 1e-5 and len(losses[0]) == 3 and loss_err <= 1e-5
                  and par_err <= 1e-5)
        ok &= passed
        log(f"painn reference ({'fused' if fused else 'standard'}), cuda vs cpu float32: "
            f"positions after 3 steps {pos_err:.3g} (tol 1e-5); 3 training steps, losses "
            f"{losses[0].tolist()} vs {losses[1].tolist()}, max rel diff {loss_err:.3g} (tol "
            f"1e-5); parameters max abs diff {par_err:.3g} at {worst} (tol 1e-5)"
            f"{'' if passed else '  FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# slice 4: GNS-10-128 in the slot layout (K7, K8) and with in-kernel edge
# geometry (K9), through the runner
# ---------------------------------------------------------------------------

# configs/rpf_3d/base.yaml and configs/rpf_3d/gns.yaml, resolved;
# tests/test_torch_slot.py holds it equal to the YAML over the defaults
GNS_CONFIG = {
    "dataset": {"src": "datasets/3D_RPF_8000_10kevery100"},
    "logging": {"wandb_project": "rpf_3d"},
    "model": {"name": "gns", "fused_processor": True, "compute_dtype": "bfloat16",
              "num_mp_steps": 10, "latent_dim": 128},
    "train": {"optimizer": {"lr_start": 5.0e-4}},
    "neighbors": {"backend": "auto"},
}
SLOT_ROLLOUT = 20
# K7 and K9 against their plain versions: ids, maps and row counts exactly;
# the geometry within 1e-6 (both round alike, no FMA contraction and a
# correctly rounded sqrt, so a right kernel reads 0). K8: K3's limits.
GEOM_TOL = 1e-6
# Slot vs dense and geometry on vs off, from the same weights in float32
# (TF32 off): one forward, max |acc diff| <= 1e-4 x max |acc|; slot vs
# dense also the first rollout step's MSE, 1e-4 relative. The layouts sum
# in other orders (the K-sum over other slot orders, products over other
# row counts); later rollout steps are printed, not gated.
LAYOUT_RTOL = 1e-4


def gns_cfg(**overrides):
    return shipped_cfg(GNS_CONFIG, **overrides)


def gns_case(cfg, metadata, device):
    from lagrangebench_torch.case import case_builder

    return case_builder([BOX] * DIM, metadata, cfg.model.input_seq_length,
                        cfg_neighbors=cfg.neighbors, cfg_model=cfg.model,
                        noise_std=cfg.train.noise_std, device=device)


def gns_case_model(cfg, metadata, device, seed=0):
    from lagrangebench_torch.models import setup_model

    return gns_case(cfg, metadata, device), setup_model(cfg.model, metadata, seed=seed,
                                                        device=device)


def test_batch(test, device, bsz):
    import numpy as np
    import torch

    batch = [test[i] for i in range(bsz)]
    pos = torch.as_tensor(np.stack([b[0] for b in batch]), device=device)
    ptype = torch.as_tensor(np.stack([b[1] for b in batch]), device=device)
    return pos, ptype


def capture_slot_inputs(device):
    """K7's and K8's inputs from one slot preprocess and one bf16 forward
    of path A (8,000 particles, 3D, batch 1), K9's from one dense
    preprocess with in-kernel geometry at batch 2; run on the plain
    versions. Also returns the slot list of that preprocess and its
    positions, for the maps check."""
    import torch

    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    cfg = gns_cfg(**{"neighbors.format": "slot"})
    _, _, test = runner_data(cfg)
    case, model = gns_case_model(cfg, test.metadata, device)
    geo_case = gns_case(gns_cfg(**{"neighbors.emit_geometry": True}), test.metadata, device)
    isl = int(cfg.model.input_seq_length)
    pos, ptype = test_batch(test, device, BATCH)
    seen = {}
    real = nlc.slot_scan, nlc.neighbor_scan_geometry, fused_mp.gns_mp_step_slot

    def rec_slot(p, idx, bases, **kw):
        seen.setdefault("slot_scan", ((p.clone(), idx.clone(), bases.clone()), kw))
        return nlc.slot_scan_plain(p, idx, bases, **kw)

    def rec_geom(p, idx, bases, **kw):
        seen.setdefault("neighbor_scan_geometry", ((p.clone(), idx.clone(), bases.clone()), kw))
        return nlc.neighbor_scan_geometry_plain(p, idx, bases, **kw)

    def rec_mp(e, cand, bases, hs, hr, h, p, enc=None):
        key = "fused_mp_slot_enc" if enc is not None else "fused_mp_slot"
        args = tuple(t.clone() for t in (e, cand, bases, hs, hr, h))
        seen.setdefault(key, (args + (p, enc), {}))
        return fused_mp.gns_mp_step_slot_plain(e, cand, bases, hs, hr, h, p, enc)

    nlc.slot_scan, nlc.neighbor_scan_geometry, fused_mp.gns_mp_step_slot = (
        rec_slot, rec_geom, rec_mp)
    try:
        with torch.no_grad():
            _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
            feats, nbrs = case.preprocess_eval_batched((pos[:1, :, :isl], ptype[:1]),
                                                       nbrs.broadcast(1))
            model(feats, ptype[:1].reshape(-1))
            _, gnbrs = geo_case.allocate_eval((pos[0, :, :isl], ptype[0]))
            seen.pop("neighbor_scan_geometry")  # K9's inputs at batch 2, below
            geo_case.preprocess_eval_batched((pos[:, :, :isl], ptype), gnbrs.broadcast(BATCH))
    finally:
        nlc.slot_scan, nlc.neighbor_scan_geometry, fused_mp.gns_mp_step_slot = real
    return seen, nbrs.select(0), pos[0, :, isl - 1]


def compare_slot_kernels(seen, nbrs, position):
    """K7, K9 and K8 against their plain versions on the captured inputs,
    timed; and the whole slot update (K1, K7 and the maps) on the card
    against the same update on the CPU."""
    import torch

    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    funcs = {
        "slot_scan": (nlc.slot_scan, nlc.slot_scan_plain, nlc.SLOT_SCAN, (0, 3)),
        "neighbor_scan_geometry": (nlc.neighbor_scan_geometry, nlc.neighbor_scan_geometry_plain,
                                   nlc.NEIGHBOR_SCAN_GEOMETRY, (0, 2)),
        "fused_mp_slot": (fused_mp.gns_mp_step_slot, fused_mp.gns_mp_step_slot_plain,
                          fused_mp.FUSED_MP_SLOT, None),
        "fused_mp_slot_enc": (fused_mp.gns_mp_step_slot, fused_mp.gns_mp_step_slot_plain,
                              fused_mp.FUSED_MP_SLOT_ENC, None),
    }
    rows, ok = {}, True
    for name, (kern, plain, handle, int_outs) in funcs.items():
        args, kw = seen[name]
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        bkw = dict(kw)
        if int_outs is not None:
            ids = max(int((got[i].long() - want[i].long()).abs().max()) for i in int_outs)
            err = max(float((a - b).abs().max()) for i, (a, b) in enumerate(zip(got, want))
                      if i not in int_outs)
            passed = ids == 0 and err <= GEOM_TOL
            bkw["hits"] = int((want[0] < (args[2].shape[1] * args[0].shape[1]
                                          if name == "slot_scan" else kw["n"])).sum())
            log(f"{name}: ids and row counts max|kernel-plain| {ids} (must be 0), geometry "
                f"{err:.3g} (tol {GEOM_TOL}){'' if passed else '  FAIL'}")
        else:
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
            a32 = [t.float() if t.is_floating_point() else t for t in args[:6]]
            p32 = fused_mp.kernel_params(args[6], torch.float32)
            e32 = fused_mp.kernel_params(args[7], torch.float32) if args[7] else None
            g32, w32 = kern(*a32, p32, e32), plain(*a32, p32, e32)
            torch.cuda.synchronize()
            err32 = max(float((a - b).abs().max()) for a, b in zip(g32, w32))
            passed = err <= K3_TOL["bfloat16"] and err32 <= K3_TOL["float32"]
            log(f"{name}: bf16 max|kernel-plain| {err:.4g} (tol {K3_TOL['bfloat16']}), float32 "
                f"(TF32 off) {err32:.3g} (tol {K3_TOL['float32']}){'' if passed else '  FAIL'}")
        ok &= passed
        ms = cuda_time(lambda: kern(*args, **kw))
        plain_ms = cuda_time(lambda: plain(*args, **kw), iters=5, warmup=1)
        bms, by = bound(name, args, bkw)
        rows[name] = {
            "name": name, "route": "cuda", "source": handle.source_path,
            "replaces": handle.replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
        }
        log(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by})")

    # the slot update end to end (K1, K7 and the maps) on the card vs the CPU
    got, want = nbrs.update(position), nbrs.update(position.cpu())
    same = torch.equal(got.idx.cpu(), want.idx) and all(
        torch.equal(got.aux[key].cpu(), want.aux[key])
        for key in ("slot_to_particle", "particle_to_slot", "bases"))
    geo = max(float((got.aux[key].cpu() - want.aux[key]).abs().max())
              for key in ("rel_disp", "rel_dist"))
    log(f"slot update, card vs CPU: cand and maps equal {same}, geometry {geo:.3g} (tol "
        f"{GEOM_TOL})")
    ok &= same and geo <= GEOM_TOL
    return rows, ok


def layout_checks(ckp, data, device):
    """The float32 gates of the same weights (TF32 off): slot vs dense at
    batch 1 (one forward; the first rollout step's MSE, later steps
    printed) and dense with in-kernel geometry vs without at batch 2 (one
    forward)."""
    import torch

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.evaluate.rollout import rollout_batch

    test = data[2]
    params = checkpoint.load_checkpoint(ckp)[0]
    cfg = gns_cfg(**{"model.compute_dtype": "float32"})
    _, model = gns_case_model(cfg, test.metadata, device)
    model.load_jax_params(params)
    cases = {label: gns_case(gns_cfg(**dots), test.metadata, device)
             for label, dots in (("dense", {}), ("slot", {"neighbors.format": "slot"}),
                                 ("geometry", {"neighbors.emit_geometry": True}))}
    isl = test.input_seq_length
    pos, ptype = test_batch(test, device, BATCH)

    def forward(label, bsz):
        case = cases[label]
        _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
        with torch.no_grad():
            feats, nbrs = case.preprocess_eval_batched((pos[:bsz, :, :isl], ptype[:bsz]),
                                                       nbrs.broadcast(bsz))
            return model(feats, ptype[:bsz].reshape(-1))["acc"], nbrs

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    acc_slot, nb_slot = forward("slot", 1)
    acc_dense, nb_dense = forward("dense", 1)
    slot_err = rel(acc_slot, acc_dense)
    acc_geo, _ = forward("geometry", BATCH)
    acc_gather, _ = forward("dense", BATCH)
    geo_err = rel(acc_geo, acc_gather)
    mse = {}
    for label, nbrs in (("slot", nb_slot), ("dense", nb_dense)):
        preds, _, _ = rollout_batch(model, cases[label], pos[:1, :, :isl], ptype[:1], nbrs,
                                    pos[:1, :, isl:])
        d = torch.remainder(preds[0] - pos[0, :, isl:].permute(1, 0, 2) + BOX / 2, BOX) - BOX / 2
        mse[label] = (d ** 2).sum(-1).mean(-1)  # per step
    mse_rel = ((mse["slot"] - mse["dense"]).abs() / mse["dense"]).tolist()
    log(f"slot vs dense (float32, batch 1): one forward max|acc diff| {slot_err:.3g} of the "
        f"largest, first step MSE {mse_rel[0]:.3g} relative (tol {LAYOUT_RTOL} each); MSE "
        f"relative difference per step {[float(f'{x:.3g}') for x in mse_rel]}")
    log(f"geometry on vs off (float32, batch 2): one forward max|acc diff| {geo_err:.3g} of the "
        f"largest (tol {LAYOUT_RTOL})")
    passed = max(slot_err, mse_rel[0], geo_err) <= LAYOUT_RTOL
    if not passed:
        log("FAIL: slot vs dense or geometry on vs off")
    return passed


def slot_path(device):
    """Slice 4: K7, K9 and K8 checks; path A (slot rollout, batch 1) and
    path C (dense with in-kernel geometry, batch 2) through
    runner.train_or_infer from a checkpoint of seeded bf16 weights; the
    float32 layout gates; path B (3 slot training steps); timings and a
    profile of a slot rollout step."""
    import numpy as np
    import torch

    from lagrangebench_torch import checkpoint, runner
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.ops import neighbors_cuda as nlc
    from lagrangebench_torch.train import Trainer

    seen, nbrs, position = capture_slot_inputs(device)
    n_ext, k = seen["fused_mp_slot"][0][1].shape
    n_cols = seen["slot_scan"][1]["n_cols"]
    log(f"slot shapes: N = {N_PARTICLES}, n_cols = {n_cols}, C = {n_ext // (n_cols + 1)}, "
        f"n_ext = {n_ext}, K = {k}; geometry scan table "
        f"{tuple(seen['neighbor_scan_geometry'][0][0].shape)}")
    rows, ok = compare_slot_kernels(seen, nbrs, position)
    del seen, nbrs

    kernels = (nlc.COLUMN_TABLE, nlc.NEIGHBOR_SCAN, nlc.NEIGHBOR_SCAN_GEOMETRY, nlc.SLOT_SCAN,
               fused_mp.FUSED_MP, fused_mp.FUSED_MP_ENC, fused_mp.FUSED_MP_SLOT,
               fused_mp.FUSED_MP_SLOT_ENC)
    mp = int(GNS_CONFIG["model"]["num_mp_steps"])

    def run(label, cfg, data, expect):
        """One runner call with the counters zeroed around it; ``expect``
        maps (forwards, allocations) to the launch counts."""
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Recorder() as rec:
            metrics = runner.train_or_infer(cfg, data=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {kern.name: kern.launches for kern in kernels}
        want = {kern.name: 0 for kern in kernels}
        want.update(expect(rec.forwards, rec.allocations))
        log(f"{label}: {wall:.1f} s wall, {rec.forwards} forward passes, {rec.allocations} "
            f"allocations, launches {counts}")
        log(f"{label} metrics: {metrics}")
        passed = counts == want and rec.forwards >= SLOT_ROLLOUT and _metrics_ok(metrics, label)
        if counts != want:
            log(f"FAIL: {label} launch counts, expected {want}")
        return passed, counts, rec, metrics

    with tempfile.TemporaryDirectory() as tmp:
        common = {"eval.n_rollout_steps": SLOT_ROLLOUT, "eval.infer.n_trajs": BATCH,
                  "eval.rollout_dir": f"{tmp}/rollouts"}
        if str(device) == "cpu":  # a rehearsal on the CPU; the card is the runner's default
            common["gpu"] = -1
        cfg = gns_cfg(**common)
        data = runner_data(cfg)
        _, seeded = gns_case_model(cfg, data[0].metadata, device, seed=0)
        ckp = f"{tmp}/ckp"
        checkpoint.save_checkpoint(ckp, seeded.jax_params(), {}, {"step": 0, "loss": None})
        del seeded

        # path A: the slot rollout at batch 1 through the runner
        cfg_a = gns_cfg(mode="infer", load_ckp=ckp, **{"neighbors.format": "slot",
                                                       "eval.infer.batch_size": 1}, **common)
        passed, counts_a, rec_a, metrics_a = run(
            "path A (slot, batch 1)", cfg_a, data,
            lambda fw, al: {"column_table": fw + al, "slot_scan": fw + al,
                            "fused_mp_slot": (mp - 1) * fw, "fused_mp_slot_enc": fw})
        ok &= passed
        rows["slot_scan"]["launches"] = counts_a["slot_scan"]
        rows["fused_mp_slot"]["launches"] = counts_a["fused_mp_slot"]
        rows["fused_mp_slot_enc"]["launches"] = counts_a["fused_mp_slot_enc"]
        slot_case, model = rec_a.cases[0], rec_a.models[0]

        # path C: dense with in-kernel geometry at batch 2 through the runner
        cfg_c = gns_cfg(mode="infer", load_ckp=ckp, **{"neighbors.emit_geometry": True},
                        **common)
        passed, counts_c, rec_c, metrics_c = run(
            "path C (dense + geometry, batch 2)", cfg_c, data,
            lambda fw, al: {"column_table": fw + al, "neighbor_scan_geometry": fw + al,
                            "fused_mp": (mp - 1) * fw, "fused_mp_enc": fw})
        ok &= passed
        rows["neighbor_scan_geometry"]["launches"] = counts_c["neighbor_scan_geometry"]
        geo_case = rec_c.cases[0]
        rel = {key: abs(metrics_a[key] - metrics_c[key]) / max(abs(metrics_c[key]), 1e-30)
               for key in metrics_c}
        log("bf16 slot (batch 1) vs dense + geometry (batch 2) metrics, relative difference "
            "(printed, not gated): " + json.dumps({k: float(f"{v:.3g}") for k, v in rel.items()}))

        ok &= layout_checks(ckp, data, device)

        # path B: three slot training steps at batch 1
        cfg_b = gns_cfg(**{"neighbors.format": "slot", "eval.train.n_trajs": 1}, **common)
        isl = int(cfg_b.model.input_seq_length)
        tr = Trainer(model, slot_case, data[0], data[1], cfg_train=cfg_b.train,
                     cfg_eval=cfg_b.eval, cfg_logging={"log_steps": 1, "eval_steps": 10**9},
                     input_seq_length=isl, device=device)
        steps, allocs = record_steps(tr)
        before = [p.detach().clone() for p in model.parameters()]
        for kern in kernels:
            kern.launches = 0
        with _Recorder() as rec_b:
            tr.train(step_max=2)
        counts_b = {kern.name: kern.launches for kern in kernels}
        fw = rec_b.forwards
        want_b = {kern.name: 0 for kern in kernels}
        want_b.update({"column_table": fw + allocs[0], "slot_scan": fw + allocs[0],
                       "fused_mp_slot": (mp - 1) * fw, "fused_mp_slot_enc": fw})
        changed = sum(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
        losses = [loss for _, loss in steps]
        log(f"path B (slot training, batch 1): losses {losses}, {changed} of {len(before)} "
            f"parameter tensors changed, {fw} forward passes, launches {counts_b}")
        if (len(losses) != 3 or not np.all(np.isfinite(losses)) or changed != len(before)
                or counts_b != want_b):
            log(f"FAIL: slot training steps (expected launches {want_b})")
            ok = False
        del tr, before

        # ms per rollout step, in turns: slot and dense at batch 1, geometry
        # on and off at batch 2 (the same bf16 weights and data)
        model.eval()
        dense_case = gns_case(cfg, data[0].metadata, device)
        pos, ptype = test_batch(data[2], device, BATCH)
        runs = {"slot b1": (slot_case, 1), "dense b1": (dense_case, 1),
                "geometry b2": (geo_case, BATCH), "dense b2": (dense_case, BATCH)}
        lists = {}
        for label, (case, bsz) in runs.items():
            _, nb = case.allocate_eval((pos[0, :, :isl], ptype[0]))
            lists[label] = nb.broadcast(bsz)
        times = {label: [] for label in runs}
        for order in (list(runs), list(runs)[::-1]):
            for label in order:
                case, bsz = runs[label]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                preds, _, _ = rollout_batch(model, case, pos[:bsz, :, :isl], ptype[:bsz],
                                            lists[label], pos[:bsz, :, isl:])
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) * 1e3 / SLOT_ROLLOUT)
                if not torch.isfinite(preds).all():
                    log(f"FAIL: {label} rollout predictions are not finite")
                    ok = False
        for label, ts in times.items():
            log(f"rollout ({label}): {[round(t, 3) for t in ts]} ms per step ({N_PARTICLES} "
                f"particles per sample, GNS-{mp}-128 bf16)")
        profile_steps(model, slot_case, pos[:1], ptype[:1], lists["slot b1"], steps=1, isl=isl,
                      label="slot rollout",
                      rename={"fused_mp": "K8 fused_mp_slot", "neighbor_scan": "K7 slot_scan"})
    step_ms = {label: min(ts) for label, ts in times.items()}
    return rows, ok, step_ms


def slot_reference_check(device):
    """A small float32 slot GNS (1,000 particles, 2 MP steps, latent 128,
    batch 1) on the card against the CPU (TF32 off): a 3-step rollout,
    positions within 1e-5."""
    from lagrangebench_torch.evaluate.rollout import rollout_batch

    cfg = gns_cfg(**{"model.num_mp_steps": 2, "model.compute_dtype": "float32",
                     "neighbors.format": "slot"})
    _, _, test = runner_data(cfg, n_particles=1000)
    isl = int(cfg.model.input_seq_length)
    preds = []
    for dev in (device, "cpu"):
        case, model = gns_case_model(cfg, test.metadata, dev)
        pos, ptype = test_batch(test, dev, 1)
        _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
        p, _, _ = rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs.broadcast(1),
                                pos[:, :, isl:isl + 3])
        preds.append(p.cpu())
    err = float((preds[0] - preds[1]).abs().max())
    log(f"slot reference: max |cuda - cpu| position after 3 steps {err:.3g} (tol 1e-5)")
    return err <= 1e-5


# ---------------------------------------------------------------------------
# slice 5: the experiments path, the row gather (E1) and the windowed
# select (E2)
# ---------------------------------------------------------------------------

E1_REPS = 24  # the repeated-gather form (E1g) at its largest count


def compare_row_gather(device):
    """E1 against its plain version, equal, in every form at variant 1's
    shape (h 8192 x 128, idx 8192 x 24: bf16 and float32, the (R, K), the
    transposed (K, R) and a flat (R,) index, the gather and the sum of 24)
    and on the real neighbor indices of the 8,000-particle 3D case; timed
    at variant 1's form with ``torch.index_select`` beside it."""
    import numpy as np
    import torch

    from lagrangebench_torch.experiments import gather_variants as gv
    from lagrangebench_torch.experiments._setup import real_neighbor_indices
    from lagrangebench_torch.ops import row_gather as rg

    rng = np.random.default_rng(0)
    hb = torch.as_tensor(rng.normal(size=(gv.N, gv.F)), dtype=torch.bfloat16, device=device)
    idx = torch.as_tensor(rng.integers(0, gv.N, size=(gv.N, gv.K)), dtype=torch.int32,
                          device=device)
    real = real_neighbor_indices(gv.N_REAL, DIM, gv.ISL, device=device)
    hr = torch.as_tensor(rng.normal(size=(gv.N_REAL, gv.F)), dtype=torch.bfloat16, device=device)
    ok, forms, worst = True, [], 0.0
    for dt in (torch.bfloat16, torch.float32):
        cases = [("(R, K)", hb, idx, False), ("(K, R)", hb, idx.t().contiguous(), True),
                 ("flat (R,)", hb, idx[:, 0].contiguous(), False), ("real (N, K)", hr, real, False)]
        for label, h, ix, tr in cases:
            for reps in (1, E1_REPS):
                got = rg.row_gather(h.to(dt), ix, transposed=tr, reps=reps)
                want = rg.row_gather_plain(h.to(dt), ix, transposed=tr, reps=reps)
                same = got.shape == want.shape and torch.equal(got, want)
                if got.shape == want.shape:
                    worst = max(worst, float((got.float() - want.float()).abs().max()))
                ok &= same
                forms.append(f"{str(dt)[6:]} {label} x{reps}: {'equal' if same else 'DIFFERENT'}")
    torch.cuda.synchronize()
    log("row_gather vs plain: " + "; ".join(forms) + ("" if ok else "  FAIL"))
    flat = idx.reshape(-1)
    ms = cuda_time(lambda: rg.row_gather(hb, idx))
    plain_ms = cuda_time(lambda: rg.row_gather_plain(hb, idx), iters=5, warmup=1)
    library_ms = cuda_time(lambda: torch.index_select(hb, 0, flat))
    bms, by = bound("row_gather", (hb, idx), {})
    log(f"row_gather: {ms:.4f} ms (plain {plain_ms:.4f} ms, index_select {library_ms:.4f} ms, "
        f"bound {bms:.4f} ms by {by}) at h {tuple(hb.shape)} bf16, idx {tuple(idx.shape)}")
    row = {"name": "row_gather", "route": "cuda", "source": rg.ROW_GATHER.source_path,
           "replaces": rg.ROW_GATHER.replaces, "max_abs_err": worst,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": library_ms}
    return row, ok


def window_inputs(structure, dtype, device):
    """E2's inputs on the probe's structure: seeded e, h, hr, hs (as the
    probe's main makes them), hs_ext = hs[ext_idx], the weights of
    ``window_select.init_step_params`` (seed 0) in the kernel's layout."""
    import numpy as np
    import torch

    from lagrangebench_torch.experiments import window_select as ws
    from lagrangebench_torch.ops import fused_mp

    n_rows, _, ext_idx, cand, w0s, _, wsub = structure
    rng = np.random.default_rng(1)
    e, h, hr, hs = (torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=device)
                    for shape in ((n_rows, ws.K, ws.F), (n_rows, ws.F), (n_rows, ws.F),
                                  (n_rows, ws.F)))
    p = fused_mp.kernel_params(ws.init_step_params(ws.F, torch.Generator().manual_seed(0)), dtype)
    p = {name: v.to(device) for name, v in p.items()}
    hs_ext = hs[torch.as_tensor(ext_idx, device=device)]
    return (e, torch.as_tensor(cand, device=device), torch.as_tensor(w0s, device=device),
            int(wsub), hs_ext, hr, h, p)


def compare_window(structure, device):
    """E2 against its plain version (K3's limits, bf16 and float32 with TF32
    off) on the probe's 8,000-particle structure, and against K3 on the
    decoded, masked gather (printed); timed in bf16."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    ok, errs = True, {}
    for dt, tol in ((torch.bfloat16, K3_TOL["bfloat16"]), (torch.float32, K3_TOL["float32"])):
        args = window_inputs(structure, dt, device)
        e, cand, w0s, wsub, hs_ext, hr, h, p = args
        got = fused_mp.gns_mp_step_window(*args)
        want = fused_mp.gns_mp_step_window_plain(*args)
        rows, mask = fused_mp.window_sender_rows(cand, w0s, wsub)
        hs_g = torch.where(mask[..., None], hs_ext[rows], 0).to(dt).contiguous()
        k3 = fused_mp.gns_mp_step(e, hs_g, hr, h, mask.to(torch.float32), p)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        vs_k3 = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, k3))
        passed = err <= tol
        ok &= passed
        errs[str(dt)[6:]] = err
        log(f"fused_mp_window ({str(dt)[6:]}): max|kernel-plain| {err:.4g} (tol {tol}); "
            f"max|E2 - K3 on the decoded gather| {vs_k3:.4g} (expected 0: the same kernel "
            f"code reads the same rows){'' if passed else '  FAIL'}")
    args = window_inputs(structure, torch.bfloat16, device)
    ms = cuda_time(lambda: fused_mp.gns_mp_step_window(*args))
    plain_ms = cuda_time(lambda: fused_mp.gns_mp_step_window_plain(*args), iters=5, warmup=1)
    bms, by = bound("fused_mp_window", args, {})
    n_rows, k = args[1].shape
    log(f"fused_mp_window: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by}) "
        f"at n_rows = {n_rows}, K = {k}, n_ext = {args[4].shape[0]}, WSUB = {args[3]}, bf16; "
        f"{ms * 1e3 / n_rows:.4f} us per receiver row")
    row = {"name": "fused_mp_window", "route": "cuda",
           "source": fused_mp.FUSED_MP_WINDOW.source_path,
           "replaces": fused_mp.FUSED_MP_WINDOW.replaces, "max_abs_err": errs["bfloat16"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None}
    return row, ok


def experiments_path(device):
    """Slice 5: E1 and E2 against their plain versions, then
    ``window_select.main`` and the six ``gather_variants`` on the card with
    the launch counters zeroed around them."""
    import torch

    from lagrangebench_torch.experiments import gather_variants, window_select
    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.ops import row_gather as rg

    e1_row, ok = compare_row_gather(device)
    w = window_select
    e2_row, e2_ok = compare_window(w.build_structure(w.N, w.DIM, w.K, w.CUTOFF, w.T, w.SUB),
                                   device)
    ok &= e2_ok

    kernels = (rg.ROW_GATHER, fused_mp.FUSED_MP_WINDOW)
    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ws = window_select.main([], device=device)
    gv = gather_variants.main([], device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {kern.name: kern.launches for kern in kernels}
    want_e2 = ws["loops"] * ws["steps"] + ws["check_launches"]
    log(f"experiments: window_select.main and gather_variants 1-6 in {wall:.1f} s wall, "
        f"launches {counts} (E2 expected {ws['loops']} loops x {ws['steps']} steps + "
        f"{ws['check_launches']} check = {want_e2}, E1 > 0)")
    if counts["row_gather"] < 1 or counts["fused_mp_window"] != want_e2:
        log("FAIL: experiments launch counts")
        ok = False
    if ws["max_abs_err"] > K3_TOL["bfloat16"]:
        log(f"FAIL: window_select's check, max |E2 - plain| {ws['max_abs_err']}")
        ok = False
    log(f"window_select (ms per MP step, {ws['steps']}-step loops, bf16, {ws['n_rows']} rows): (b) "
        f"hs[ext_idx] + E2 {ws['window_ms']:.4f}, (a) hs[senders] + K3 {ws['gather_ms']:.4f}")
    log("gather_variants (ms per call): " + json.dumps(
        {v: {name: round(t, 5) for name, t in times.items()} for v, times in gv.items()}))
    e1_row["launches"] = counts["row_gather"]
    e2_row["launches"] = counts["fused_mp_window"]
    return {"row_gather": e1_row, "fused_mp_window": e2_row}, ok


# ---------------------------------------------------------------------------
# slice 8: EGNN-5-128, the standard GNS processor and Linear through the
# runner (K1 and K2 on every neighbor update; the models' products are
# torch.matmul, as the JAX package leaves them to XLA)
# ---------------------------------------------------------------------------

# configs/rpf_3d/base.yaml and configs/rpf_3d/egnn.yaml, resolved;
# tests/test_torch_egnn.py holds it equal to the YAML over the defaults
EGNN_CONFIG = {
    "dataset": {"src": "datasets/3D_RPF_8000_10kevery100"},
    "logging": {"wandb_project": "rpf_3d"},
    "model": {"name": "egnn", "num_mp_steps": 5, "latent_dim": 128, "isotropic_norm": True,
              "magnitude_features": True},
    "train": {"optimizer": {"lr_start": 5.0e-4},
              "loss_weight": {"pos": 1.0, "vel": 0.0, "acc": 0.0}},
}
EGNN_STEP_MAX, EGNN_ROLLOUT = 9, 20  # training steps 0-9, then a 20-step infer
# The standard GNS processor against the fused one from the same weights in
# float32 (TF32 off): one forward, max |acc diff| <= 1e-4 x max |acc|, as
# PaiNN's two layouts are held (the same function, sums in other orders).
STANDARD_RTOL = 1e-4


def egnn_cfg(**overrides):
    return shipped_cfg(EGNN_CONFIG, **overrides)


def _runner_call(label, cfg, data, kernels, neighbor_kernels=True):
    """runner.train_or_infer with the counters zeroed just before and read
    just after; (metrics, counts, recorder, ok). K1 and K2 must launch once
    per neighbor update (a forward or an allocation), every other kernel of
    ``kernels`` never; with ``neighbor_kernels=False`` none may launch."""
    import torch

    from lagrangebench_torch import runner

    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Recorder() as rec:
        metrics = runner.train_or_infer(cfg, data=data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {kern.name: kern.launches for kern in kernels}
    updates = rec.forwards + rec.allocations
    want = {kern.name: 0 for kern in kernels}
    if neighbor_kernels:
        want.update({"column_table": updates, "neighbor_scan": updates})
    log(f"{label}: {wall:.1f} s wall, {rec.forwards} forward passes, {rec.allocations} "
        f"allocations, launches {counts}")
    log(f"{label} metrics: {metrics}")
    ok = counts == want and rec.forwards >= 1 and _metrics_ok(metrics, label)
    if counts != want:
        log(f"FAIL: {label} launch counts, expected {want}")
    return metrics, counts, rec, ok


def _rollout_ms(model, case, test, isl, steps, label, bsz=BATCH, runs=3):
    """ms per rollout step (host clock around ``steps`` synchronized steps),
    ``runs`` times; checks the predictions are finite."""
    import torch

    from lagrangebench_torch.evaluate.rollout import rollout_batch

    pos, ptype = test_batch(test, case.device, bsz)
    _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
    nbrs = nbrs.broadcast(bsz)
    times, finite = [], True
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, _, _ = rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs,
                                    pos[:, :, isl:isl + steps])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
        finite &= bool(torch.isfinite(preds).all())
    log(f"rollout ({label}): {[round(t, 3) for t in times]} ms per step (batch {bsz} x "
        f"{N_PARTICLES} particles)")
    if not finite:
        log(f"FAIL: {label} rollout predictions are not finite")
    return times, finite, (pos, ptype, nbrs)


def egnn_path(device):
    """EGNN-5-128 (configs/rpf_3d/egnn.yaml) through runner.train_or_infer
    with mode=all: 10 training steps, then a 20-step infer (mse, e_kin,
    Sinkhorn); launch counts, finite losses, changed parameters, ms per
    train and rollout step, a profile of one rollout step."""
    import numpy as np
    import torch

    from lagrangebench_torch.models import setup_model
    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    kernels = (nlc.COLUMN_TABLE, nlc.NEIGHBOR_SCAN, fused_mp.FUSED_MP, fused_mp.FUSED_MP_ENC)
    ok, step_ms = True, {}
    with tempfile.TemporaryDirectory() as tmp:
        common = {"eval.n_rollout_steps": EGNN_ROLLOUT, "eval.infer.n_trajs": BATCH,
                  "eval.train.n_trajs": 1, "eval.rollout_dir": f"{tmp}/rollouts",
                  "logging.ckp_dir": f"{tmp}/ckp", "logging.eval_steps": EGNN_STEP_MAX}
        if str(device) == "cpu":  # a rehearsal on the CPU; the card is the runner's default
            common["gpu"] = -1
        cfg = egnn_cfg(mode="all", **{"train.step_max": EGNN_STEP_MAX}, **common)
        data = runner_data(cfg)
        metrics, counts, rec, ok = _runner_call("egnn (mode=all)", cfg, data, kernels)
        model, case = rec.models[0], rec.cases[0]
        fresh = setup_model(cfg.model, data[0].metadata, seed=cfg.seed, device=device,
                            normalization_stats=case.normalization_stats)
        changed = sum(not torch.equal(a, b)
                      for a, b in zip(fresh.parameters(), model.parameters()))
        n_params = len(list(model.parameters()))
        log(f"egnn: losses {[round(x, 6) for x in rec.losses]}; {changed} of {n_params} "
            f"parameter tensors changed")
        if (len(rec.losses) != EGNN_STEP_MAX + 1 or not np.all(np.isfinite(rec.losses))
                or changed != n_params):
            log("FAIL: egnn training steps (count, finite losses, changed parameters)")
            ok = False
        d = np.asarray(rec.trainers[0].timer.durations) * 1e3
        step_ms["egnn train"] = float(np.median(d))
        log(f"egnn train: ms per step (host clock, synchronized) median {np.median(d):.2f} "
            f"(all {np.round(d, 2).tolist()}) [batch {cfg.train.batch_size} x {N_PARTICLES} "
            f"particles, EGNN-5-128 float32]")
        model.eval()
        isl = int(cfg.model.input_seq_length)
        times, finite, (pos, ptype, nbrs) = _rollout_ms(model, case, data[2], isl,
                                                        EGNN_ROLLOUT, "egnn, EGNN-5-128 float32")
        ok &= finite
        step_ms["egnn rollout"] = min(times)
        profile_steps(model, case, pos, ptype, nbrs, steps=1, isl=isl, label="egnn rollout")
    return ok, step_ms


def standard_gns_path(device):
    """GNS-10-128 (configs/rpf_3d/gns.yaml) with model.fused_processor=false
    through runner.train_or_infer, mode=infer at batch 2, from a checkpoint
    of seeded weights in the standard layout; held to the fused processor
    from the same weights in float32; ms per rollout step of both (bf16)."""
    import torch

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.models import ensure_fused_params
    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    kernels = (nlc.COLUMN_TABLE, nlc.NEIGHBOR_SCAN, fused_mp.FUSED_MP, fused_mp.FUSED_MP_ENC)
    step_ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        common = {"eval.n_rollout_steps": SLOT_ROLLOUT, "eval.infer.n_trajs": BATCH,
                  "eval.rollout_dir": f"{tmp}/rollouts", "model.fused_processor": False}
        if str(device) == "cpu":
            common["gpu"] = -1
        cfg = gns_cfg(**common)
        data = runner_data(cfg)
        metadata = data[0].metadata
        _, seeded = gns_case_model(cfg, metadata, device, seed=0)
        ckp = f"{tmp}/ckp"
        checkpoint.save_checkpoint(ckp, seeded.jax_params(), {}, {"step": 0, "loss": None})
        del seeded
        cfg_i = gns_cfg(mode="infer", load_ckp=ckp, **common)
        _, counts, rec, ok = _runner_call("standard GNS (mode=infer, batch 2)", cfg_i, data,
                                          kernels)
        std_bf16, case = rec.models[0], rec.cases[0]

        # float32 gate: the standard processor against the fused one
        params = checkpoint.load_checkpoint(ckp)[0]
        f32 = {"model.compute_dtype": "float32"}
        models = {}
        for label, fused in (("standard", False), ("fused", True)):
            c = gns_cfg(**{**common, **f32, "model.fused_processor": fused})
            _, models[label] = gns_case_model(c, metadata, device)
            models[label].load_jax_params(ensure_fused_params(params, c.model))
        feats, ptype = first_window(case, data[2])
        with torch.no_grad():
            a = models["standard"](feats, ptype)["acc"]
            b = models["fused"](feats, ptype)["acc"]
        err = float((b - a).abs().max() / a.abs().max())
        log(f"standard vs fused GNS (float32, batch 2, one forward): max|acc diff| {err:.3g} of "
            f"the largest (tol {STANDARD_RTOL})")
        if not err <= STANDARD_RTOL:
            log("FAIL: standard vs fused GNS")
            ok = False
        del feats, models

        # ms per rollout step, bf16 as the config: standard, fused, fused, standard
        fused_cfg = gns_cfg(**{**common, "model.fused_processor": True})
        _, fused_bf16 = gns_case_model(fused_cfg, metadata, device)
        fused_bf16.load_jax_params(ensure_fused_params(params, fused_cfg.model))
        isl = int(cfg.model.input_seq_length)
        times = {"standard": [], "fused": []}
        for label in ("standard", "fused", "fused", "standard"):
            model = std_bf16 if label == "standard" else fused_bf16
            t, finite, _ = _rollout_ms(model, case, data[2], isl, SLOT_ROLLOUT,
                                       f"GNS-10-128 bf16, {label} processor", runs=1)
            times[label] += t
            ok &= finite
        step_ms = {f"gns {k} rollout": min(v) for k, v in times.items()}
    return ok, step_ms


def linear_path(device):
    """Linear through runner.train_or_infer, mode=all: 3 training steps and
    a 5-step infer; launch counts and finite metrics."""
    import numpy as np

    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    kernels = (nlc.COLUMN_TABLE, nlc.NEIGHBOR_SCAN, fused_mp.FUSED_MP, fused_mp.FUSED_MP_ENC)
    with tempfile.TemporaryDirectory() as tmp:
        common = {"eval.n_rollout_steps": 5, "eval.infer.n_trajs": BATCH,
                  "eval.train.n_trajs": 1, "eval.rollout_dir": f"{tmp}/rollouts",
                  "logging.ckp_dir": f"{tmp}/ckp", "logging.eval_steps": 2}
        if str(device) == "cpu":
            common["gpu"] = -1
        cfg = shipped_cfg({"dataset": EGNN_CONFIG["dataset"], "model": {"name": "linear"}},
                          mode="all", **{"train.step_max": 2}, **common)
        metrics, _, rec, ok = _runner_call("linear (mode=all)", cfg, runner_data(cfg), kernels)
    if len(rec.losses) != 3 or not np.all(np.isfinite(rec.losses)):
        log(f"FAIL: linear training losses {rec.losses}")
        ok = False
    return ok


def egnn_reference_check(device):
    """A small float32 EGNN (1,000 particles, 2 layers, latent 128) on the
    card against the CPU (TF32 off): a 3-step rollout (positions 1e-5
    absolute) and 3 training steps fed the same host-drawn noise (losses
    1e-5 relative, parameters 1e-5 absolute)."""
    import numpy as np
    import torch

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.models import setup_model
    from lagrangebench_torch.train import Trainer

    cfg = egnn_cfg(**{"model.num_mp_steps": 2, "eval.n_rollout_steps": 3,
                      "eval.train.n_trajs": 1, "train.batch_size": 2})
    train, valid, test = runner_data(cfg, n_particles=1000)
    isl = int(cfg.model.input_seq_length)
    preds, losses, params = [], [], []
    for dev in (device, "cpu"):
        case = gns_case(cfg, test.metadata, dev)
        model = setup_model(cfg.model, test.metadata, device=dev,
                            normalization_stats=case.normalization_stats)
        pos, ptype = test_batch(test, dev, BATCH)
        _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
        p, _, _ = rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs.broadcast(BATCH),
                                pos[:, :, isl:isl + 3])
        preds.append(p.cpu())
        tr = Trainer(model, case, train, valid, cfg_train=cfg.train, cfg_eval=cfg.eval,
                     cfg_logging={"log_steps": 1, "eval_steps": 10**9},
                     input_seq_length=isl, device=dev)
        steps, _ = record_steps(tr)
        tr.train(step_max=2)
        losses.append(np.asarray([loss for _, loss in steps]))
        params.append(checkpoint.flatten_tree(model.jax_params()))
    pos_err = float((preds[0] - preds[1]).abs().max())
    loss_err = float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1])))
    par_err, worst = max((float(np.max(np.abs(params[0][k] - params[1][k]))), k)
                         for k in params[1])
    passed = pos_err <= 1e-5 and len(losses[0]) == 3 and loss_err <= 1e-5 and par_err <= 1e-5
    log(f"egnn reference, cuda vs cpu float32: positions after 3 steps {pos_err:.3g} (tol "
        f"1e-5); 3 training steps, losses {losses[0].tolist()} vs {losses[1].tolist()}, max "
        f"rel diff {loss_err:.3g} (tol 1e-5); parameters max abs diff {par_err:.3g} at {worst} "
        f"(tol 1e-5){'' if passed else '  FAIL'}")
    return passed


# ---------------------------------------------------------------------------
# slice 9: SEGNN-10-64 through the runner (K1 and K2 on every neighbor
# update; the tensor products are torch ops, as the JAX package leaves them
# to XLA)
# ---------------------------------------------------------------------------

# configs/rpf_3d/base.yaml and configs/rpf_3d/segnn.yaml, resolved;
# tests/test_torch_segnn_runner.py holds it equal to the YAML over the
# defaults
SEGNN_CONFIG = {
    "dataset": {"src": "datasets/3D_RPF_8000_10kevery100"},
    "logging": {"wandb_project": "rpf_3d"},
    "model": {"name": "segnn", "num_mp_steps": 10, "latent_dim": 64, "isotropic_norm": True},
    "train": {"optimizer": {"lr_start": 1.0e-3}},
}
SEGNN_STEP_MAX, SEGNN_ROLLOUT = 9, 20  # training steps 0-9, then a 20-step infer
# A small SEGNN on the card against the CPU, float32 (TF32 off): the same
# function summed in other orders. Positions after a 3-step rollout 1e-5
# absolute; 3 training steps, losses 1e-5 relative, parameters 1e-5
# absolute (as EGNN is held). bf16 compute, one forward and backward: the
# card's bf16 GEMM sums its float32 products in another order than the
# CPU's, and a sum that lands on the other side of a bf16 rounding
# boundary of the next product's input moves it by an ulp (2^-8): acc and
# every gradient within 2e-2 of their largest value.
SEGNN_REF_TOL = {"pos": 1e-5, "loss": 1e-5, "params": 1e-5, "bf16": 2e-2}
# the profiles' kernel groups of the tensor products' torch ops, by name
SEGNN_GROUPS = {"catarray": "torch.cat copies", "reduce_kernel": "reductions (sums over K, means)",
                "mulfunctor": "elementwise multiply", "functor_add": "elementwise add",
                "sigmoid": "sigmoid (gates, SiLU)", "direct_copy": "copies and casts"}


def segnn_cfg(**overrides):
    return shipped_cfg(SEGNN_CONFIG, **overrides)


def segnn_path(device):
    """SEGNN-10-64 (configs/rpf_3d/segnn.yaml) through runner.train_or_infer
    with mode=all: 10 training steps at batch 1, then a 20-step infer at
    batch 2 (mse, e_kin, Sinkhorn); K1 and K2 once per neighbor update and
    no other kernel; finite losses, changed parameters, ms per train and
    rollout step, the peak memory of a train step, profiles of a rollout
    step and a train step."""
    import numpy as np
    import torch

    from lagrangebench_torch.models import setup_model
    from lagrangebench_torch.ops import fused_mp, painn_msg, row_gather
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    # every kernel wrapper of the port (K1-K9, E1, E2)
    kernels = (nlc.COLUMN_TABLE, nlc.NEIGHBOR_SCAN, nlc.NEIGHBOR_SCAN_GEOMETRY, nlc.SLOT_SCAN,
               fused_mp.FUSED_MP, fused_mp.FUSED_MP_ENC, fused_mp.FUSED_MP_BWD,
               fused_mp.FUSED_MP_SLOT, fused_mp.FUSED_MP_SLOT_ENC, fused_mp.FUSED_MP_WINDOW,
               painn_msg.PAINN_MSG, painn_msg.PAINN_LAYER, row_gather.ROW_GATHER)
    ok, step_ms = True, {}
    with tempfile.TemporaryDirectory() as tmp:
        common = {"eval.n_rollout_steps": SEGNN_ROLLOUT, "eval.infer.n_trajs": BATCH,
                  "eval.train.n_trajs": 1, "eval.rollout_dir": f"{tmp}/rollouts",
                  "logging.ckp_dir": f"{tmp}/ckp", "logging.eval_steps": SEGNN_STEP_MAX}
        if str(device) == "cpu":  # a rehearsal on the CPU; the card is the runner's default
            common["gpu"] = -1
        cfg = segnn_cfg(mode="all", **{"train.step_max": SEGNN_STEP_MAX}, **common)
        data = runner_data(cfg)
        metrics, counts, rec, ok = _runner_call("segnn (mode=all)", cfg, data, kernels)
        model, case, trainer = rec.models[0], rec.cases[0], rec.trainers[0]
        fresh = setup_model(cfg.model, data[0].metadata, seed=cfg.seed, device=device)
        changed = sum(not torch.equal(a, b)
                      for a, b in zip(fresh.parameters(), model.parameters()))
        n_params = len(list(model.parameters()))
        log(f"segnn: hidden irreps {model.hidden_irreps}, "
            f"{sum(p.numel() for p in model.parameters())} parameters; losses "
            f"{[round(x, 6) for x in rec.losses]}; {changed} of {n_params} parameter tensors "
            f"changed")
        if (len(rec.losses) != SEGNN_STEP_MAX + 1 or not np.all(np.isfinite(rec.losses))
                or changed != n_params):
            log("FAIL: segnn training steps (count, finite losses, changed parameters)")
            ok = False
        d = np.asarray(trainer.timer.durations) * 1e3
        step_ms["segnn train"] = float(np.median(d))
        log(f"segnn train: ms per step (host clock, synchronized) median {np.median(d):.2f} "
            f"(all {np.round(d, 2).tolist()}) [batch {cfg.train.batch_size} x {N_PARTICLES} "
            f"particles, SEGNN-10-64 float32]")

        # the peak memory of one training step at batch 1, then its profile
        pos_t, ptype_t = next(iter(trainer.loader_train))
        raw = trainer._batch((pos_t, ptype_t))
        _, _, tnbrs = trainer.case.allocate(trainer.generator, (pos_t[0], ptype_t[0]))
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            trainer.train_step(raw, tnbrs.broadcast(1), 3e-4, 0)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            log(f"segnn train step peak memory: {peak / 2**30:.2f} GiB allocated "
                f"(torch.cuda.max_memory_allocated; {before / 2**30:.2f} GiB before the step) "
                f"[batch 1 x {N_PARTICLES} particles]")
        profile_train_step(trainer, raw, tnbrs, batch=1, unroll=0, label="segnn train",
                           extra=SEGNN_GROUPS)

        model.eval()
        isl = int(cfg.model.input_seq_length)
        times, finite, (pos, ptype, nbrs) = _rollout_ms(model, case, data[2], isl,
                                                        SEGNN_ROLLOUT, "segnn, SEGNN-10-64 float32")
        ok &= finite
        step_ms["segnn rollout"] = min(times)
        profile_steps(model, case, pos, ptype, nbrs, steps=1, isl=isl, label="segnn rollout",
                      rename=SEGNN_GROUPS)
    return ok, step_ms


def segnn_ref_data(cfg, dim, walls, n_particles=1000):
    """Synthetic (train, valid, test) splits for the card-vs-CPU checks:
    periodic, or in a box with walls (each coordinate mapped smoothly into
    [0.1, 0.9], so that no trajectory wraps) where a quarter of the
    particles are walls."""
    import numpy as np

    from lagrangebench_torch.data import ArrayDataset
    from lagrangebench_torch.data.synthetic import _stats, make_synthetic_arrays

    isl = int(cfg.model.input_seq_length)
    side = round(n_particles ** (1 / dim))
    splits, metadata = make_synthetic_arrays(
        n_particles=side**dim, dim=dim, box=BOX, dx=BOX / side, seq_len_train=12,
        seq_len_eval=isl + 3, n_trajs=BATCH, name="REF")
    types = np.zeros(side**dim, np.int64)
    if walls:
        splits = {k: [0.5 + 0.4 * np.sin(2 * np.pi * p / BOX) for p in v]
                  for k, v in splits.items()}
        metadata.update(_stats(splits["train"], BOX, dim))
        metadata["periodic_boundary_conditions"] = [False] * dim
        types[: side**dim // 4] = 1  # NodeType.SOLID_WALL
    extra = {"train": max(cfg.train.pushforward.unrolls), "valid": 3, "test": 3}
    return tuple(ArrayDataset(split, splits[split], [types] * BATCH, metadata,
                              input_seq_length=isl, extra_seq_length=extra[split])
                 for split in ("train", "valid", "test"))


def segnn_reference_check(device):
    """Small SEGNNs on the card against the CPU (TF32 off): 2 layers, latent
    64, about 1,000 particles, 3D periodic and 2D with walls, two particle
    types and lmax 2; a 3-step rollout and 3 training steps each in
    float32, and one bf16 forward and backward of the 3D model."""
    import numpy as np
    import torch

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.models import setup_model
    from lagrangebench_torch.train import Trainer

    tol, passed = SEGNN_REF_TOL, True
    variants = {"3d": ({}, 3, False),
                "2d_walls_lmax2": ({"model.lmax_attributes": 2, "model.lmax_hidden": 2}, 2, True)}
    for label, (over, dim, walls) in variants.items():
        cfg = segnn_cfg(**{"model.num_mp_steps": 2, "eval.n_rollout_steps": 3,
                           "eval.train.n_trajs": 1, "train.batch_size": 2, **over})
        train, valid, test = segnn_ref_data(cfg, dim, walls)
        meta = test.metadata
        isl = int(cfg.model.input_seq_length)
        preds, losses, params, feats_out = [], [], [], []
        for dev in (device, "cpu"):
            bounds = np.asarray(meta["bounds"])
            case = case_builder((bounds[:, 1] - bounds[:, 0]).tolist(), meta, isl,
                                cfg_neighbors=cfg.neighbors, cfg_model=cfg.model,
                                noise_std=cfg.train.noise_std, device=dev)
            model = setup_model(cfg.model, meta, device=dev, homogeneous_particles=not walls)
            pos, ptype = test_batch(test, dev, BATCH)
            _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
            p, _, _ = rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs.broadcast(BATCH),
                                    pos[:, :, isl:isl + 3])
            preds.append(p.cpu())
            tr = Trainer(model, case, train, valid, cfg_train=cfg.train, cfg_eval=cfg.eval,
                         cfg_logging={"log_steps": 1, "eval_steps": 10**9},
                         input_seq_length=isl, device=dev)
            steps, _ = record_steps(tr)
            tr.train(step_max=2)
            losses.append(np.asarray([loss for _, loss in steps]))
            params.append(checkpoint.flatten_tree(model.jax_params()))
        pos_err = float((preds[0] - preds[1]).abs().max())
        loss_err = float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1])))
        par_err, worst = max((float(np.max(np.abs(params[0][k] - params[1][k]))), k)
                             for k in params[1])
        ok = (pos_err <= tol["pos"] and len(losses[0]) == 3 and loss_err <= tol["loss"]
              and par_err <= tol["params"])
        log(f"segnn reference ({label}), cuda vs cpu float32: positions after 3 steps "
            f"{pos_err:.3g} (tol {tol['pos']}); 3 training steps, losses {losses[0].tolist()} vs "
            f"{losses[1].tolist()}, max rel diff {loss_err:.3g} (tol {tol['loss']}); parameters "
            f"max abs diff {par_err:.3g} at {worst} (tol {tol['params']})"
            f"{'' if ok else '  FAIL'}")
        passed &= ok

    # bf16 compute: one forward and backward from the same weights
    cfg = segnn_cfg(**{"model.num_mp_steps": 2, "model.compute_dtype": "bfloat16"})
    _, _, test = segnn_ref_data(cfg, 3, False)
    outs, weights = [], None
    for dev in (device, "cpu"):
        case = gns_case(cfg, test.metadata, dev)
        model = setup_model(cfg.model, test.metadata, device=dev)
        if weights is None:
            weights = model.jax_params()
        model.load_jax_params(weights)
        feats, ptype = first_window(case, test)
        acc = model(feats, ptype)["acc"]
        acc.square().mean().backward()
        outs.append([acc.detach().cpu()] + [p.grad.cpu() for _, p, _ in model.jax_leaves()])
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(*outs)]
    ok = max(errs) <= tol["bf16"]
    log(f"segnn reference, cuda vs cpu bf16 compute: acc {errs[0]:.3g} of the largest, "
        f"parameter gradients up to {max(errs[1:]):.3g} (tol {tol['bf16']})"
        f"{'' if ok else '  FAIL'}")
    return passed and ok


# ---------------------------------------------------------------------------
# slice 10: the sparse (2, E) layout and the cell-list and all-pairs searches
# (the JAX package computes them in plain XLA: no kernel on these paths)
# ---------------------------------------------------------------------------

# configs/WaterDrop_2d/gns.yaml, resolved; tests/test_torch_sparse_runner.py
# holds it equal to the YAML over the defaults
WATERDROP_CONFIG = {
    "dataset": {"src": "/tmp/datasets/WaterDrop"},
    "logging": {"wandb_project": "waterdrop_2d"},
    "model": {"name": "gns", "num_mp_steps": 10, "latent_dim": 128},
    "train": {"optimizer": {"lr_start": 5.0e-4}},
    "neighbors": {"backend": "celllist"},
}
# the slice's path: configs/rpf_3d/gns.yaml with the standard processor on
# sparse edges (backend auto, which resolves to the cell list), batch 2
SPARSE_GNS = {"model.fused_processor": False, "neighbors.format": "sparse",
              "train.batch_size": BATCH}
SPARSE_STEP_MAX, SPARSE_ROLLOUT, SPARSE_INFER = 9, 20, 5
# The same weights in float32 (TF32 off) on the sparse and the dense layout,
# or on the cell list and K1 + K2: one forward, max |acc diff| <= 1e-4 x max
# |acc| (one graph, sums in other orders), as the other layouts are held.
SPARSE_RTOL = 1e-4


def all_kernels():
    """Every kernel wrapper of the port (K1-K9, E1, E2)."""
    from lagrangebench_torch.ops import fused_mp, painn_msg, row_gather
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    return (nlc.COLUMN_TABLE, nlc.NEIGHBOR_SCAN, nlc.NEIGHBOR_SCAN_GEOMETRY, nlc.SLOT_SCAN,
            fused_mp.FUSED_MP, fused_mp.FUSED_MP_ENC, fused_mp.FUSED_MP_BWD,
            fused_mp._BWD_REDUCE, fused_mp.FUSED_MP_SLOT, fused_mp.FUSED_MP_SLOT_ENC,
            fused_mp.FUSED_MP_WINDOW, painn_msg.PAINN_MSG, painn_msg.PAINN_LAYER,
            row_gather.ROW_GATHER)


class _Backends:
    """Records the (format, backend) of every NeighborList made while
    active."""

    def __enter__(self):
        from lagrangebench_torch.ops.neighbors import NeighborList

        self.cls, self.init, self.seen = NeighborList, NeighborList.__init__, set()
        init, seen = self.init, self.seen

        def recording(nl, *a, **k):
            init(nl, *a, **k)
            seen.add((nl.format, nl.backend))

        NeighborList.__init__ = recording
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.init


def _backend_gate(label, seen, want):
    if seen != want:
        log(f"FAIL: {label} neighbor lists {sorted(seen)}, expected {sorted(want)}")
        return False
    log(f"{label}: every neighbor list {sorted(seen)}")
    return True


def _rows_sorted(idx, n, width):
    """(B, N, K) sender rows padded with n to ``width`` and sorted."""
    import torch

    pad = idx.new_full(idx.shape[:-1] + (width - idx.shape[-1],), n)
    return torch.sort(torch.cat([idx, pad], dim=-1), dim=-1).values


def _brute_force(pos, box, cutoff, n_valid):
    """Every (receiver, sender) pair within the cutoff under the minimum
    image, in float64 numpy, with the searches' rounding (axis by axis)."""
    import numpy as np

    p = pos[:n_valid]
    d = np.mod(p[:, None, :] - p[None, :, :] + box * 0.5, box) - box * 0.5
    d2 = d[..., 0] * d[..., 0]
    for k in range(1, d.shape[-1]):
        d2 = d2 + d[..., k] * d[..., k]
    r, s = np.nonzero(d2 <= cutoff * cutoff)
    return set(zip(r.tolist(), s.tolist()))


def search_checks(device):
    """(a) The searches at 8,000 particles in 3D, batch 2: the cell list on
    the card equals the CPU's; its rows equal K1 + K2's as sets; the sparse
    cell list holds the dense list's pairs; all-pairs (dense, sparse) equals
    a brute-force search at 1,000 particles in a box under three cells; the
    flags rise at half the capacities; one update of each backend and
    format timed (device ms)."""
    import numpy as np
    import torch

    from lagrangebench_torch.ops import neighbors as nb
    from lagrangebench_torch.ops import space

    ok, times = True, {}
    cfg = gns_cfg()
    data = runner_data(cfg)
    cutoff = float(data[0].metadata["default_connectivity_radius"])
    isl = int(cfg.model.input_seq_length)
    pos_np = np.stack([data[2][i][0][:, isl - 1] for i in range(BATCH)]).astype(np.float32)
    n = pos_np.shape[1]
    npart_np = np.array([n, n - 100])  # sample 1 with 100 padded particles

    def lists(dev, backend, fmt, boost=1.5):
        disp = space.periodic(torch.full((DIM,), BOX, device=dev))[0]
        fns = nb.neighbor_list(disp, [BOX] * DIM, cutoff, backend=backend, format=fmt)
        shell = fns.allocate_shell(pos_np[0], num_particles=n, capacity_boost=boost, device=dev)
        x = torch.as_tensor(pos_np, device=dev)
        npart = torch.as_tensor(npart_np, device=dev)
        return shell, x, npart, shell.broadcast(BATCH).update(x, num_particles=npart)

    cell = {dev: lists(dev, "celllist", "dense")[3] for dev in (device, "cpu")}
    same = (torch.equal(cell[device].idx.cpu(), cell["cpu"].idx)
            and torch.equal(cell[device].did_buffer_overflow.cpu(),
                            cell["cpu"].did_buffer_overflow))
    log(f"cell list (dense, batch {BATCH} x {n}, K {cell['cpu'].capacity}): card == CPU "
        f"{same}; overflow {cell['cpu'].did_buffer_overflow.tolist()}")
    ok &= same and not bool(cell["cpu"].did_buffer_overflow.any())

    kern_shell, x, npart, kern = lists(device, "cuda", "dense")
    width = max(kern.capacity, cell[device].capacity)
    rows_equal = torch.equal(_rows_sorted(cell[device].idx, n, width),
                             _rows_sorted(kern.idx, n, width))
    log(f"cell list rows vs K1 + K2 rows (K {kern.capacity}), as sorted sets: equal "
        f"{rows_equal}; K1 + K2 overflow {kern.did_buffer_overflow.tolist()}")
    ok &= rows_equal and not bool(kern.did_buffer_overflow.any())

    sparse_shell, _, _, sparse = lists(device, "celllist", "sparse")
    pairs_equal = True
    for b in range(BATCH):
        r, s = sparse.idx[b].long()
        keep = r < n
        got = torch.sort(r[keep] * n + s[keep]).values
        dense_idx = cell[device].idx[b].long()
        rows = torch.arange(n, device=dense_idx.device)[:, None].expand_as(dense_idx)
        valid = dense_idx < n
        want = torch.sort(rows[valid] * n + dense_idx[valid]).values
        pairs_equal &= torch.equal(got, want)
    log(f"sparse cell list (E {sparse.capacity} per sample) == the dense list's pairs: "
        f"{pairs_equal}; overflow {sparse.did_buffer_overflow.tolist()}")
    ok &= pairs_equal and not bool(sparse.did_buffer_overflow.any())

    # all-pairs: 1,000 particles in a unit box, cutoff 0.4 (two cells per axis)
    rng = np.random.default_rng(0)
    small = rng.uniform(0, BOX, size=(1000, DIM))
    want = _brute_force(small, BOX, 0.4, 950)
    small_lists = {}
    for backend, fmt in (("cuda", "dense"), ("celllist", "sparse")):
        disp = space.periodic(torch.full((DIM,), BOX, dtype=torch.float64, device=device))[0]
        fns = nb.neighbor_list(disp, [BOX] * DIM, 0.4, backend=backend, format=fmt)
        shell = fns.allocate_shell(small, num_particles=950, device=device)
        xs = torch.as_tensor(small, device=device)
        got = shell.update(xs, num_particles=950)
        idx = got.idx.cpu().numpy()
        if fmt == "dense":
            r, k = np.nonzero(idx < 1000)
            pairs = set(zip(r.tolist(), idx[r, k].tolist()))
        else:
            keep = idx[0] < 1000
            pairs = set(zip(idx[0][keep].tolist(), idx[1][keep].tolist()))
        good = (got.backend == "allpairs" and pairs == want
                and not bool(got.did_buffer_overflow))
        log(f"all-pairs ({backend} -> {got.backend}, {fmt}, 1000 particles, 950 real, "
            f"cutoff 0.4): {len(pairs)} pairs, brute force {len(want)}: "
            f"{'equal' if good else 'FAIL'}")
        ok &= good
        small_lists[fmt] = (shell, xs)

    # the flags rise at half the capacities (K, E and the cells)
    for backend, fmt in (("celllist", "dense"), ("celllist", "sparse"), ("cuda", "dense")):
        flag = lists(device, backend, fmt, boost=0.5)[3].did_buffer_overflow
        log(f"overflow at half the capacity ({backend}, {fmt}): {flag.tolist()}")
        ok &= bool(flag.all())
    if not ok:
        log("FAIL: the neighbor searches (see above)")

    # device ms of one neighbor update at batch 2
    for label, (shell, xx, nn_) in {
            "K1 + K2 (cuda, dense)": (kern_shell, x, npart),
            "cell list, dense": (lists(device, "celllist", "dense")[0], x, npart),
            "cell list, sparse": (sparse_shell, x, npart)}.items():
        sb = shell.broadcast(BATCH)
        times[label] = cuda_time(lambda: sb.update(xx, num_particles=nn_))
    for fmt, (shell, xs) in small_lists.items():
        times[f"all-pairs, {fmt} (1 x 1000, float64)"] = cuda_time(
            lambda: shell.update(xs, num_particles=950))
    log(f"neighbor update, device ms (batch {BATCH} x {n} in 3D unless noted): " + json.dumps(
        {k: round(v, 4) for k, v in times.items()}))
    return ok, times


def sparse_aggregation_times(case, test):
    """The sparse sum of (E, 128) bf16 messages into their receivers at the
    path's shape: float32 accumulation (the port's ``segment_sum``) against a
    bf16 ``index_add_``, forward and forward + backward, device ms."""
    import torch

    from lagrangebench_torch.ops import scatter

    feats, _ = first_window(case, test)
    recv, n = feats["receivers"], feats["vel_hist"].shape[0]
    del feats
    gen = torch.Generator(device=recv.device).manual_seed(0)
    msg = torch.randn((recv.shape[0], LATENT), generator=gen, device=recv.device).to(
        torch.bfloat16).requires_grad_()
    ids = torch.where(recv < n, recv, n).long()
    grad = torch.ones((n, LATENT), dtype=torch.bfloat16, device=recv.device)

    def f32():
        return scatter.segment_sum(msg, recv, n)

    def bf16():
        return msg.new_zeros((n + 1, LATENT)).index_add(0, ids, msg)[:n]

    out = {}
    for label, fn in (("float32 accumulation", f32), ("bf16 index_add", bf16)):
        with torch.no_grad():
            out[f"{label}, forward"] = cuda_time(fn)
        out[f"{label}, forward + backward"] = cuda_time(lambda: fn().backward(grad))
    with torch.no_grad():
        a, b = f32().float(), bf16().float()
    err = float((a - b).abs().max() / a.abs().max())
    log(f"sparse aggregation of ({recv.shape[0]}, {LATENT}) bf16 messages into {n} receivers, "
        "device ms: " + json.dumps({k: round(v, 4) for k, v in out.items()})
        + f"; bf16 index_add vs float32 accumulation: {err:.3g} of the largest")
    return out


def sparse_gns_path(device):
    """(b) The slice's path: GNS-10-128 (configs/rpf_3d/gns.yaml, bf16) with
    the standard processor on sparse edges through runner.train_or_infer,
    mode=all: 10 training steps at batch 2, a 20-step infer; no kernel
    launches and every list on the cell list; finite losses and changed
    parameters; ms per train and rollout step and their profiles; the
    sparse aggregation timed; float32 sparse vs dense, one forward."""
    import numpy as np
    import torch

    from lagrangebench_torch.models import setup_model

    ok, step_ms = True, {}
    with tempfile.TemporaryDirectory() as tmp:
        common = {"eval.n_rollout_steps": SPARSE_ROLLOUT, "eval.infer.n_trajs": BATCH,
                  "eval.train.n_trajs": 1, "eval.rollout_dir": f"{tmp}/rollouts",
                  "logging.ckp_dir": f"{tmp}/ckp", "logging.eval_steps": SPARSE_STEP_MAX}
        if str(device) == "cpu":
            common["gpu"] = -1
        cfg = gns_cfg(mode="all", **{"train.step_max": SPARSE_STEP_MAX}, **common, **SPARSE_GNS)
        data = runner_data(cfg)
        with _Backends() as seen:
            metrics, counts, rec, ok = _runner_call("sparse GNS (mode=all)", cfg, data,
                                                    all_kernels(), neighbor_kernels=False)
        ok &= _backend_gate("sparse GNS", seen.seen, {("sparse", "celllist")})
        model, case, trainer = rec.models[0], rec.cases[0], rec.trainers[0]
        fresh = setup_model(cfg.model, data[0].metadata, seed=cfg.seed, device=device)
        changed = sum(not torch.equal(a, b)
                      for a, b in zip(fresh.parameters(), model.parameters()))
        n_params = len(list(model.parameters()))
        log(f"sparse GNS: {type(model).__name__}, losses {[round(x, 6) for x in rec.losses]}; "
            f"{changed} of {n_params} parameter tensors changed")
        if (len(rec.losses) != SPARSE_STEP_MAX + 1 or not np.all(np.isfinite(rec.losses))
                or changed != n_params):
            log("FAIL: sparse GNS training steps (count, finite losses, changed parameters)")
            ok = False
        d = np.asarray(trainer.timer.durations) * 1e3
        step_ms["sparse gns train"] = float(np.median(d))
        log(f"sparse GNS train: ms per step (host clock, synchronized) median {np.median(d):.2f} "
            f"(all {np.round(d, 2).tolist()}) [batch {BATCH} x {N_PARTICLES} particles, "
            "GNS-10-128 standard, bf16]")
        pos_t, ptype_t = next(iter(trainer.loader_train))
        raw = trainer._batch((pos_t, ptype_t))
        _, _, tnbrs = trainer.case.allocate(trainer.generator, (pos_t[0], ptype_t[0]))
        log(f"sparse GNS: E {tnbrs.capacity} edge slots per sample")
        profile_train_step(trainer, raw, tnbrs, batch=BATCH, unroll=0, label="sparse GNS train")

        model.eval()
        isl = int(cfg.model.input_seq_length)
        times, finite, (pos, ptype, nbrs) = _rollout_ms(
            model, case, data[2], isl, SPARSE_ROLLOUT, "sparse GNS-10-128 bf16, standard")
        ok &= finite
        step_ms["sparse gns rollout"] = min(times)
        profile_steps(model, case, pos, ptype, nbrs, steps=1, isl=isl, label="sparse GNS rollout")
        sparse_aggregation_times(case, data[2])

        # float32: the same seeded weights on sparse and dense edges
        f32 = {**common, **SPARSE_GNS, "model.compute_dtype": "float32"}
        accs = {}
        for fmt in ("sparse", "dense"):
            c = gns_cfg(**{**f32, "neighbors.format": fmt})
            case_f, model_f = gns_case_model(c, data[0].metadata, device, seed=0)
            feats, ptype_f = first_window(case_f, data[2])
            with torch.no_grad():
                accs[fmt] = model_f(feats, ptype_f)["acc"]
            del feats, model_f
        err = float((accs["sparse"] - accs["dense"]).abs().max() / accs["dense"].abs().max())
        log(f"sparse vs dense GNS standard (float32, batch 2, one forward): max|acc diff| "
            f"{err:.3g} of the largest (tol {SPARSE_RTOL})")
        if not err <= SPARSE_RTOL:
            log("FAIL: sparse vs dense GNS")
            ok = False
    return ok, step_ms


def sparse_reference_check(device):
    """A small float32 GNS (standard processor, 2 layers, latent 128) on
    sparse edges, 1,000 particles, on the card against the CPU (TF32 off):
    a 3-step rollout (positions 1e-5 absolute) and 3 training steps
    (losses 1e-5 relative, parameters 1e-5 absolute; lr 1e-4 as the dense
    GNS check)."""
    import numpy as np

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.evaluate.rollout import rollout_batch
    from lagrangebench_torch.train import Trainer

    cfg = gns_cfg(**{**SPARSE_GNS, "model.num_mp_steps": 2, "model.compute_dtype": "float32",
                     "eval.n_rollout_steps": 3, "eval.train.n_trajs": 1,
                     "train.optimizer.lr_start": 1e-4})
    train, valid, test = runner_data(cfg, n_particles=1000)
    isl = int(cfg.model.input_seq_length)
    preds, losses, params = [], [], []
    for dev in (device, "cpu"):
        case, model = gns_case_model(cfg, test.metadata, dev, seed=0)
        pos, ptype = test_batch(test, dev, BATCH)
        _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
        p, _, _ = rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs.broadcast(BATCH),
                                pos[:, :, isl:isl + 3])
        preds.append(p.cpu())
        tr = Trainer(model, case, train, valid, cfg_train=cfg.train, cfg_eval=cfg.eval,
                     cfg_logging={"log_steps": 1, "eval_steps": 10**9},
                     input_seq_length=isl, device=dev)
        steps, _ = record_steps(tr)
        tr.train(step_max=2)
        losses.append(np.asarray([loss for _, loss in steps]))
        params.append(checkpoint.flatten_tree(model.jax_params()))
    pos_err = float((preds[0] - preds[1]).abs().max())
    loss_err = float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1])))
    par_err, worst = max((float(np.max(np.abs(params[0][k] - params[1][k]))), k)
                         for k in params[1])
    passed = pos_err <= 1e-5 and len(losses[0]) == 3 and loss_err <= 1e-5 and par_err <= 1e-5
    log(f"sparse GNS reference, cuda vs cpu float32: positions after 3 steps {pos_err:.3g} "
        f"(tol 1e-5); 3 training steps, losses {losses[0].tolist()} vs {losses[1].tolist()}, "
        f"max rel diff {loss_err:.3g} (tol 1e-5); parameters max abs diff {par_err:.3g} at "
        f"{worst} (tol 1e-5){'' if passed else '  FAIL'}")
    return passed


def waterdrop_data(cfg, n_particles=1024, n_padded=100):
    """2D synthetic splits in a box with walls (each coordinate mapped
    smoothly into [0.1, 0.9]), every sample padded at its end with
    ``n_padded`` particles of type -1, as WaterDrop pads its samples to
    ``num_particles_max``."""
    import numpy as np

    from lagrangebench_torch.data import ArrayDataset
    from lagrangebench_torch.data.synthetic import _stats, make_synthetic_arrays

    isl = int(cfg.model.input_seq_length)
    steps = max(int(cfg.eval.n_rollout_steps), 1)
    side = round(n_particles ** 0.5)
    splits, metadata = make_synthetic_arrays(
        n_particles=side**2, dim=2, box=BOX, dx=BOX / side, seq_len_train=12,
        seq_len_eval=isl + steps, n_trajs=BATCH, name="WaterDrop")
    splits = {k: [0.5 + 0.4 * np.sin(2 * np.pi * p / BOX) for p in v] for k, v in splits.items()}
    metadata.update(_stats(splits["train"], BOX, 2))
    metadata["periodic_boundary_conditions"] = [False, False]
    types = np.zeros(side**2, np.int64)
    types[-n_padded:] = -1
    extra = {"train": max(cfg.train.pushforward.unrolls), "valid": steps, "test": steps}
    return tuple(ArrayDataset(split, splits[split], [types] * BATCH, metadata,
                              input_seq_length=isl, extra_seq_length=extra[split])
                 for split in ("train", "valid", "test"))


def bounds_case(cfg, metadata, device):
    """The case of a config on a dataset's box (its metadata's bounds)."""
    import numpy as np

    from lagrangebench_torch.case import case_builder

    bounds = np.asarray(metadata["bounds"])
    return case_builder((bounds[:, 1] - bounds[:, 0]).tolist(), metadata,
                        cfg.model.input_seq_length, cfg_neighbors=cfg.neighbors,
                        cfg_model=cfg.model, noise_std=cfg.train.noise_std, device=device)


def _seeded_checkpoint(cfg, data, device, path):
    """Seeded weights of the config's model saved as a checkpoint."""
    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.models import setup_model

    case = bounds_case(cfg, data[0].metadata, device)
    _, ptype = data[0][0]
    model = setup_model(cfg.model, data[0].metadata, seed=0, device=device,
                        normalization_stats=case.normalization_stats,
                        homogeneous_particles=bool(ptype.max() == ptype.min()))
    checkpoint.save_checkpoint(path, model.jax_params(), {}, {"step": 0, "loss": None})


def _layout_forward_diff(cfgs, data, device, ckp):
    """max |acc_a - acc_b| / max |acc_b| of one forward from a checkpoint's
    weights under two configs (float32), on the test batch's first window;
    and each config's senders shape."""
    import torch

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.models import setup_model

    params = checkpoint.load_checkpoint(ckp)[0]
    accs, shapes = [], []
    _, ptype0 = data[0][0]
    for c in cfgs:
        case = bounds_case(c, data[0].metadata, device)
        model = setup_model(c.model, data[0].metadata, device=device,
                            normalization_stats=case.normalization_stats,
                            homogeneous_particles=bool(ptype0.max() == ptype0.min()))
        model.load_jax_params(params)
        feats, ptype = first_window(case, data[2])
        shapes.append(tuple(feats["senders"].shape))
        with torch.no_grad():
            accs.append(model(feats, ptype)["acc"])
        del feats, model
    return float((accs[0] - accs[1]).abs().max() / accs[1].abs().max()), shapes


def waterdrop_path(device):
    """(c) configs/WaterDrop_2d/gns.yaml (standard GNS-10-128 float32, dense,
    backend celllist) through runner.train_or_infer, mode=infer for 5 steps
    at batch 2 from seeded weights, on 2D data with walls and padded
    particles: no kernel launches, every list on the cell list; held to
    the same weights on the auto backend (K1 + K2), one float32 forward."""
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        common = {"eval.n_rollout_steps": SPARSE_INFER, "eval.infer.n_trajs": BATCH,
                  "eval.rollout_dir": f"{tmp}/rollouts"}
        if str(device) == "cpu":
            common["gpu"] = -1
        cfg = shipped_cfg(WATERDROP_CONFIG, **common)
        data = waterdrop_data(cfg)
        ckp = f"{tmp}/ckp"
        _seeded_checkpoint(cfg, data, device, ckp)
        cfg_i = shipped_cfg(WATERDROP_CONFIG, mode="infer", load_ckp=ckp, **common)
        with _Backends() as seen:
            _, _, _, ok = _runner_call("WaterDrop GNS (celllist, dense, mode=infer)", cfg_i, data,
                                       all_kernels(), neighbor_kernels=False)
        ok &= _backend_gate("WaterDrop GNS", seen.seen, {("dense", "celllist")})
        auto = shipped_cfg(WATERDROP_CONFIG, **{**common, "neighbors.backend": "auto"})
        err, shapes = _layout_forward_diff((cfg, auto), data, device, ckp)
        log(f"WaterDrop GNS, cell list vs K1 + K2 (float32, batch 2 x {data[2][0][0].shape[0]} "
            f"in 2D, senders {shapes}, one forward): max|acc diff| {err:.3g} of the largest "
            f"(tol {SPARSE_RTOL})")
        if not err <= SPARSE_RTOL:
            log("FAIL: WaterDrop cell list vs K1 + K2")
            ok = False
    return ok


def cell_list_consumers(device):
    """The dense consumers of a cell-list list, whose K is a multiple of 4
    (K1 + K2's of 8): the fused GNS (K3), PaiNN's standard layer (K6) and
    its fused layer (K5) on the cell list against the same weights on
    K1 + K2, float32, one forward each at 8,000 particles in 3D, batch 2."""
    ok = True
    for name, config, over in (("fused GNS (K3)", GNS_CONFIG, {}),
                               ("PaiNN standard (K6)", PAINN_CONFIG, {}),
                               ("PaiNN fused (K5)", PAINN_CONFIG,
                                {"model.fused_processor": True})):
        with tempfile.TemporaryDirectory() as tmp:
            over = {**over, "model.compute_dtype": "float32"}
            cfgs = [shipped_cfg(config, **{**over, "neighbors.backend": b})
                    for b in ("celllist", "auto")]
            data = runner_data(cfgs[0])
            _seeded_checkpoint(cfgs[0], data, device, f"{tmp}/ckp")
            err, shapes = _layout_forward_diff(cfgs, data, device, f"{tmp}/ckp")
        good = err <= SPARSE_RTOL
        log(f"{name}, cell list vs K1 + K2 (float32, senders {shapes}, one forward): "
            f"max|acc diff| {err:.3g} of the largest (tol {SPARSE_RTOL}){'' if good else '  FAIL'}")
        ok &= good
    return ok


def sparse_models_path(device):
    """(d) The shipped configs/rpf_3d/{painn,egnn,segnn}.yaml with
    neighbors.format=sparse through runner.train_or_infer, mode=infer for 5
    steps at batch 2 from seeded weights: no kernel launches, every list on
    the cell list; held to the dense layout on the same weights (float32,
    one forward); ms per rollout step beside the dense layout's."""
    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.models import setup_model

    ok, step_ms = True, {}
    for name, config in (("painn", PAINN_CONFIG), ("egnn", EGNN_CONFIG),
                         ("segnn", SEGNN_CONFIG)):
        with tempfile.TemporaryDirectory() as tmp:
            common = {"eval.n_rollout_steps": SPARSE_INFER, "eval.infer.n_trajs": BATCH,
                      "eval.rollout_dir": f"{tmp}/rollouts"}
            if str(device) == "cpu":
                common["gpu"] = -1
            cfgs = {fmt: shipped_cfg(config, **{**common, "neighbors.format": fmt})
                    for fmt in ("sparse", "dense")}
            data = runner_data(cfgs["sparse"])
            ckp = f"{tmp}/ckp"
            _seeded_checkpoint(cfgs["sparse"], data, device, ckp)
            cfg_i = shipped_cfg(config, mode="infer", load_ckp=ckp,
                                **{**common, "neighbors.format": "sparse"})
            with _Backends() as seen:
                _, _, _, run_ok = _runner_call(f"sparse {name} (mode=infer)", cfg_i, data,
                                               all_kernels(), neighbor_kernels=False)
            ok &= run_ok & _backend_gate(f"sparse {name}", seen.seen, {("sparse", "celllist")})
            err, shapes = _layout_forward_diff((cfgs["sparse"], cfgs["dense"]), data, device,
                                               ckp)
            log(f"sparse vs dense {name} (float32, batch 2, senders {shapes}, one forward): "
                f"max|acc diff| {err:.3g} of the largest (tol {SPARSE_RTOL})")
            if not err <= SPARSE_RTOL:
                log(f"FAIL: sparse vs dense {name}")
                ok = False
            params = checkpoint.load_checkpoint(ckp)[0]
            isl = int(cfgs["sparse"].model.input_seq_length)
            models, times = {}, {"sparse": [], "dense": []}
            for fmt, c in cfgs.items():
                case = bounds_case(c, data[0].metadata, device)
                model = setup_model(c.model, data[0].metadata, device=device,
                                    normalization_stats=case.normalization_stats)
                model.load_jax_params(params)
                models[fmt] = (model.eval(), case)
            for fmt in ("sparse", "dense", "dense", "sparse"):
                model, case = models[fmt]
                t, finite, _ = _rollout_ms(model, case, data[2], isl, SPARSE_INFER,
                                           f"{name}, {fmt}", runs=1)
                times[fmt] += t
                ok &= finite
            for fmt, t in times.items():
                step_ms[f"{name} {fmt} rollout"] = min(t)
            del models
    return ok, step_ms


def sparse_path(device):
    """Phase 10: (a) the searches, (b) the sparse GNS path and its card vs
    CPU check, (c) WaterDrop on the cell list and the dense kernels on a
    cell-list list, (d) the other models on sparse edges."""
    ok, search_ms = search_checks(device)
    gns_ok, gns_ms = sparse_gns_path(device)
    ok &= gns_ok
    ok &= sparse_reference_check(device)
    ok &= waterdrop_path(device)
    ok &= cell_list_consumers(device)
    models_ok, models_ms = sparse_models_path(device)
    ok &= models_ok
    return ok, {**gns_ms, **models_ms}, search_ms


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
    times = build.build(["binning", "neighbor_scan", "fused_mp", "fused_mp_bwd", "painn_msg",
                         "painn_layer", "row_gather"])
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall, per source {times}")
    ptxas_report(build, ("fused_mp", "fused_mp_bwd", "painn_layer", "neighbor_scan"))

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
    painn_rows, painn_ok, painn_ms = painn_path("cuda")
    ok &= painn_ok
    ok &= painn_reference_check("cuda")
    log(f"PaiNN inference path: {painn_ms['standard']:.3f} ms per rollout step (standard, K6), "
        f"{painn_ms['fused']:.3f} (fused, K5)")
    rows.update(painn_rows)
    slot_rows, slot_ok, slot_ms = slot_path("cuda")
    ok &= slot_ok
    ok &= slot_reference_check("cuda")
    log("slot and geometry paths (ms per rollout step): " + json.dumps(
        {k: round(v, 3) for k, v in slot_ms.items()}))
    rows.update(slot_rows)
    egnn_ok, egnn_ms = egnn_path("cuda")
    ok &= egnn_ok
    ok &= egnn_reference_check("cuda")
    std_ok, std_ms = standard_gns_path("cuda")
    ok &= std_ok
    ok &= linear_path("cuda")
    log("EGNN and standard GNS paths (ms per step): " + json.dumps(
        {k: round(v, 3) for k, v in {**egnn_ms, **std_ms}.items()}))
    segnn_ok, segnn_ms = segnn_path("cuda")
    ok &= segnn_ok
    ok &= segnn_reference_check("cuda")
    log("SEGNN path (ms per step): " + json.dumps({k: round(v, 3) for k, v in segnn_ms.items()}))
    sparse_ok, sparse_ms, search_ms = sparse_path("cuda")
    ok &= sparse_ok
    log("sparse and cell-list paths (ms per step): " + json.dumps(
        {k: round(v, 3) for k, v in sparse_ms.items()}))
    exp_rows, exp_ok = experiments_path("cuda")
    ok &= exp_ok
    rows.update(exp_rows)
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
