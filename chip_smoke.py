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
10. Data parallelism (slice 11, "phase 11" in the output; no kernel). (a) Two ranks share cuda:0
   over gloo (``torch.multiprocessing``; NCCL refuses two ranks on one
   card): GNS-10-128 bf16 at batch 2 (one sample per rank) through
   ``Trainer.train`` with a ``parallel.Mesh``, on train_path's data, seed and
   12-step schedule, the counters zeroed around it in each rank: each rank's
   K1-K4 counts must equal the one-process run's, the losses must stay
   within ``DP_LOSS0_RTOL`` (step 0) and ``DP_LOSS_RTOL`` of its losses, and
   the two ranks must end with
   bit-identical parameters; rank 0 traces steps 4-6 with
   ``logging.profile_dir`` (the trace must hold K3, K4 and the all-reduce).
   A float32 run (3 steps, 1,000 particles, GNS-2-128) must match one
   process on the card within 1e-5; a 10-step float32 ``infer`` of 2
   trajectories at batch 2 (sharded) and of 3 at batch 3 (the fallback)
   from one checkpoint must match one process within 1e-5 relative. ms per
   train step of the ranks and of the one process are printed (not a
   scaling number: the ranks share the card). (b) ``python -m
   torch.distributed.run --standalone --nproc_per_node=1 chip_smoke.py
   --dp-launched <dir>`` drives ``runner.train_or_infer`` with the shipped
   ``configs/rpf_3d/gns.yaml``, ``parallel.data=-1``, ``mode=all``, 3 steps
   and a 5-step infer in an NCCL group of one: exit 0, one checkpoint
   directory, metrics; then ``parallel.data=2`` in this process, with no
   launcher, infers from that checkpoint on the one card as
   ``parallel.data=1`` does.
11. Spatial sharding (slice 12, "phase 12" in the output; no new kernel).
   Three ranks share cuda:0 over gloo (``torch.multiprocessing``), a slab
   ring of 3 (x-slabs 0.333 wide, 8,000 particles in 3D, cutoff 0.0725),
   and drive the port's entry points with the counters zeroed around each:
   GNS-10-128 bf16 (the shipped ``configs/rpf_3d/gns.yaml``)
   ``infer_spatial`` (10 steps, 2 trajectories, mse, e_kin, Sinkhorn) and
   ``train_spatial`` (8 steps at batch 1, one pushforward unroll from step
   4, validation and a checkpoint at the last step), PaiNN-5-128 float32
   (``configs/rpf_3d/painn.yaml``) ``infer_spatial`` (5 steps). Each rank
   must launch K3 (both instances) in GNS inference and training, K4 in
   training and K5 in PaiNN; only rank 0 writes, a standard-layout
   checkpoint. On rank 0's slab, K3 and K4 (inputs captured from one bf16
   train step) and K5 (its first layer, 3 N_loc source rows: the slab and
   both halo slabs) must match their plain versions under phase 2's, 3's
   and 4's limits. float32 on the same weights: the three-rank forward,
   train step (loss and gradients) and 10-step infer metrics must match the
   unsharded port within 1e-5 of the largest value (metrics: relative).
   Prints ms per rollout and train step of the ranks and of the same runs
   in one process (a ring of one), and the halo exchange's host ms per
   step with its host staging from rank 0's trace (not a scaling number:
   the ranks share one card).
12. Spatial SEGNN and EGNN (slice 13, "phase 13" in the output; no new
   kernel). Phase 12's set-up (three gloo ranks sharing cuda:0, a slab
   ring of 3, 8,000 particles in 3D) drives, at full width and float32 as
   shipped, SEGNN-10-64 (``configs/rpf_3d/segnn.yaml``) and EGNN-5-128
   (``configs/rpf_3d/egnn.yaml``, trained at lr 5e-6: ``STEER_EGNN_LR``):
   ``infer_spatial`` (5 steps, 2 trajectories, mse, e_kin, Sinkhorn) and
   ``train_spatial`` (3 steps at batch 1, validation at the last step;
   rank 0 alone writes the checkpoint, the module's tree), the counters
   zeroed around each run:
   no kernel may launch (the slab search and these models are PyTorch ops,
   as JAX runs them on XLA). On the same weights against the unsharded
   port in one process: the forward and one train step's loss within 1e-5
   of the largest value, the gradients within 1e-4, the 5-step metrics
   within 1e-5 relative (EGNN's first step only: the seeded EGNN's rollout
   blows up on this data, ``STEER_CHAOTIC``). Prints ms per rollout and
   train step of the ranks
   and of one process (a ring of one), the chunk reruns and the halo's
   host ms per step with its staging from rank 0's trace.
13. The reference's Haiku checkpoints (slice 13, "phase 14" in the output).
   Seeded weights exported with ``compat.save_reference_checkpoint`` and
   inferred by ``runner.train_or_infer`` with ``mode=infer load_ckp=<Haiku
   dir>``, the counters zeroed around each run: GNS-10-128 bf16 fused
   (``configs/rpf_3d/gns.yaml``, 20 steps; K1 and K2 once per neighbor
   update, K3 9 + 1 per forward), PaiNN-5-128 (5 steps) standard (K6) and
   fused (K5), EGNN-5-128 and Linear (5 steps). The metrics must equal
   those of infer from the port's own checkpoint of the same weights: bit
   for bit for GNS and PaiNN, within 1e-5 relative for EGNN (run with
   torch's deterministic index_add: its rollout blows up, and the atomics'
   order alone moves its 5-step metrics) and Linear. Nothing on this path
   imports Haiku.
14. Data generation (slice 14, "phase 15" in the output; no new kernel).
   (a) The WCSPH solver (``data_gen.wcsph``) at the reference scales: TGV
   2D (2,500 particles), TGV 3D (8,000, a Verlet skin of 0.25 h, capacity
   multiplier 1.5), DAM (dx 0.025), RPF 2D (3,200, with the band force) and
   LDC (dx 1/46), 10 substeps (``gate_substeps``; a quarter of a frame, a
   fifth of the DAM's: the CPU references took 92-120 s at a whole frame)
   in float32 on the card with K1 + K2 against the CPU (their plain
   versions) and against the cell
   list on the card, within ``DATAGEN_TOL``; the allocations' neighbor rows
   as sets (a pair only one search keeps must sit on the cutoff); K1 and K2
   exactly 1 + ceil(steps / nl_every) launches per allocation and advance,
   no other kernel; walls unmoved; ms per substep. (b) The JAX tests'
   physical checks on the card at their sizes (TGV decay and momentum,
   the hydrostatic tank, the RPF bands, the LDC lid, walls). (c) A TGV 2D
   ensemble (6 trajectories x 30 frames x 40 substeps, split 4/1/1) and an
   RPF 2D trajectory (600 warmup substeps, 120 frames x 60, time-split
   80/10/10) generated on the card (``simulate_frames``, K1 and K2 counted),
   split by the converter's ``split_trajectories`` into metadata with
   statistics and into ``ArrayDataset``s; the RPF force is ``RPF_FORCE_PY``
   written to a temporary directory and loaded by the dataset loader (the
   port's ``jax.numpy`` namespace). (d) GNS-10-128 bf16 fused, batch 2,
   through ``runner.train_or_infer(mode=all)`` with
   ``configs/tgv_2d_gen/gns.yaml`` and ``configs/rpf_2d_gen/gns.yaml``
   (``TGV_GEN_CONFIG``, ``RPF_GEN_CONFIG``): 5 training steps, validation,
   and infer (20 and 6 rollout steps); K1 and K2 once per neighbor update,
   K3 9 + 1 per forward, K4 and its reduction 10 per training step; finite
   losses and metrics; the RPF model built with the force feature. No h5py
   is used; the frames stay in memory. Prints frames/s of generation and
   the phase's wall time beside the card.
15. GNS-5-64 (slice 15, "phase 16" in the output): the fused GNS kernels
   at latent width 64. K3 (plain and encoder step) and K4 on inputs
   captured from one GNS-5-64 forward and one training backward (8,000
   particles in 3D, batch 2), K8 (plain and encoder) on one slot forward
   at batch 1 and E2 on the probe's structure, all at F = 64, against their
   plain versions under phases 2's, 3's, 5's and 6's limits (bf16, and
   float32 with TF32 off; K4's weight gradients bit-identical over two
   launches), timed beside their bounds. Then ``configs/rpf_3d/gns.yaml``
   with ``model.num_mp_steps=5 model.latent_dim=64`` (``GNS64``) through
   ``runner.train_or_infer``: ``mode=all``, 12 training steps at batch 2
   with one pushforward unroll from step 4 and a 20-step infer (mse,
   e_kin, Sinkhorn), K1 and K2 once per neighbor update, K3 4 + 1 per
   forward, K4 and its reduction 5 per training step, every other kernel
   none; finite losses and metrics; ms per train and rollout step and a
   rollout profile; ``mode=infer`` in the slot layout at batch 1 from its
   checkpoint (K8 4 + 1 per forward); ``window_select.main --latent 64``
   (E2's launches); a 3-step float32 GNS-5-64 training run on the card
   held against the CPU (1e-5).
16. Every latent width (slice 16, "phase 17" in the output): K3 (plain
   and encoder step), K4 and K8 (plain and encoder step) at F = 32, 96,
   100, 192 and 256 on inputs captured from a GNS-3-F training step and
   slot forward (8,000 particles in 3D, the slot forward at batch 1), and
   E2 on the probe's structure, through the wrappers at the true width
   (zero-padding to the instance 64 ceil(F / 64) and slicing back where F
   is not one), against their plain versions under phases 2's, 3's, 5's
   and 6's limits (K4's weight gradients bit-identical over two launches);
   K6 at H = 32, 64, 100, 256 and K5 at those H x R = 8, 20, 32, in 2D and
   3D, on inputs of one-layer PaiNNs at those widths, under phase 3's
   limits. Then through ``runner.train_or_infer``: GNS-10-256
   (``configs/rpf_3d/gns.yaml`` + ``model.latent_dim=256``, bf16, fused,
   dense) ``mode=all``, 10 training steps at batch 2 with one pushforward
   unroll from step 4 and a 20-step infer, then ``mode=infer`` in the slot
   layout at batch 1 from its checkpoint; GNS-10-96 ``mode=all``;
   PaiNN-5-64 (``configs/rpf_3d/painn.yaml`` + ``model.latent_dim=64``)
   standard ``mode=all`` and fused ``mode=infer`` from its checkpoint, K5
   and K6 timed on its own inputs; ``window_select.main --latent 96`` and
   ``256``; K1 and K2 once per neighbor update, K3 9 + 1 per forward, K4
   and its reduction 10 per training step, K6 and K5 5 per forward; finite
   losses and metrics, ms per train and rollout step; float32 card-vs-CPU
   checks: phase 7's 3-step rollout at GNS-2-96 and GNS-2-256, 3 training
   steps of GNS-2-96, one forward of PaiNN-2-64 in both layouts. Prints
   its wall time beside the card.
17. Past F = 256 and H = 256 (slice 18, "phase 18" in the output): K3
   (plain and encoder step), K4 and K8 (plain and encoder step) at F = 257,
   320, 384, 512, 768 and 1,024 on the wide path (``csrc/mp_wide.cuh``; in
   bf16 up to 512 the wgmma design's edge kernel, ``csrc/mp_wgmma.cuh``), on
   inputs captured from a GNS-3-F training step and slot forward (8,000
   particles in 3D; 4,000 from F = 768 on, where K4's float64 references
   would not fit), and E2 on the probe's structure, in bf16 and float32,
   against their plain versions under phases 2's, 3's, 5's and 6's limits
   (K4's weight gradients bit-identical over two launches); K5's
   tensor-core design (``painn_edge_tc``, ``painn_node_tc``: mma.sync,
   3xTF32 in float32) at H = 320, 512, 1,024 x R = 20, 96, 128 in 2D and 3D
   under phase 3's limits, K5's bound read on the CUDA cores and with its
   products on the tensor cores (the smaller is its row's bound). Then
   through ``runner.train_or_infer``: GNS-10-512
   (``configs/rpf_3d/gns.yaml`` + ``model.latent_dim=512``, bf16, fused,
   dense) ``mode=all`` (10 training steps at batch 2, one pushforward unroll
   from step 4, a 20-step infer) and a slot ``mode=infer`` at batch 1 from
   its checkpoint (K8 at 512); PaiNN-5-512 standard ``mode=all`` and fused
   ``mode=infer`` (K5 at H = 512, R = 20), K5 and K6 timed on its inputs;
   ``window_select --latent 512``; K1 and K2 once per neighbor update, K3 9
   + 1 per forward, K4 and its reduction 10 per training step, K6 and K5 5
   per forward; finite losses and metrics, ms per train and rollout step,
   each run's wall time; float32 card-vs-CPU checks: 3-step rollouts of
   GNS-2-320 and GNS-2-512, 3 training steps of GNS-2-320, one forward of
   PaiNN-2-320 in both layouts. Prints the wide kernels' registers and
   spills (K5's with their shared memory) and the phase's wall time beside
   the card; the kernels line's K5 row at 512 names its CUDA kernels.
18. Prints one ``{"kernels": [...]}`` line (launch counts from the GNS
   training run for K1-K4, from the PaiNN runs for K6 and K5, from paths A
   and C for K7, K8 and K9, from the experiments for E1 and E2; the F = 64
   instances, named with ``@64``, from phase 16; the F = 96 and 256 ones
   and the H = 64 ones, named ``@96``, ``@256`` and ``@64``, from phase
   17; the F = 512 and H = 512 ones, named ``@512``, from phase 18), the
   card line, and last ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, without a CUDA device or outside the
repository. Needs one card and no network. ``--dp-launched <dir>`` is the
worker of item 10 (b), started by the script itself.
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
PEAK_TF32 = 495e12  # tensor-core TF32 FLOP/s

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
# K4's bf16 weight gradients at the widths where a reading showed agg's
# bf16 rounding ties moving them past their limit, in the plain version's
# own float32 sums too (phase 17; ``bf16_tie_check``); and at the wide
# path's gate widths (phase 18): there the raw gate read 7.4e-5 to 8.1e-4
# on the model's inputs (H100), and ``experiments/k4_ties.py --bf16`` on the
# GPU tests' seeded cases at N = 2,999 showed T(agg) elements rounded
# apart between the kernel and the float64 sum flipping relu(node_first):
# at K = 13, F = 257 843 of 0.77 M (7 flips), 384 2,101 of 1.15 M (10), 512
# 4,853 of 1.54 M (16), 768 11,942 of 2.30 M (59), 1,024 25,778 of 3.07 M
# (123); at K = 40, F = 320 1,632 of 0.96 M (8) (320 and 512 from an
# earlier build of the same agg sums)
BF16_TIE_WIDTHS = (192, 256, 257, 320, 384, 448, 512, 768, 1024, 1088)
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


def ptxas_report(build, names=("fused_mp", "fused_mp_bwd"), only=None):
    """Each kernel's registers, spills and stack from nvcc's -Xptxas -v
    report (the ``.log`` beside each built library), one line per kernel,
    named by its mangled identifier and template arguments; the fused GNS
    kernels' lines also name their latent width F (their first integer
    template argument), one line per instance, and the wide path's row
    kernels their values per lane. ``only``: the kernel names to report
    (all by default)."""
    import re

    import torch

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
                if only is not None and ident not in only:
                    continue
                targs = re.match(r"I\w*?EE", mangled[m.end() + len(ident):])
                width = re.search(r"Li(\d+)E", targs.group(0)) if targs else None
                if width and "wide" in ident:  # the wide path's row kernels: values per lane
                    width = f" [{width.group(1)} values per lane]"
                elif width and ident in ("fused_mp_edge_wgmma", "fused_mp_bwd_edge_wgmma"):
                    # registers at launch; its warpgroups' own by setmaxnreg
                    from lagrangebench_torch.ops import fused_mp

                    f, bwd = int(width.group(1)), ident == "fused_mp_bwd_edge_wgmma"
                    smem = (fused_mp.wgmma_bwd_smem_bytes if bwd else fused_mp.wgmma_smem_bytes)(f)
                    stages = (fused_mp.wgmma_bwd_stages if bwd else fused_mp.wgmma_stages)(f)
                    width = (f" [F = {f}; setmaxnreg: consumer warpgroups 232 registers, "
                             f"producer 40; dynamic shared memory {smem} B of "
                             f"{fused_mp.SMEM_LIMIT}, {stages} weight stages]")
                elif ident == "fused_mp_bwd_tn_wgmma":
                    from lagrangebench_torch.ops import fused_mp

                    width = (f" [setmaxnreg: consumer warpgroups 232 registers, producer 40; "
                             f"dynamic shared memory {fused_mp.wgmma_tn_smem_bytes()} B]")
                elif ident in K5_TC_IDENTS:  # its launch at PaiNN-5-512's shape
                    import ctypes

                    from lagrangebench_torch.ops import painn_msg

                    ints = re.findall(r"Li(\d+)E", targs.group(0))
                    dt = getattr(torch, "bfloat16" if "bfloat16" in targs.group(0) else "float32")
                    shape = (ctypes.c_int * 12)()
                    build.load("painn_layer").lbt_painn_tc_shape(
                        16000, *painn_msg.tc_widths(512, 20, dt), int(ints[0]),
                        int(dt == torch.bfloat16), shape)
                    i = 0 if ident == "painn_edge_tc" else 1 + int(ints[1])
                    width = (f" [{str(dt)[6:]}, dim {ints[0]}; at H = 512, R = 20, 16,000 "
                             f"receivers: grid ({shape[3 * i]}, {shape[3 * i + 1]}), dynamic "
                             f"shared memory {shape[3 * i + 2]} B]")
                else:
                    width = f" [F = {width.group(1)}]" if width and name.startswith("fused_mp") else ""
                log(f"ptxas {name}.cu {ident}{targs.group(0) if targs else ''}{width}: "
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


def build_case_model(metadata, device, dtype="bfloat16", mp_steps=MP_STEPS, seed=0,
                     latent=None):
    """A dense K1 + K2 case and a fused GNS-``mp_steps``-``latent`` (LATENT
    unless given) with seeded weights."""
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.config import Config
    from lagrangebench_torch.models import build_gns

    cfg_model = Config({
        "name": "gns", "fused_processor": True, "compute_dtype": dtype,
        "num_mp_steps": mp_steps, "latent_dim": latent or LATENT, "num_mlp_layers": 2,
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

    def rec_mp(e, hs, hr, h, mask, p, enc=None, latent=None):
        key = "fused_mp_enc" if enc is not None else "fused_mp"
        args = tuple(t.clone() for t in (e, hs, hr, h, mask.to(torch.float32)))
        seen.setdefault(key, (args + (p, enc), {} if latent == hs.shape[-1] else
                              {"latent": latent}))
        return fused_mp.gns_mp_step_plain(e, hs, hr, h, mask, p, enc, latent)

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


def true_width(name, hs_arg):
    """The fused step wrapper ``name`` of ``fused_mp`` on arguments at
    their true latent width, read off argument ``hs_arg`` unless given as
    ``latent`` (``fused_mp.at_true_width``: padded to the instance width,
    the outputs sliced back)."""
    from lagrangebench_torch.ops import fused_mp

    def call(*args, latent=None):
        latent = args[hs_arg].shape[-1] if latent is None else latent
        return fused_mp.at_true_width(name, *args, latent=latent)

    return call


def compare_kernels(seen, names=("neighbor_scan", "fused_mp", "fused_mp_enc")):
    """Phase 2: every kernel vs its plain version on the card; timings."""
    import torch

    from lagrangebench_torch.ops import fused_mp, neighbors_cuda

    funcs = {
        "neighbor_scan": (neighbors_cuda.neighbor_scan, neighbors_cuda.neighbor_scan_plain,
                          neighbors_cuda.NEIGHBOR_SCAN),
        "fused_mp": (true_width("gns_mp_step", 1), fused_mp.gns_mp_step_plain,
                     fused_mp.FUSED_MP),
        "fused_mp_enc": (true_width("gns_mp_step", 1), fused_mp.gns_mp_step_plain,
                         fused_mp.FUSED_MP_ENC),
    }
    rows, ok = {}, True
    for name in names:
        kern, plain, handle = funcs[name]
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
                f"float32 (TF32 off) {err32:.3g} (tol {K3_TOL['float32']})"
                f"{'' if passed else '  FAIL'}")
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
    profiled(lambda: rollout_batch(model, case, pos[:, :, :isl], ptype, nbrs,
                                   pos[:, :, isl:isl + steps]),
             steps, groups, label, "rollout step")


def profiled(run, steps, groups, label, unit):
    """Runs ``run`` (``steps`` units of work) under torch.profiler and logs
    its device time per ``unit`` by kernel group (a kernel joins the first
    group whose key its name contains), its device kernels per unit and the
    device's idle share of the window. A report, not a gate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:
        log(f"{label}: not measured (profiler failed: {e})")
        return
    per, kernels = {}, 0
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0)
        if dev <= 0 or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        kernels += ev.count
        name = ev.key.lower()
        group = next((g for k, g in groups.items() if k in name), "other (elementwise, copies)")
        per[group] = per.get(group, 0.0) + dev / 1e3 / steps
    busy = sum(per.values()) * steps * 1e3
    if busy <= 0:
        log(f"{label}: no device time in the trace (not measured)")
        return
    log(f"{label} (ms of device time per {unit}): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(per.items(), key=lambda kv: -kv[1])}))
    log(f"{label}: {kernels / steps:.1f} device kernels per {unit}; window "
        f"{wall_us / 1e3 / steps:.3f} ms per {unit} on the host clock, device busy "
        f"{busy / wall_us:.1%}, idle {1 - busy / wall_us:.1%}")


def reference_check(device, latent=None):
    """A small float32 rollout through the kernels agrees with the plain
    path on the CPU (TF32 off): 1,000 particles, GNS-2-128 (GNS-2-``latent``),
    3 steps."""
    import numpy as np
    import torch

    from lagrangebench_torch.evaluate.rollout import rollout_batch

    data, metadata = make_data(1000, ISL + 3)
    preds = []
    for dev in (device, "cpu"):
        case, model = build_case_model(metadata, dev, dtype="float32", mp_steps=2, latent=latent)
        batch = [data[i] for i in range(BATCH)]
        pos = torch.as_tensor(np.stack([b[0] for b in batch]), device=case.device)
        ptype = torch.as_tensor(np.stack([b[1] for b in batch]), device=case.device)
        _, nbrs = case.allocate_eval((pos[0, :, :ISL], ptype[0]))
        p, ovf, _ = rollout_batch(model, case, pos[:, :, :ISL], ptype, nbrs.broadcast(BATCH),
                                  pos[:, :, ISL:])
        preds.append(p.cpu())
    err = float((preds[0] - preds[1]).abs().max())
    log(f"reference (GNS-2-{latent or LATENT}): max |cuda - cpu| position after 3 steps "
        f"{err:.3g} (tol 1e-5)")
    return err <= 1e-5


def train_setup(device, n_particles=N_PARTICLES, dtype="bfloat16", mp_steps=MP_STEPS,
                seed=0, lr=5e-4, pushforward=None, mesh=None, logging=None, latent=None):
    """A Trainer on synthetic data: seeded weights, batch 2, noise 3e-4
    (data-parallel over ``mesh``; ``logging``: more logging keys; ``latent``:
    the GNS width, LATENT unless given)."""
    from lagrangebench_torch.train import Trainer

    train, metadata = make_data(n_particles, ISL + 3, split="train")
    valid, _ = make_data(n_particles, ISL + 3, split="valid")
    case, model = build_case_model(metadata, device, dtype=dtype, mp_steps=mp_steps, seed=seed,
                                   latent=latent)
    pushforward = pushforward or {"steps": [-1, UNROLL_FROM - 1], "unrolls": [0, 1],
                                  "probs": [0, 1]}
    trainer = Trainer(
        model, case, train, valid,
        cfg_train={"batch_size": BATCH, "noise_std": 3e-4, "optimizer": {"lr_start": lr},
                   "pushforward": pushforward},
        cfg_eval={"n_rollout_steps": 3, "train": {"n_trajs": 1}},
        cfg_logging={"log_steps": 1, "eval_steps": 10**9, **(logging or {})},
        input_seq_length=ISL, seed=seed, device=device, mesh=mesh,
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


def capture_bwd_inputs(trainer, mp_steps=None):
    """K4's inputs from one training backward (unroll 0) at the slice's
    shapes: the step before the last (a plain step whose e' feeds the next
    step) and the encoder step (the last backward call) of a model of
    ``mp_steps`` steps (MP_STEPS unless given)."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    calls = []
    real = fused_mp.gns_mp_step_bwd
    mp_steps = mp_steps or MP_STEPS

    def rec(*args, **kw):
        keep = len(calls) in (1, mp_steps - 1)
        calls.append(tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args)
                     if keep else None)
        return real(*args, **kw)

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


def bf16_exact(args, p, grads, aggc=None, relu_masks=None):
    """K4's plain version on bf16 inputs with its sums in float64: the same
    function, the same bf16 roundings of its intermediates, every sum
    (agg's over K above all) exact to float64 (the plain version's
    accumulation dtype swapped for the call); ``aggc`` and ``relu_masks``
    as the plain version takes them."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    real = fused_mp._acc_dtype
    fused_mp._acc_dtype = lambda cdt: torch.float64
    try:
        return fused_mp.gns_mp_step_bwd_plain(*args[:5], p, *grads, aggc=aggc,
                                              relu_masks=relu_masks)
    finally:
        fused_mp._acc_dtype = real


def agg_exact(args, p):
    """The step's agg from K4's bf16 inputs with the plain version's bf16
    rounding of relu(first) and its sums in float64."""
    import torch

    e, hs, hr, h, mask = args[:5]
    d = torch.float64
    p = {name: v.to(d) for name, v in p.items()}

    def c(x):
        return x.to(torch.bfloat16).to(d)

    first = c(e) @ c(p["w_e"]) + hs.to(d) + hr.to(d)[:, None] + p["b1"]
    x1 = c(torch.relu(first)) @ c(p["w2"]) + p["b2"]
    del first
    xhat = (x1 - x1.mean(-1, keepdim=True)) * torch.rsqrt(
        x1.var(-1, unbiased=False, keepdim=True) + 1e-5)
    return ((xhat * p["ln1_scale"] + p["ln1_bias"]) * mask.to(d)[..., None]).sum(1)


def node_first_ties(h, aggc, p, relu_k):
    """The wide path's relu(node_first) decisions against float64: node_first
    of K4's bf16 ``h`` and the kernel's T(agg) ``aggc`` summed in float64,
    and each element's float32 summation bound, (2F + 1) 2^-23 of the sum
    of its terms' magnitudes (the tensor cores' float32 sums of the 2F
    products and bn1, rounded toward 0 or to nearest). Returns (the
    kernel's decisions (``relu_k`` > 0) that differ from float64's, those
    of them farther from 0 than their bound)."""
    import torch

    d = torch.float64
    h, aggc = h.to(d), aggc.to(d)
    w_nh, w_na, bn1 = p["w_nh"].to(d), p["w_na"].to(d), p["bn1"].to(d)
    nf = h @ w_nh + aggc @ w_na + bn1
    bound = (2 * h.shape[-1] + 1) * 2.0**-23 * (h.abs() @ w_nh.abs() + aggc.abs() @ w_na.abs()
                                                 + bn1.abs())
    flips = (relu_k > 0) != (nf > 0)
    return int(flips.sum()), int((flips & (nf.abs() > bound)).sum())


def bf16_tie_check(args, p, grads, norm):
    """K4 in bf16 with agg's rounding ties decided as the kernel decided
    them: one more launch hands out the kernel's float32 agg (``agg_out``),
    which is held to ``agg_exact`` (2-norm, relative), and its outputs and
    weight gradients are returned beside the plain version with its sums
    in float64 fed the kernel's bf16 rounding of that agg. Where a float32
    sum order puts agg within float32 noise of a bf16 rounding midpoint,
    each order rounds it its own way, and at F >= 192 such ties moved the
    weight gradients past their limits (BF16_TIE_WIDTHS). On the wide path
    (F > 256) the launch also hands out its T(relu(node_first))
    (``relu_out``): the plain version takes the kernel's relu(node_first)
    decisions, each of which must match float64's unless node_first lies
    within its float32 summation bound of 0 (``node_first_ties``). Returns
    (agg error, {name: error under ``norm``} for de, dhs, dhr, dh and the
    weight gradients, with "nf_flips" and "nf_outside" the kernel's
    relu(node_first) decisions apart from float64's and those outside the
    bound (0 where the kernel hands none out), the launch's outputs)."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    # the launch at the kernels' width (args at the true width f: padded,
    # the outputs, the gradients, agg and relu(node_first) cut back to f)
    f = args[3].shape[-1]
    width = fused_mp.kernel_width(f)
    n, dev = args[3].shape[0], args[3].device
    agg_k = torch.empty((n, width), dtype=torch.float32, device=dev)
    wide = width > fused_mp.INSTANCES[-1]  # the wide path, either design
    relu_k = torch.empty((n, width), dtype=args[3].dtype, device=dev) if wide else None
    padded = [t if i == 4 else fused_mp.pad_last(t, width).contiguous()
              for i, t in enumerate(args[:5])]
    got = fused_mp.gns_mp_step_bwd(*padded, fused_mp.pad_params(p, width),
                                   *(fused_mp.pad_last(t, width).contiguous() for t in grads),
                                   latent=f, agg_out=agg_k, relu_out=relu_k)
    del padded
    got = tuple(o[..., :f].contiguous() for o in got[:4]) + (
        {k: fused_mp._sliced(v, p[k].shape) for k, v in got[4].items()},)
    agg_k = agg_k[:, :f].contiguous()
    flips = outside = 0
    masks = None
    if wide:
        relu_k = relu_k[:, :f]
        flips, outside = node_first_ties(args[3], agg_k.to(args[3].dtype), p, relu_k)
        masks = (None, relu_k > 0)
    exact = bf16_exact(args, p, grads, aggc=agg_k, relu_masks=masks)
    agg64 = agg_exact(args, p)
    agg_err = float((agg_k.double() - agg64).norm() / agg64.norm().clamp_min(1e-30))
    errs = {name: norm(x, y) for name, x, y in zip(("de", "dhs", "dhr", "dh"), got[:4], exact[:4])}
    errs.update({name: norm(got[4][name], exact[4][name]) for name in fused_mp.BWD_PARAM_ORDER})
    errs.update(nf_flips=flips, nf_outside=outside)
    return agg_err, errs, got


def compare_bwd(sets, tie_rule=False):
    """K4 against its plain version (bf16 and float32), bit-identical weight
    gradients over two launches, and its time. With ``tie_rule`` the bf16
    weight gradients are held, each within K4_TOL["bf16_grads"], to the
    plain version with its sums in float64 fed the kernel's bf16 rounding
    of agg, and the kernel's agg to the float64 sum (``bf16_tie_check``);
    the raw error against the float32 plain version is printed."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    ok, worst = True, 0.0
    bwd = true_width("gns_mp_step_bwd", 1)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)

    for label, args in sets.items():
        for dt in (torch.bfloat16, torch.float32):
            a = [t.to(dt) if i != 4 else t for i, t in enumerate(args[:5])]
            p = fused_mp.kernel_params(args[5], dt)
            g = [t.to(dt) for t in args[6:]]
            got = bwd(*a, p, *g)
            want = fused_mp.gns_mp_step_bwd_plain(*a, p, *g)
            again = bwd(*a, p, *g)
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
                tied = ""
                grads_ok = grad_err <= K4_TOL["bf16_grads"]
                if tie_rule:
                    agg_err, errs, fed = bf16_tie_check(a, p, g, rel)
                    same &= all(torch.equal(got[4][n], fed[4][n])
                                for n in fused_mp.BWD_PARAM_ORDER)
                    tie_err = max(errs[n] for n in fused_mp.BWD_PARAM_ORDER)
                    grads_ok = (agg_err <= K4_TOL["float32"] and tie_err <= K4_TOL["bf16_grads"]
                                and errs["nf_outside"] == 0)
                    tied = (f"; relu(node_first) decided apart from float64 {errs['nf_flips']}, "
                            f"{errs['nf_outside']} of them outside the float32 summation bound "
                            "(limit 0); the kernel's agg against the float64 sum: 2-norm "
                            f"{agg_err:.3g} (limit 1e-4); against the plain version summed in "
                            "float64 and fed the kernel's T(agg) (agg's bf16 rounding ties "
                            "and, past F = 256, relu(node_first)'s decided as the kernel "
                            "decided them), per gradient " + json.dumps(
                                {n: float(f"{errs[n]:.3g}") for n in fused_mp.BWD_PARAM_ORDER})
                            + f" (limit 1e-4 each), outputs " + json.dumps(
                                {n: float(f"{errs[n]:.3g}") for n in ("de", "dhs", "dhr", "dh")}))
                passed = out_l2 <= K4_TOL["bf16_out"] and grads_ok
                worst = max(worst, float(max((x.float() - y.float()).abs().max()
                                             for x, y in zip(got[:4], want[:4]))))
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
    ms = cuda_time(lambda: bwd(*call))
    plain_ms = cuda_time(lambda: fused_mp.gns_mp_step_bwd_plain(*call), iters=3, warmup=1)
    bms, by = bound("fused_mp_bwd", call, {})
    n, k, f = args[0].shape
    log(f"fused_mp_bwd: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by}) "
        f"at N = {n}, K = {k}, F = {f}")
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
    return row, ok, counts, {"losses": losses, "durations": trainer.timer.durations}


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


# the training reference (``train_reference_check``): each tensor's
# gradient at the first step, where both sides hold the same parameters,
# within this share of its 2-norm on the CPU. float32 relu ties (an input
# within float32 noise of 0 that the card's sums and the CPU's decide
# apart, as K4's float32 gate allows) and sums that cancel move single
# elements or small tensors: the H100 read up to 1.46e-4 (GNS-2-320's
# enc_b2, 320 values summed over every edge), 5.2e-5 (GNS-5-64's W_s) and
# 3.2e-7 (GNS-2-96)
TRAIN_GRAD_L2 = 1e-3
# GNS-2-320's training reference only: a parameter element more than 1e-5
# apart passes if it is an Adam tie, its gradient within this share of the
# tensor's largest magnitude on the card and on the CPU at some step. Adam
# divides each gradient by its own running scale: its first update is lr
# times the gradient's sign, so float32 noise at a gradient near 0 moves
# such a parameter up to 2 lr. The H100 read, at GNS-2-320's first step,
# W_e of step 0 at 1.0e-6 on the card against -6.3e-7 on the CPU and a
# node-encoder weight at -8.4e-8 against 8.8e-7, of largest gradients 2.2
# and 2.4: Adam's first step moved each pair 2 lr (2e-4) apart; 6 elements
# lay more than 1e-5 apart, each such a tie, and the rest within 4.8e-6
ADAM_TIE = 1e-4


def _step_grads(trainer, model):
    """Wraps the trainer's optimizer step: records each step's gradients
    (float32, on the CPU) by parameter name and returns the list."""
    grads, real = [], trainer.optimizer.step

    def step(*a, **k):
        grads.append({n: p.grad.detach().float().cpu().clone()
                      for n, p in model.named_parameters() if p.grad is not None})
        return real(*a, **k)

    trainer.optimizer.step = step
    return grads


def _max0(t):
    return float(t.max()) if t.numel() else 0.0


def _adam_ties(grads, named):
    """GNS-2-320's parameter gate (``ADAM_TIE``) on the two sides' gradients
    by step and parameters: (the largest difference of an element that is
    not an Adam tie, its parameter, the elements more than 1e-5 apart, the
    Adam ties among them, their largest difference)."""
    import torch

    beyond = tied = 0
    worst, worst_at, tie_max = 0.0, "", 0.0
    for n in named[1]:
        diff = (named[0][n] - named[1][n]).abs()
        tie = torch.zeros_like(diff, dtype=torch.bool)
        for a, b in zip(*grads):
            if n not in b:
                continue
            small = ADAM_TIE * b[n].abs().max()
            tie |= (a[n].abs() <= small) & (b[n].abs() <= small)
        far = diff > 1e-5
        beyond += int(far.sum())
        tied += int((far & tie).sum())
        tie_max = max(tie_max, _max0(diff[far & tie]))
        if _max0(diff[~tie]) > worst:
            worst, worst_at = _max0(diff[~tie]), n
    return worst, worst_at, beyond, tied, tie_max


def train_reference_check(device, mp_steps=2, latent=None, adam_ties=False):
    """Three float32 training steps on the card agree with the same steps
    on the CPU (TF32 off, the same host-drawn noise): 1,000 particles,
    GNS-2-128 (GNS-``mp_steps``-``latent``), batch 2, one pushforward
    unroll from step 1, lr 1e-4 (the
    config default). Not run under torch.use_deterministic_algorithms: the
    sender gather's backward adds with atomics, and the tolerances (losses
    1e-5 relative, parameters 1e-5 absolute, the first step's gradients
    ``TRAIN_GRAD_L2`` in each tensor's 2-norm) hold with any order of those
    float32 sums; the later steps' gradients are printed. Adam divides
    each gradient by its own running scale, so
    where a gradient nearly cancels, float32 summation noise moves the
    parameter by a share of lr: the difference grows with lr. With
    ``adam_ties`` (GNS-2-320 only) a parameter element more than 1e-5 apart
    passes if it is an Adam tie (``ADAM_TIE``); how many, and how far
    apart, is printed."""
    import numpy as np

    from lagrangebench_torch import checkpoint

    pf = {"steps": [-1, 0], "unrolls": [0, 1], "probs": [0, 1]}
    losses, params, grads, named = [], [], [], []
    for dev in (device, "cpu"):
        trainer, model, _ = train_setup(dev, n_particles=1000, dtype="float32",
                                        mp_steps=mp_steps, lr=1e-4, pushforward=pf,
                                        latent=latent)
        grads.append(_step_grads(trainer, model))
        steps, _ = record_steps(trainer)
        trainer.train(step_max=2)
        losses.append(np.asarray([loss for _, loss in steps]))
        params.append(checkpoint.flatten_tree(model.jax_params()))
        named.append({n: p.detach().cpu() for n, p in model.named_parameters()})
    loss_err = float(np.max(np.abs(losses[0] - losses[1]) / np.abs(losses[1])))

    def worst(step, norm):
        return max((float(norm(a - b)) / max(float(norm(b)), 1e-30), n)
                   for n, a, b in ((n, step[0][n], step[1][n]) for n in step[1]))

    per_step = [(worst(s, lambda t: t.norm()), worst(s, lambda t: t.abs().max()))
                for s in zip(*grads)]
    grads_ok = len(per_step) == 3 and per_step[0][0][0] <= TRAIN_GRAD_L2
    tie_note = ""
    if adam_ties:
        par_err, worst_at, beyond, tied, tie_max = _adam_ties(grads, named)
        tie_note = (f" outside the Adam ties; {beyond} elements more than 1e-5 apart, {tied} "
                    f"of them Adam ties (gradients within {ADAM_TIE} of the tensor's largest "
                    f"on both sides at some step), up to {tie_max:.3g}")
    else:
        par_err, worst_at = max((float(np.max(np.abs(params[0][k] - params[1][k]))), k)
                                for k in params[1])
    log(f"train reference (GNS-{mp_steps}-{latent or LATENT}): 3 float32 steps, cuda vs cpu: "
        f"losses {losses[0].tolist()} vs "
        f"{losses[1].tolist()}, max rel diff {loss_err:.3g} (tol 1e-5); parameters max abs "
        f"diff {par_err:.3g} at {worst_at} (tol 1e-5){tie_note}; gradients |cuda - cpu| "
        "by step, (2-norm of the tensor's, max of the tensor's largest): " + json.dumps(
            [[[float(f"{e:.3g}"), n] for e, n in s] for s in per_step])
        + f" (first step's 2-norm tol {TRAIN_GRAD_L2}, the rest printed)")
    return len(losses[0]) == 3 and loss_err <= 1e-5 and par_err <= 1e-5 and grads_ok


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
# side of a rounding boundary moves a value by one bf16 ulp (2^-8 of it).
# K5 is held, at every H and R, to its plain version with its sums in
# float64 (``painn_plain64``), from which the kernel and the float32 plain
# version each part at their own ties: on the H100 the kernel read up to
# 1.32e-4 from it at H = 1,024 in 3D (sums over up to 2,048 terms), where
# the float32 plain version read up to 1.9e-4. A kernel that skipped one of
# those roundings would move every value it feeds by up to half an ulp:
# the plain version with none of them (float32 arithmetic on the same bf16
# values) read 2.7e-3 to 3.1e-3 on every shape. 2e-4 lies between; the
# phase prints that witness and requires it above the limit.
PAINN_TOL = {"float32": 1e-4, "painn_msg_bf16": 1e-5, "painn_layer_bf16": 2e-4}
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
    ``packed`` and the sender index: it gathers the rows itself), and the
    FLOPs they need: K6's at 67 TFLOP/s (CUDA-core float32: it has no
    product); K5's the smaller of two readings, all on the CUDA cores, or
    its products on the tensor cores (float32 inputs as three TF32 products,
    3xTF32, at 495 TFLOP/s; bf16 at 989) beside the rest on the CUDA cores.
    K5 prints both readings and the bf16 one."""
    import torch

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))

    if name == "painn_msg":
        g, wij, nd, h = args
        n, k, dim = nd.shape
        edges = n * k
        byts = nbytes(g, wij, nd) + n * (1 + dim) * h * 4
        ops = edges * (4 + 4 * dim) * h  # ds: 2H; msg1, msg2: 2H; dv: 4H per axis
        t_bytes, t_ops = byts / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    else:
        packed, sidx, phi, nd, s, v, p = args
        n, k, dim = nd.shape
        h, r = s.shape[-1], phi.shape[-1] - 1
        edges = n * k
        byts = nbytes(packed, sidx, phi, nd, s, v) + nbytes(*p.values()) + nbytes(s, v)
        products = edges * 2 * r * 3 * h + n * (dim * 2 * h * 2 * h + 2 * 2 * h * h
                                                + 2 * h * 3 * h)
        rest = edges * (2 * 3 * h + 3 * h + (1 + 4 * dim) * h) + n * 20 * dim * h
        t_bytes = byts / PEAK_BYTES * 1e3
        t_cuda = (products + rest) / PEAK_FP32 * 1e3
        mult, peak = (1, PEAK_BF16) if s.dtype == torch.bfloat16 else (3, PEAK_TF32)
        t_tensor = max(mult * products / peak, rest / PEAK_FP32) * 1e3
        t_bf16 = max(products / PEAK_BF16, rest / PEAK_FP32) * 1e3
        t_ops = min(t_cuda, t_tensor)
        log(f"{name} bound at N = {n}, K = {k}, H = {h}, R = {r}: bytes {t_bytes:.4f} ms; "
            f"operations on the CUDA cores {t_cuda:.4f} ms ({(products + rest) / 1e9:.2f} "
            f"GFLOP), with the products on the tensor cores {t_tensor:.4f} ms "
            f"({'bf16 at 989' if mult == 1 else '3xTF32 at 495'} TFLOP/s; in bf16 {t_bf16:.4f})")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def painn_plain64(args):
    """K5's plain version on bf16 ``args`` with its sums in float64 (its
    bf16 roundings kept; the module's accumulation dtype swapped for the
    call)."""
    import torch

    from lagrangebench_torch.ops import painn_msg

    real = painn_msg._acc_dtype
    painn_msg._acc_dtype = lambda dtype: torch.float64
    try:
        return painn_msg.painn_layer_plain(*args)
    finally:
        painn_msg._acc_dtype = real


def compare_painn_kernels(seen, names=("painn_msg", "painn_layer"), timed=True):
    """K6 and K5 against their plain versions (float32 and bf16; K5's bf16
    against the plain version summed in float64, ``painn_plain64``, beside
    the float32 plain version's reading, printed), timed at the path's
    float32 shapes (untimed with ``timed=False``: the gates of phases 17
    and 18)."""
    import torch

    from lagrangebench_torch.ops import painn_msg

    rows, ok = {}, True
    funcs = {"painn_msg": (painn_msg.painn_message_kernel, painn_msg.painn_message_plain,
                           painn_msg.PAINN_MSG),
             "painn_layer": (painn_msg.painn_layer_kernel, painn_msg.painn_layer_plain,
                             painn_msg.PAINN_LAYER)}
    for name in names:
        kern, plain, handle = funcs[name]
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
        ref = wb if name == "painn_msg" else painn_plain64(bf)

        def l2_of(outs, ref=ref):
            return max(float((a.float() - b.float()).norm() / b.float().norm())
                       for a, b in zip(outs, ref))

        l2 = l2_of(gb)
        mx = max(float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
                 for a, b in zip(gb, ref))
        tol = PAINN_TOL[f"{name}_bf16"]
        passed &= l2 <= tol
        against = ""
        if name == "painn_layer":
            # the plain version with none of its inner bf16 roundings
            wide = plain(*(t.float() if t.is_floating_point() else t for t in bf[:6]),
                         {k: v.float() for k, v in bf[6].items()})
            l2_wide = l2_of([t.to(torch.bfloat16) for t in wide])
            passed &= l2_wide > tol
            against = (f" against the plain version summed in float64 (the float32 plain "
                       f"version reads {l2_of(wb):.3g}, the kernel {l2_of(gb, wb):.3g} from it; "
                       f"without the inner bf16 roundings it reads {l2_wide:.3g}, required "
                       f"above the limit)")
        ok &= passed
        log(f"{name}: float32 (TF32 off) max|kernel-plain| {err:.3g}, {rel:.3g} of the largest "
            f"(tol {PAINN_TOL['float32']}); bf16 relative 2-norm {l2:.3g} (tol {tol}), max-norm "
            f"{mx:.3g}{against}{'' if passed else '  FAIL'}")
        if not timed:
            continue
        ms = cuda_time(lambda: kern(*args))
        plain_ms = cuda_time(lambda: plain(*args), iters=5, warmup=1)
        bms, by = painn_bound(name, args)
        n, k, _ = args[0 if name == "painn_msg" else 2].shape
        log(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by}) at "
            f"N = {n}, K = {k}, float32")
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
        self.unrolls = []  # each training step's pushforward unrolls
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
                    rec.unrolls.append(int(args[3]))
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


def capture_slot_inputs(device, n_particles=None, **overrides):
    """K7's and K8's inputs from one slot preprocess and one bf16 forward
    of path A (8,000 particles, 3D, batch 1), K9's from one dense
    preprocess with in-kernel geometry at batch 2; run on the plain
    versions. Also returns the slot list of that preprocess and its
    positions, for the maps check. ``overrides``: more config keys (the
    GNS-5-64 phase's width and depth); ``n_particles`` per sample (the
    default of ``runner_data`` unless given)."""
    import torch

    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    cfg = gns_cfg(**{"neighbors.format": "slot"}, **overrides)
    _, _, test = runner_data(cfg) if n_particles is None else runner_data(cfg, n_particles)
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

    def rec_mp(e, cand, bases, hs, hr, h, p, enc=None, latent=None):
        key = "fused_mp_slot_enc" if enc is not None else "fused_mp_slot"
        args = tuple(t.clone() for t in (e, cand, bases, hs, hr, h))
        seen.setdefault(key, (args + (p, enc), {} if latent is None else {"latent": latent}))
        return fused_mp.gns_mp_step_slot_plain(e, cand, bases, hs, hr, h, p, enc, latent)

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


def compare_slot_kernels(seen, names=("slot_scan", "neighbor_scan_geometry", "fused_mp_slot",
                                      "fused_mp_slot_enc")):
    """K7, K9 and K8 (those of ``names``) against their plain versions on
    the captured inputs, timed."""
    import torch

    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.ops import neighbors_cuda as nlc

    funcs = {
        "slot_scan": (nlc.slot_scan, nlc.slot_scan_plain, nlc.SLOT_SCAN, (0, 3)),
        "neighbor_scan_geometry": (nlc.neighbor_scan_geometry, nlc.neighbor_scan_geometry_plain,
                                   nlc.NEIGHBOR_SCAN_GEOMETRY, (0, 2)),
        "fused_mp_slot": (true_width("gns_mp_step_slot", 3), fused_mp.gns_mp_step_slot_plain,
                          fused_mp.FUSED_MP_SLOT, None),
        "fused_mp_slot_enc": (true_width("gns_mp_step_slot", 3),
                              fused_mp.gns_mp_step_slot_plain, fused_mp.FUSED_MP_SLOT_ENC, None),
    }
    rows, ok = {}, True
    for name in names:
        kern, plain, handle, int_outs = funcs[name]
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
    return rows, ok


def check_slot_update(nbrs, position):
    """The whole slot update (K1, K7 and the maps) on the card against the
    same update on the CPU."""
    import torch

    got, want = nbrs.update(position), nbrs.update(position.cpu())
    same = torch.equal(got.idx.cpu(), want.idx) and all(
        torch.equal(got.aux[key].cpu(), want.aux[key])
        for key in ("slot_to_particle", "particle_to_slot", "bases"))
    geo = max(float((got.aux[key].cpu() - want.aux[key]).abs().max())
              for key in ("rel_disp", "rel_dist"))
    log(f"slot update, card vs CPU: cand and maps equal {same}, geometry {geo:.3g} (tol "
        f"{GEOM_TOL})")
    return same and geo <= GEOM_TOL


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
    rows, ok = compare_slot_kernels(seen)
    ok &= check_slot_update(nbrs, position)
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


def window_inputs(structure, dtype, device, f=None):
    """E2's inputs on the probe's structure at latent width f (the probe's
    F unless given): seeded e, h, hr, hs (as the probe's main makes them),
    hs_ext = hs[ext_idx], the weights of ``window_select.init_step_params``
    (seed 0) in the kernel's layout."""
    import numpy as np
    import torch

    from lagrangebench_torch.experiments import window_select as ws
    from lagrangebench_torch.ops import fused_mp

    n_rows, _, ext_idx, cand, w0s, _, wsub = structure
    f = f or ws.F
    rng = np.random.default_rng(1)
    e, h, hr, hs = (torch.as_tensor(rng.normal(size=shape), dtype=dtype, device=device)
                    for shape in ((n_rows, ws.K, f), (n_rows, f), (n_rows, f), (n_rows, f)))
    p = fused_mp.kernel_params(ws.init_step_params(f, torch.Generator().manual_seed(0)), dtype)
    p = {name: v.to(device) for name, v in p.items()}
    hs_ext = hs[torch.as_tensor(ext_idx, device=device)]
    return (e, torch.as_tensor(cand, device=device), torch.as_tensor(w0s, device=device),
            int(wsub), hs_ext, hr, h, p)


def compare_window(structure, device, f=None):
    """E2 against its plain version (K3's limits, bf16 and float32 with TF32
    off) on the probe's 8,000-particle structure at latent width f (the
    probe's F unless given), and against K3 on the decoded, masked gather
    (printed); timed in bf16."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    ok, errs = True, {}
    window = true_width("gns_mp_step_window", 4)
    for dt, tol in ((torch.bfloat16, K3_TOL["bfloat16"]), (torch.float32, K3_TOL["float32"])):
        args = window_inputs(structure, dt, device, f)
        e, cand, w0s, wsub, hs_ext, hr, h, p = args
        got = window(*args)
        want = fused_mp.gns_mp_step_window_plain(*args)
        rows, mask = fused_mp.window_sender_rows(cand, w0s, wsub)
        hs_g = torch.where(mask[..., None], hs_ext[rows], 0).to(dt).contiguous()
        k3 = true_width("gns_mp_step", 1)(e, hs_g, hr, h, mask.to(torch.float32), p)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        vs_k3 = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, k3))
        passed = err <= tol
        ok &= passed
        errs[str(dt)[6:]] = err
        log(f"fused_mp_window ({str(dt)[6:]}): max|kernel-plain| {err:.4g} (tol {tol}); "
            f"max|E2 - K3 on the decoded gather| {vs_k3:.4g} (expected 0: the same kernel "
            f"code reads the same rows){'' if passed else '  FAIL'}")
    args = window_inputs(structure, torch.bfloat16, device, f)
    ms = cuda_time(lambda: window(*args))
    plain_ms = cuda_time(lambda: fused_mp.gns_mp_step_window_plain(*args), iters=5, warmup=1)
    bms, by = bound("fused_mp_window", args, {})
    n_rows, k = args[1].shape
    log(f"fused_mp_window: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bms:.4f} ms by "
        f"{by}) at n_rows = {n_rows}, K = {k}, F = {args[0].shape[-1]}, n_ext = "
        f"{args[4].shape[0]}, WSUB = {args[3]}, bf16; "
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


def _runner_call(label, cfg, data, kernels, neighbor_kernels=True, expect=None):
    """runner.train_or_infer with the counters zeroed just before and read
    just after; (metrics, counts, recorder, ok). K1 and K2 must launch once
    per neighbor update (a forward or an allocation), every other kernel of
    ``kernels`` never, or as often as ``expect(recorder)`` says (a dict by
    kernel name); with ``neighbor_kernels=False`` K1 and K2 may not launch."""
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
    if expect is not None:
        want.update(expect(rec))
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
        f"{pos.shape[1]} particles)")
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


# ---------------------------------------------------------------------------
# slice 11: data parallelism (two gloo ranks sharing cuda:0; the runner
# under torch.distributed.run)
# ---------------------------------------------------------------------------

# The two ranks' bf16 losses (one sample each) against train_path's one
# process at batch 2: |diff| <= tol x |loss|. They sum in other orders (the
# encoder and decoder products over 8,000 rows, not 16,000; the loss and the
# gradients in two partial sums). Step 0 runs before any update, so only the
# forward's bf16 roundings differ there (DP_LOSS0_RTOL). AdamW then moves
# every weight by about lr per step whatever its gradient's size, so a weight
# whose bf16 gradient sum is near 0 can move the other way, and the runs
# drift apart over the 12 steps (DP_LOSS_RTOL, the gate of the other bf16
# comparisons; the drift read 1.33e-2 at step 11 on an H100, 2.9e-5 at
# step 0). The float32 run below holds the data-parallel arithmetic to 1e-5.
DP_LOSS0_RTOL, DP_LOSS_RTOL = 1e-3, 2e-2
DP_F32_TOL = 1e-5  # float32 parameters after 3 steps, x their largest magnitude
DP_INFER_RTOL = 1e-5  # float32 infer metrics per trajectory, relative
DP_INFER_STEPS, DP_LAUNCH_STEPS = 10, 5  # infer 20 steps before phase 18 was added
DP_PROFILE = [4, 6]  # rank 0's trace: steps 4-6 (4 and 5 unroll once)
DP_F32_PF = {"steps": [-1, 0], "unrolls": [0, 1], "probs": [0, 1]}


def dp_kernels():
    from lagrangebench_torch.ops import fused_mp, neighbors_cuda

    return (neighbors_cuda.COLUMN_TABLE, neighbors_cuda.NEIGHBOR_SCAN, fused_mp.FUSED_MP,
            fused_mp.FUSED_MP_ENC, fused_mp.FUSED_MP_BWD)


def dp_infer(ckp, batch, device, mesh=None):
    """A float32 GNS-10-128 ``infer`` from ``ckp`` of ``batch`` trajectories
    at batch ``batch`` (DP_INFER_STEPS steps, mse, e_kin, Sinkhorn)."""
    from lagrangebench_torch.evaluate import infer

    test, metadata = make_data(N_PARTICLES, ISL + DP_INFER_STEPS, n_trajs=3)
    case, model = build_case_model(metadata, device, dtype="float32")
    return infer(model, case, test, load_ckp=ckp, n_rollout_steps=DP_INFER_STEPS,
                 cfg_eval_infer={"batch_size": batch, "n_trajs": batch,
                                 "metrics": ["mse", "e_kin", "sinkhorn"]},
                 device=device, mesh=mesh)


def dp_float32_params(device, mesh=None):
    """3 float32 training steps (1,000 particles, GNS-2-128, one unroll
    from step 1, TF32 off); the parameters by tree path."""
    from lagrangebench_torch import checkpoint

    trainer, model, _ = train_setup(device, n_particles=1000, dtype="float32", mp_steps=2,
                                    lr=1e-4, pushforward=DP_F32_PF, mesh=mesh)
    trainer.train(step_max=2)
    return checkpoint.flatten_tree(model.jax_params())


def _dp_rank(rank, pg_file, out_dir, ckp, prof_dir, device):
    """One of two ranks on ``device`` over gloo (spawned by ``dp_path``): the
    full-width bf16 training with counts (rank 0 traced), the float32 run
    and the sharded and fallback infers; results to ``rank<r>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    from lagrangebench_torch import checkpoint
    from lagrangebench_torch.parallel import init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # the ranks share the host
    if device == "cuda":
        torch.cuda.set_device(0)
    init_distributed(f"file://{pg_file}", 2, rank, device=device, backend="gloo")
    mesh = make_mesh(2)
    logging = {"profile_dir": prof_dir, "profile_steps": DP_PROFILE} if rank == 0 else {}
    trainer, model, _ = train_setup(device, mesh=mesh, logging=logging)
    steps, allocs = record_steps(trainer)
    kernels = dp_kernels()
    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(step_max=TRAIN_STEPS - 1)
    torch.cuda.synchronize()
    out = {"wall": time.perf_counter() - t0, "counts": {k.name: k.launches for k in kernels},
           "losses": [loss for _, loss in steps], "allocs": allocs[0],
           "durations": trainer.timer.durations,
           "params": checkpoint.flatten_tree(model.jax_params())}
    del trainer, model
    out["params32"] = dp_float32_params(device, mesh)
    out["infer"] = {b: dp_infer(ckp, b, device, mesh) for b in (2, 3)}
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _rel_tree(got, want, path=""):
    """The largest |got - want| / |want| over nested metric dicts."""
    import numpy as np

    if isinstance(want, dict):
        return max(_rel_tree(got[k], want[k], f"{path}/{k}") for k in want)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                        / np.maximum(np.abs(want), 1e-30)))


def dp_trace_check(path):
    """K3 and K4 launches and the gradient all-reduce in rank 0's trace;
    prints the all-reduce's host time per traced step."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [ev.get("name", "") for ev in events]
    k3 = sum("fused_mp" in n and "bwd" not in n for n in names)
    k4 = sum("fused_mp_bwd" in n for n in names)
    red = [ev for ev in events if ev.get("name") in ("gloo:all_reduce", "c10d::allreduce_")]
    steps = DP_PROFILE[1] - DP_PROFILE[0] + 1
    per = {}
    for ev in red:
        per[ev["name"]] = per.get(ev["name"], 0.0) + float(ev.get("dur", 0)) / 1e3 / steps
    log(f"dp profile: {os.path.basename(path)}: {len(names)} events, {k3} K3 kernel events, "
        f"{k4} K4, {len(red)} all-reduce events; host ms per traced step "
        f"{json.dumps({k: round(v, 3) for k, v in per.items()})} ({steps} steps)")
    return k3 > 0 and k4 > 0 and len(red) > 0


def dp_ranks(ref, tmp, device):
    """Phase 11 (a): two ranks on cuda:0 over gloo against one process."""
    import pickle

    import numpy as np
    import torch.multiprocessing as mp

    from lagrangebench_torch import checkpoint

    test, metadata = make_data(N_PARTICLES, ISL + DP_INFER_STEPS, n_trajs=3)
    _, seeded = build_case_model(metadata, device, dtype="float32")
    ckp = os.path.join(tmp, "ckp")
    checkpoint.save_checkpoint(ckp, seeded.jax_params(), {}, {"step": 0, "loss": None})
    del seeded
    want32 = dp_float32_params(device)
    want_infer = {b: dp_infer(ckp, b, device) for b in (2, 3)}
    prof = os.path.join(tmp, "prof")
    t0 = time.perf_counter()
    mp.spawn(_dp_rank, args=(os.path.join(tmp, "pg"), tmp, ckp, prof, device), nprocs=2)
    log(f"dp: two ranks on cuda:0 over gloo: {time.perf_counter() - t0:.1f} s wall "
        "(start-up, kernel loads and every run below)")
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))

    ok = True
    want_counts = ref["counts"]
    for r, got in enumerate(ranks):
        log(f"dp rank {r}: {TRAIN_STEPS} bf16 steps in {got['wall']:.2f} s wall, "
            f"{got['allocs']} allocations, launches {got['counts']} (one process: "
            f"{want_counts})")
        if got["counts"] != want_counts:
            log(f"FAIL: dp rank {r} launch counts differ from the one-process run's")
            ok = False
    losses = np.asarray(ranks[0]["losses"])
    want = np.asarray(ref["losses"])
    rel = (np.abs(losses - want) / np.abs(want) if losses.shape == want.shape
           else np.full(1, np.inf))
    log(f"dp losses (bf16, two ranks of batch 1 vs one process at batch 2): "
        f"{np.round(losses, 5).tolist()} vs {np.round(want, 5).tolist()}; rel diff at step 0 "
        f"{rel[0]:.3g} (tol {DP_LOSS0_RTOL}), max {rel.max():.3g} (tol {DP_LOSS_RTOL})")
    if not (np.all(np.isfinite(losses)) and rel[0] <= DP_LOSS0_RTOL
            and rel.max() <= DP_LOSS_RTOL and ranks[0]["losses"] == ranks[1]["losses"]):
        log("FAIL: dp bf16 losses")
        ok = False
    same = all(np.array_equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ranks[0]["params"])
    log(f"dp: the two ranks' {len(ranks[0]['params'])} parameter tensors bit-identical: {same}")
    ok &= same

    top = max(float(np.abs(v).max()) for v in want32.values())
    err32 = max(float(np.abs(ranks[r]["params32"][k] - want32[k]).max())
                for r in range(2) for k in want32) / top
    log(f"dp float32 (3 steps, 1,000 particles, GNS-2-128): parameters max |two ranks - one "
        f"process| {err32:.3g} of the largest magnitude (tol {DP_F32_TOL})")
    if not err32 <= DP_F32_TOL:
        log("FAIL: dp float32 parameters")
        ok = False

    for b, label in ((2, "sharded, one trajectory per rank"), (3, "fallback, whole batch")):
        err = max(_rel_tree(ranks[r]["infer"][b], want_infer[b]) for r in range(2))
        ntraj = [len(ranks[r]["infer"][b]) for r in range(2)]
        log(f"dp infer batch {b} ({label}, {DP_INFER_STEPS} steps, float32): metrics max rel "
            f"diff {err:.3g} (tol {DP_INFER_RTOL}), trajectories per rank {ntraj}")
        if not (err <= DP_INFER_RTOL and ntraj == [b, b]):
            log(f"FAIL: dp infer at batch {b}")
            ok = False

    trace = os.path.join(prof, "trace_rank0.json")
    if not (os.path.exists(trace) and dp_trace_check(trace)):
        log("FAIL: dp profile trace (rank 0, steps 4-6) missing or without K3, K4 and the "
            "all-reduce")
        ok = False
    one = np.asarray(ref["durations"]) * 1e3  # d[i]: step i + 1
    tail = slice(DP_PROFILE[1] + 1, TRAIN_STEPS - 1)  # steps 8-11: after the trace
    per = [np.asarray(r["durations"])[tail] * 1e3 for r in ranks]
    log(f"dp ms per train step (host clock, synchronized, steps 8-11, one unroll): rank 0 "
        f"median {np.median(per[0]):.2f}, rank 1 {np.median(per[1]):.2f}, one process at "
        f"batch 2 {np.median(one[tail]):.2f} (all {np.round(per[0], 2).tolist()}, "
        f"{np.round(per[1], 2).tolist()}, {np.round(one[tail], 2).tolist()}) "
        f"[GNS-{MP_STEPS}-{LATENT} bf16, {N_PARTICLES} particles per sample; two processes "
        f"share one card, gloo stages the all-reduce through the host; not a scaling number]")
    return ok, [r["counts"] for r in ranks]


def dp_launched(tmp, device="cuda"):
    """The worker of ``python -m torch.distributed.run --standalone
    --nproc_per_node=1 chip_smoke.py --dp-launched <dir>``: the shipped
    ``configs/rpf_3d/gns.yaml`` through ``runner.train_or_infer`` with
    ``parallel.data=-1``, ``mode=all``, 3 steps and a 5-step infer, in the
    launcher's process group (NCCL, one rank)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lagrangebench_torch import runner

    torch.backends.cuda.matmul.allow_tf32 = False
    extra = {"gpu": -1} if device == "cpu" else {}  # a rehearsal on the CPU
    cfg = gns_cfg(**{"parallel.data": -1, "mode": "all", "train.step_max": 2,
                     "train.batch_size": BATCH, "logging.log_steps": 1, "logging.eval_steps": 2,
                     "logging.ckp_dir": f"{tmp}/ckp", "eval.n_rollout_steps": DP_LAUNCH_STEPS,
                     "eval.train.n_trajs": 1, "eval.infer.n_trajs": BATCH,
                     "eval.rollout_dir": f"{tmp}/rollouts", **extra})
    metrics = runner.train_or_infer(cfg, data=runner_data(cfg))
    log(f"dp launched: process group {dist.get_backend()}, world {dist.get_world_size()}, "
        f"rank {dist.get_rank()} on {device}")
    log(f"dp launched metrics: {json.dumps({k: float(v) for k, v in metrics.items()})}")
    dist.destroy_process_group()
    return 0


def dp_launcher(tmp, device):
    """Phase 11 (b): the runner under torch.distributed.run (an NCCL group
    of one), then ``parallel.data=2`` in this process against
    ``parallel.data=1`` from that run's checkpoint."""
    import numpy as np

    from lagrangebench_torch import runner

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           os.path.abspath(__file__), "--dp-launched", tmp, device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("dp launched", "0", "1",
                                                                    "2", "Training"))]
    for ln in lines:
        log(f"  | {ln}")
    ckps = os.listdir(os.path.join(tmp, "ckp")) if os.path.isdir(os.path.join(tmp, "ckp")) \
        else []
    log(f"dp launcher: torch.distributed.run --standalone --nproc_per_node=1: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.1f} s wall; checkpoint directories "
        f"{ckps}")
    backend = "nccl" if device == "cuda" else "gloo"
    ok = (proc.returncode == 0 and len(ckps) == 1 and "dp launched metrics" in proc.stdout
          and f"process group {backend}, world 1" in proc.stdout)
    if not ok:
        log("FAIL: the launched runner (exit code, one checkpoint, an NCCL group, metrics)")
        log(proc.stderr[-3000:])
        return False

    metrics = {}
    for n in (1, 2):
        cfg = gns_cfg(**{"mode": "infer", "load_ckp": os.path.join(tmp, "ckp", ckps[0]),
                         "parallel.data": n, "eval.n_rollout_steps": DP_LAUNCH_STEPS,
                         "eval.infer.n_trajs": BATCH, "train.batch_size": BATCH,
                         **({"gpu": -1} if device == "cpu" else {})})
        metrics[n] = runner.train_or_infer(cfg, data=runner_data(cfg))
    rel = max(abs(metrics[2][k] - metrics[1][k]) / max(abs(metrics[1][k]), 1e-30)
              for k in metrics[1])
    log(f"dp: parallel.data=2 in one process (no launcher) vs parallel.data=1: {metrics[2]} vs "
        f"{metrics[1]}, max rel diff {rel:.3g} (tol 1e-6)")
    finite = all(np.isfinite(v) for v in metrics[2].values())
    if not (set(metrics[1]) == set(metrics[2]) and rel <= 1e-6 and finite):
        log("FAIL: parallel.data=2 in one process")
        return False
    return True


def dp_path(ref, device="cuda"):
    """Phase 11: data parallelism; (a) two gloo ranks sharing cuda:0 against
    the one-process run, (b) the runner under the launcher."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ok, counts = dp_ranks(ref, tmp, device)
    with tempfile.TemporaryDirectory() as tmp:
        ok &= dp_launcher(tmp, device)
    log(f"phase 11 (data parallelism): {time.perf_counter() - t0:.1f} s wall")
    return ok, counts



# ---------------------------------------------------------------------------
# phase 12 (slice 12): spatial sharding over a slab ring
# ---------------------------------------------------------------------------

SPATIAL_RANKS = 3
# phase 12's sizes: GNS-10-128 and PaiNN-5-128 at 8,000 particles; a CPU
# rehearsal passes smaller ones to spatial_path
# infer 10 and train 8 steps (20 and 12 before phase 18 was added: the run's
# time limit)
SPATIAL_SIZES = {"n": N_PARTICLES, "gns_steps": 10, "painn_steps": 5, "latent": LATENT,
                 "infer": 10, "train": 8, "painn_infer": 5, "profile": 3}
# float32, three ranks against the unsharded port on the same weights: the
# slab search orders each receiver's slots otherwise than K1 + K2, so the
# K-sums differ by float32 rounding. Accelerations, loss and gradients
# within 1e-5 of the largest value; rollout metrics within 1e-5 relative.
SPATIAL_F32_TOL = 1e-5
SPATIAL_PUSHFORWARD = {"steps": [-1, UNROLL_FROM - 1], "unrolls": [0, 1], "probs": [0, 1]}
SPATIAL_METRICS = ["mse", "e_kin", "sinkhorn"]


def spatial_kernels():
    from lagrangebench_torch.ops import fused_mp, painn_msg

    return (fused_mp.FUSED_MP, fused_mp.FUSED_MP_ENC, fused_mp.FUSED_MP_BWD,
            painn_msg.PAINN_LAYER)


def spatial_cfgs(sizes, dtype="bfloat16"):
    """The shipped GNS and PaiNN configs under ``parallel.spatial=3`` at batch
    1 (GNS in ``dtype``, PaiNN as shipped: float32), cut to ``sizes``."""
    from lagrangebench_torch.config import Config, merge

    common = {"parallel.spatial": SPATIAL_RANKS, "train.batch_size": 1,
              "eval.train.n_trajs": 1, "logging.log_steps": 1,
              "model.latent_dim": sizes["latent"]}
    gns = gns_cfg(**common, **{"model.num_mp_steps": sizes["gns_steps"],
                               "model.compute_dtype": dtype,
                               "eval.n_rollout_steps": sizes["infer"]})
    gns = merge(gns, Config({"train": {"pushforward": SPATIAL_PUSHFORWARD}}))
    painn = painn_cfg(**common, **{"model.num_mp_steps": sizes["painn_steps"],
                                   "eval.n_rollout_steps": sizes["painn_infer"]})
    return gns, painn


def spatial_inputs(sizes, device):
    """Both configs, the synthetic splits of each and the seeded parameter
    trees (GNS fused layout, PaiNN standard layout), as every rank builds
    them."""
    from lagrangebench_torch.models import setup_model

    gns, painn = spatial_cfgs(sizes)
    out = {}
    for name, cfg in (("gns", gns), ("painn", painn)):
        data = runner_data(cfg, n_particles=sizes["n"], n_trajs=2)
        meta = data[0].metadata
        params = setup_model(cfg.model, meta, seed=0, device="cpu").jax_params()
        out[name] = (cfg, data, params)
    return out


class SpatialClock:
    """While entered: the host ms per step of every rollout chunk of
    ``parallel.spatial`` (synchronized by the chunk's flag read) with its
    (steps, overflow, drift), and of every train step (synchronized), by
    wrapping the module's functions."""

    def __init__(self):
        self.rollout, self.chunks, self.train = [], [], []

    def __enter__(self):
        import torch

        from lagrangebench_torch.parallel import spatial as sp

        self.saved = (sp._rollout_chunk, sp.build_spatial_gns_train_step)
        real_chunk, real_build = self.saved
        clock = self

        def sync():
            if torch.cuda.is_available():
                torch.cuda.synchronize()

        def chunk(core, pos, ptype, count, n_steps, gt=None):
            t0 = time.perf_counter()
            out = real_chunk(core, pos, ptype, count, n_steps, gt)
            clock.rollout.append((time.perf_counter() - t0) * 1e3 / n_steps)
            clock.chunks.append((n_steps, *out[2]))
            return out

        def build(*a, **k):
            step, net = real_build(*a, **k)

            def timed(*args, **kw):
                sync()
                t0 = time.perf_counter()
                out = step(*args, **kw)
                sync()
                clock.train.append((time.perf_counter() - t0) * 1e3)
                return out

            timed.core = step.core
            return timed, net

        sp._rollout_chunk, sp.build_spatial_gns_train_step = chunk, build
        return self

    def __exit__(self, *exc):
        from lagrangebench_torch.parallel import spatial as sp

        sp._rollout_chunk, sp.build_spatial_gns_train_step = self.saved


def _spatial_case(cfg, data, device):
    return gns_case(cfg, data[0].metadata, device)


def spatial_main_runs(inputs, device, n_space, sizes, store_ckp=None):
    """The main path through the port's entry points on a ring of
    ``n_space``: GNS bf16 ``infer_spatial`` (the test split's 2 trajectories),
    ``train_spatial`` (one pushforward unroll from step 4, validation at
    the last step, a checkpoint in ``store_ckp``), PaiNN ``infer_spatial``;
    the launch counts of each, zeroed just before it; ms per step."""
    import numpy as np

    from lagrangebench_torch.checkpoint import flatten_tree
    from lagrangebench_torch.parallel import spatial as sp

    kernels = spatial_kernels()
    out = {"counts": {}}
    cfg, data, params = inputs["gns"]
    case = _spatial_case(cfg, data, device)
    pcfg, pdata, pparams = inputs["painn"]
    pcase = _spatial_case(pcfg, pdata, device)
    runs = {
        "infer": lambda: sp.infer_spatial(
            params, case, data[2], n_devices=n_space, num_mp_steps=cfg.model.num_mp_steps,
            cfg_eval_infer={"n_trajs": 2, "metrics": SPATIAL_METRICS},
            n_rollout_steps=cfg.eval.n_rollout_steps, compute_dtype="bfloat16", model="gns",
            device=device),
        "train": lambda: sp.train_spatial(
            params, case, data[0], data[1], n_devices=n_space, model="gns",
            num_mp_steps=cfg.model.num_mp_steps, cfg_train=cfg.train,
            cfg_logging=cfg.logging, input_seq_length=cfg.model.input_seq_length,
            metadata=data[0].metadata, seed=cfg.seed, step_max=sizes["train"],
            store_ckp=store_ckp, compute_dtype="bfloat16",
            n_rollout_steps_val=cfg.eval.n_rollout_steps, n_trajs_val=1, device=device),
        "painn": lambda: sp.infer_spatial(
            pparams, pcase, pdata[2], n_devices=n_space, num_mp_steps=pcfg.model.num_mp_steps,
            cfg_eval_infer={"n_trajs": 1, "metrics": ["mse"]},
            n_rollout_steps=pcfg.eval.n_rollout_steps, compute_dtype="float32",
            model="painn", device=device),
    }
    for name, run in runs.items():
        for kern in kernels:
            kern.launches = 0
        with SpatialClock() as clock:
            result = run()
        out["counts"][name] = {k.name: k.launches for k in kernels}
        out[name] = {"rollout_ms": clock.rollout, "chunks": clock.chunks,
                     "train_ms": clock.train}
        if name == "train":
            std, _, opt = result
            out[name]["finite"] = all(np.isfinite(v).all() for v in flatten_tree(std).values())
            out[name]["count"] = opt.count
        else:
            out[name]["metrics"] = result
    return out


class SpatialRun:
    """GNS (or PaiNN) of phase 12 on a ring: its config, splits, parameters,
    case and the sizes the spatial functions take."""

    def __init__(self, inputs, name, device, mesh):
        self.cfg, self.data, self.params = inputs[name]
        self.case = _spatial_case(self.cfg, self.data, device)
        self.device, self.mesh = device, mesh
        self.isl = int(self.cfg.model.input_seq_length)
        self.mp_steps = int(self.cfg.model.num_mp_steps)
        self.cutoff = float(self.data[0].metadata["default_connectivity_radius"])
        self.kw = dict(box=[BOX] * DIM, cutoff=self.cutoff, input_seq_length=self.isl,
                       num_mp_steps=self.mp_steps, device=device)

    def caps(self, pos):
        from lagrangebench_torch.parallel import spatial as sp

        k_cap, cell_cap = sp.spatial_caps(pos[:, self.isl - 1], [BOX] * DIM, self.cutoff)
        return dict(k_cap=k_cap, cell_cap=cell_cap)

    def block(self, pos, ptype):
        """This rank's slab of one (N, T, dim) window."""
        from lagrangebench_torch.parallel import spatial as sp

        pos_sh, pt_sh, counts, order = sp.spatial_partition(pos, ptype, self.mesh.size, BOX)
        r = self.mesh.rank
        return (pos_sh[r], pt_sh[r], counts[r]), sp._slab_rows(counts, order, r)

    def train_step(self, dtype):
        """The GNS train step on the ring and this rank's slab of the train
        split's first window (no noise)."""
        from lagrangebench_torch.parallel import spatial as sp

        pos, ptype = self.data[0][0]
        step, net = sp.build_spatial_gns_train_step(
            self.mesh, self.params, normalization_stats=self.case.normalization_stats,
            compute_dtype=dtype, **self.caps(pos), **self.kw)
        return step, net, self.block(pos[:, :self.isl + 1], ptype)[0]


def spatial_float32(inputs, device, n_space):
    """float32 GNS on a ring of ``n_space``: the forward of the test split's
    first window (this slab's global rows and accelerations), one train
    step on the train split's first window without noise (loss and
    gradients by tree path) and ``infer_spatial``'s metrics (2 trajectories)."""
    import torch

    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    run = SpatialRun(inputs, "gns", device, make_mesh(n_space))
    stats = run.case.normalization_stats
    pos, ptype = run.data[2][0]
    fwd = sp.build_spatial_gns_forward(
        run.mesh, run.params, vel_mean=stats["velocity"]["mean"],
        vel_std=stats["velocity"]["std"], compute_dtype=torch.float32, **run.caps(pos),
        **run.kw)
    block, rows = run.block(pos[:, :run.isl], ptype)
    acc, overflow = fwd(*block)
    out = {"rows": rows, "acc": acc[:rows.size].cpu().numpy(), "overflow": overflow}
    step, net, block = run.train_step(torch.float32)
    loss, overflow = step(*block)
    out["loss"], out["step_overflow"] = float(loss), bool(overflow)
    out["grads"] = {path: (p.grad.t() if tr else p.grad).cpu().numpy()
                    for path, p, tr in net.jax_leaves()}
    out["metrics"] = sp.infer_spatial(
        run.params, run.case, run.data[2], n_devices=n_space, num_mp_steps=run.mp_steps,
        cfg_eval_infer={"n_trajs": 2, "metrics": SPATIAL_METRICS},
        n_rollout_steps=run.cfg.eval.n_rollout_steps, compute_dtype="float32", model="gns",
        device=device, mesh=run.mesh)
    return out


def spatial_unsharded_float32(inputs, device):
    """The unsharded port on the same float32 weights and windows: the GNS
    forward, one train step's loss and gradients (``mse_loss``, no noise)
    and ``infer``'s metrics."""
    import numpy as np
    import torch

    from lagrangebench_torch.config import Config, merge
    from lagrangebench_torch.evaluate import infer
    from lagrangebench_torch.models import setup_model
    from lagrangebench_torch.train.trainer import mse_loss

    cfg, data, params = inputs["gns"]
    cfg = merge(cfg, Config({"model": {"compute_dtype": "float32"}}))
    case = _spatial_case(cfg, data, device)
    model = setup_model(cfg.model, data[0].metadata, seed=0, device=device)
    model.load_jax_params(params)
    isl = int(cfg.model.input_seq_length)
    pos, ptype = data[2][0]
    window = (torch.as_tensor(pos[:, :isl], device=device), torch.as_tensor(ptype, device=device))
    feats, _ = case.allocate_eval(window)
    with torch.no_grad():
        acc = model(feats, window[1])["acc"].cpu().numpy()
    tpos, tptype = data[0][0]
    sample = (torch.as_tensor(tpos[:, :isl + 1], device=device),
              torch.as_tensor(tptype, device=device))
    _, nbrs = case.allocate_eval((sample[0][:, :isl], sample[1]))
    feats, targets, _ = case.preprocess(torch.Generator(), sample, 0.0, nbrs)
    loss = mse_loss(model, feats, sample[1], targets, {"acc": 1.0, "vel": 0.0, "pos": 0.0})
    loss.backward()
    grads = {path: (p.grad.t() if tr else p.grad).cpu().numpy()
             for path, p, tr in model.jax_leaves()}
    model.zero_grad()
    metrics = infer(model, case, data[2], n_rollout_steps=cfg.eval.n_rollout_steps,
                    cfg_eval_infer={"n_trajs": 2, "batch_size": 1, "metrics": SPATIAL_METRICS},
                    device=device)
    return {"acc": acc, "loss": float(loss.detach()), "grads": grads, "metrics": metrics,
            "finite": bool(np.isfinite(acc).all())}


def _host(t):
    import torch

    if isinstance(t, dict):
        return {k: _host(v) for k, v in t.items()}
    return t.detach().cpu().clone() if isinstance(t, torch.Tensor) else t


def spatial_capture(inputs, device, n_space, record):
    """One bf16 GNS train step and one float32 PaiNN forward on the ring
    (every rank takes part); with ``record``, on the host: K3's inputs (the
    first plain step and the encoder step), K4's (the step before the last
    and the encoder step) and K5's (the first layer: the slab's receivers and
    the 3 N_loc rows of its slab and halo) as they reach the kernels."""
    import torch

    from lagrangebench_torch.ops import fused_mp, painn_msg
    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    mesh = make_mesh(n_space)
    gns = SpatialRun(inputs, "gns", device, mesh)
    step, _, block = gns.train_step("bfloat16")
    painn = SpatialRun(inputs, "painn", device, mesh)
    pos, ptype = painn.data[2][0]
    stats = painn.case.normalization_stats
    fwd = sp.build_spatial_painn_forward(
        mesh, painn.params, vel_mean=stats["velocity"]["mean"],
        vel_std=stats["velocity"]["std"], compute_dtype=torch.float32, **painn.caps(pos),
        **painn.kw)
    seen, bwd = {}, []
    real = (fused_mp.gns_mp_step, fused_mp.gns_mp_step_bwd, painn_msg.painn_layer_kernel)

    def rec_fwd(e, hs, hr, h, mask, p, enc=None, latent=None):
        key = "fused_mp_enc" if enc is not None else "fused_mp"
        seen.setdefault(key, (_host((e, hs, hr, h, mask.to(torch.float32), p, enc)), {}))
        return real[0](e, hs, hr, h, mask, p, enc, latent=latent)

    def rec_bwd(*args, **kw):
        bwd.append(_host(args) if len(bwd) in (1, gns.mp_steps - 1) else None)
        return real[1](*args, **kw)

    def rec_k5(*args):
        seen.setdefault("painn_layer", _host(args))
        return real[2](*args)

    if record:
        fused_mp.gns_mp_step, fused_mp.gns_mp_step_bwd, painn_msg.painn_layer_kernel = (
            rec_fwd, rec_bwd, rec_k5)
    try:
        step(*block)
        fwd(*painn.block(pos[:, :painn.isl], ptype)[0])
    finally:
        fused_mp.gns_mp_step, fused_mp.gns_mp_step_bwd, painn_msg.painn_layer_kernel = real
    if not record:
        return None
    return {"k3": {k: v for k, v in seen.items() if k != "painn_layer"},
            "k4": {"plain step": bwd[1], "encoder step": bwd[-1]},
            "k5": seen.get("painn_layer")}


def spatial_profile(inputs, device, n_space, sizes, trace):
    """``sizes["profile"]`` rollout steps and as many train steps of GNS bf16
    on the ring; with ``trace`` under torch.profiler: the host ms per step of
    the halo exchange spans and of their staging."""
    import torch

    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    run = SpatialRun(inputs, "gns", device, make_mesh(n_space))
    n = sizes["profile"]
    step, _, block = run.train_step("bfloat16")
    step(*block)  # warm
    pos, ptype = run.data[2][0]

    def rollout():
        sp.spatial_rollout(run.params, pos[:, :run.isl], ptype, mesh=run.mesh, n_steps=n,
                           normalization_stats=run.case.normalization_stats,
                           compute_dtype="bfloat16", **run.kw)

    out = {}
    for label, fn in (("rollout", rollout), ("train", lambda: [step(*block) for _ in range(n)])):
        if not trace:
            fn()
            continue
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            fn()
        spans = {}
        for ev in prof.events():
            if ev.name in ("spatial::halo_exchange", "spatial::halo_staging"):
                spans[ev.name] = spans.get(ev.name, 0.0) + ev.cpu_time_total / 1e3 / n
        out[label] = spans
    return out


def _spatial_rank(rank, pg_file, out_dir, sizes, device):
    """One of three ranks on ``device`` over gloo (spawned by
    ``spatial_path``): the main path with counts, the float32 runs, the
    kernel captures and the profile (rank 0); results to ``rank<r>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    from lagrangebench_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or SPATIAL_RANKS) // SPATIAL_RANKS))
    if device == "cuda":
        torch.cuda.set_device(0)
    init_distributed(f"file://{pg_file}", SPATIAL_RANKS, rank, device=device, backend="gloo")
    inputs = spatial_inputs(sizes, device)
    ckp = os.path.join(out_dir, f"ckp_rank{rank}")
    out = spatial_main_runs(inputs, device, SPATIAL_RANKS, sizes, store_ckp=ckp)
    out["float32"] = spatial_float32(inputs, device, SPATIAL_RANKS)
    out["capture"] = spatial_capture(inputs, device, SPATIAL_RANKS, record=rank == 0)
    out["profile"] = spatial_profile(inputs, device, SPATIAL_RANKS, sizes, trace=rank == 0)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _max_rel(got, want):
    import numpy as np

    top = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(v)).max()) for k, v in want.items()) \
        / max(top, 1e-30)


def spatial_path(device="cuda", sizes=None):
    """Phase 12: spatial sharding; three gloo ranks sharing ``device`` run the
    main path (GNS bf16 ``infer_spatial`` and ``train_spatial``, PaiNN
    ``infer_spatial``) with counts, float32 gates against the unsharded port,
    kernel checks on rank 0's slab and a trace; the same main path in one
    process for comparison. Returns (ok, launches per rank)."""
    import pickle

    import numpy as np
    import torch.multiprocessing as mp

    from lagrangebench_torch.checkpoint import flatten_tree, load_checkpoint

    sizes = dict(SPATIAL_SIZES, **(sizes or {}))
    t0 = time.perf_counter()
    ok = True
    inputs = spatial_inputs(sizes, device)
    one = spatial_main_runs(inputs, device, 1, sizes)
    want32 = spatial_unsharded_float32(inputs, device)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        mp.spawn(_spatial_rank, args=(os.path.join(tmp, "pg"), tmp, sizes, device),
                 nprocs=SPATIAL_RANKS)
        log(f"spatial: {SPATIAL_RANKS} ranks on {device} over gloo: "
            f"{time.perf_counter() - t1:.1f} s wall (start-up and every run below)")
        ranks = []
        for r in range(SPATIAL_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        ckps = [os.path.exists(os.path.join(tmp, f"ckp_rank{r}", "params.npz"))
                for r in range(SPATIAL_RANKS)]
        std_layout = False
        if ckps[0]:
            params, _, _, _ = load_checkpoint(os.path.join(tmp, "ckp_rank0"))
            std_layout = "Dense_0" in params and not any(k.startswith("mp0_") for k in params)
    log(f"spatial train_spatial checkpoints written by rank {[r for r, c in enumerate(ckps) if c]}"
        f", standard layout {std_layout}")
    ok &= ckps == [True] + [False] * (SPATIAL_RANKS - 1) and std_layout

    # launches: K3 (both instances) on every main-path run of GNS, K4 in
    # training, K5 on the PaiNN run, on each rank
    need = {"infer": ("fused_mp", "fused_mp_enc"), "train": ("fused_mp", "fused_mp_enc",
                                                            "fused_mp_bwd"),
            "painn": ("painn_layer",)}
    for r, got in enumerate(ranks):
        log(f"spatial rank {r} launches: {json.dumps(got['counts'])}")
        for run, names in need.items():
            missing = [n for n in names if got["counts"][run][n] == 0]
            if missing:
                log(f"FAIL: spatial rank {r} {run}: no launch of {missing}")
                ok = False
    log(f"spatial one process launches: {json.dumps(one['counts'])}")

    # the main path's results: finite
    for r, got in enumerate(ranks):
        finite = (got["train"]["finite"] and got["train"]["count"] == sizes["train"]
                  and all(np.isfinite(v).all() for m in (got["infer"]["metrics"],
                                                        got["painn"]["metrics"])
                          for v in flatten_tree(m).values()))
        if not finite:
            log(f"FAIL: spatial rank {r}: non-finite metrics or parameters, or steps missing")
            ok = False

    # kernels against their plain versions on rank 0's slab
    cap = ranks[0]["capture"]

    def to_dev(x):
        if isinstance(x, dict):
            return {k: to_dev(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(to_dev(v) for v in x)
        return x.to(device) if hasattr(x, "to") else x

    if device == "cuda":
        seen = {k: (to_dev(v[0]), v[1]) for k, v in cap["k3"].items()}
        n_loc, k = seen["fused_mp"][0][1].shape[:2]
        log(f"spatial K3 inputs from rank 0's slab: N_loc = {n_loc}, K = {k}")
        _, k3_ok = compare_kernels(seen, names=("fused_mp", "fused_mp_enc"))
        _, k4_ok = compare_bwd({k: to_dev(v) for k, v in cap["k4"].items()})
        k5 = {"painn_layer": to_dev(cap["k5"])}
        m_rows, n_recv = k5["painn_layer"][0].shape[0], k5["painn_layer"][2].shape[0]
        log(f"spatial K5 inputs from rank 0's slab: {n_recv} receivers, packed of {m_rows} "
            f"source rows (3 N_loc: {m_rows == 3 * n_recv})")
        _, k5_ok = compare_painn_kernels(k5, names=("painn_layer",))
        ok &= k3_ok and k4_ok and k5_ok and m_rows == 3 * n_recv

    # float32: three ranks against the unsharded port
    acc = np.zeros_like(want32["acc"])
    for got in ranks:
        acc[got["float32"]["rows"]] = got["float32"]["acc"]
    err = float(np.abs(acc - want32["acc"]).max()) / float(np.abs(want32["acc"]).max())
    got32 = ranks[0]["float32"]
    loss_err = abs(got32["loss"] - want32["loss"]) / abs(want32["loss"])
    grad_err = max(_max_rel(r["float32"]["grads"], want32["grads"]) for r in ranks)
    metric_err = max(_rel_tree(r["float32"]["metrics"], want32["metrics"]) for r in ranks)
    overflow = any(r["float32"]["overflow"] or r["float32"]["step_overflow"] for r in ranks)
    log(f"spatial float32 vs the unsharded GNS ({sizes['gns_steps']} steps, {sizes['n']} "
        f"particles): forward max |diff| {err:.3g} of the largest acceleration; train step "
        f"loss {got32['loss']:.6g} vs {want32['loss']:.6g} (rel {loss_err:.3g}), gradients "
        f"{grad_err:.3g} of the largest; infer metrics ({sizes['infer']} steps) max rel "
        f"{metric_err:.3g} (tol {SPATIAL_F32_TOL} each); overflow {overflow}")
    if not (max(err, loss_err, grad_err, metric_err) <= SPATIAL_F32_TOL and not overflow
            and want32["finite"]):
        log("FAIL: spatial float32 against the unsharded port")
        ok = False

    # times
    def med(xs):
        return float(np.median(xs)) if len(xs) else float("nan")

    for label, got in (("rank 0", ranks[0]), ("one process", one)):
        chunks = got["infer"]["chunks"]
        log(f"spatial infer chunks ({label}, steps / overflow / drift, reruns included): "
            f"{len(chunks)} runs, {sum(c[1] for c in chunks)} overflowed, "
            f"{sum(c[2] for c in chunks)} drifted: {chunks}")
    def accepted(got):  # chunk ms per step x steps, over the steps kept
        run = got["infer"]
        spent = sum(ms * c[0] for ms, c in zip(run["rollout_ms"], run["chunks"]))
        return spent / (2 * sizes["infer"])

    log(f"spatial ms per kept rollout step (the chunks' time, reruns included, over the "
        f"{2 * sizes['infer']} steps kept): ranks {[round(accepted(r), 3) for r in ranks]}, one "
        f"process {accepted(one):.3f}")
    roll = [med(r["infer"]["rollout_ms"]) for r in ranks]
    train = [med(r["train"]["train_ms"][1:]) for r in ranks]
    painn = [med(r["painn"]["rollout_ms"]) for r in ranks]
    log(f"spatial ms per rollout step (GNS-{sizes['gns_steps']}-{sizes['latent']} bf16, "
        f"infer_spatial, host clock per chunk, median over chunks): ranks "
        f"{[round(x, 3) for x in roll]}, one process {med(one['infer']['rollout_ms']):.3f}")
    log(f"spatial ms per train step (train_spatial, synchronized, median of steps 1-"
        f"{sizes['train'] - 1}): ranks {[round(x, 3) for x in train]}, one process "
        f"{med(one['train']['train_ms'][1:]):.3f} (all rank 0 "
        f"{[round(x, 2) for x in ranks[0]['train']['train_ms']]}, one process "
        f"{[round(x, 2) for x in one['train']['train_ms']]})")
    log(f"spatial ms per PaiNN-{sizes['painn_steps']}-{sizes['latent']} rollout step (float32):"
        f" ranks {[round(x, 3) for x in painn]}, one process "
        f"{med(one['painn']['rollout_ms']):.3f}")
    prof = ranks[0]["profile"]
    log(f"spatial halo host ms per step (rank 0's trace, {sizes['profile']} steps each): "
        f"rollout exchange {prof['rollout'].get('spatial::halo_exchange', 0.0):.3f}, of it "
        f"staging {prof['rollout'].get('spatial::halo_staging', 0.0):.3f}; train exchange "
        f"{prof['train'].get('spatial::halo_exchange', 0.0):.3f}, staging "
        f"{prof['train'].get('spatial::halo_staging', 0.0):.3f} [gloo stages each CUDA "
        "tensor through the host; three processes share one card: not a scaling number]")
    log(f"phase 12 (spatial sharding): {time.perf_counter() - t0:.1f} s wall")
    return ok, [r["counts"] for r in ranks]


# ---------------------------------------------------------------------------
# phase 13 (slice 13): spatial sharding of SEGNN and EGNN
# ---------------------------------------------------------------------------

# phase 13's sizes: SEGNN-10-64 and EGNN-5-128 at 8,000 particles; a CPU
# rehearsal passes smaller ones to steerable_path
STEER_SIZES = {"n": N_PARTICLES, "segnn_steps": 10, "segnn_latent": 64, "egnn_steps": 5,
               "egnn_latent": LATENT, "infer": 5, "train": 3, "profile": 2}
# float32, three ranks against the unsharded port on the same weights: the
# slab search orders each receiver's slots otherwise than K1 + K2, so the
# K-sums differ by float32 rounding, and EGNN's sender sums are float32
# index_add_ atomics (SEGNN's 10 layers of products deepen it). Forward and
# loss within 1e-5 of the largest value, gradients within 1e-4, the 5-step
# infer metrics within 1e-5 relative.
STEER_F32_TOL = {"forward": 1e-5, "loss": 1e-5, "grads": 1e-4, "metrics": 1e-5}
# The seeded EGNN-5-128 blows up on this data (its 5-step e_kin reads ~1e8
# against the data's ~0.4; particles move ~0.4 a step): two unsharded runs
# of the same weights on the card differ by up to 0.93 relative in their
# 5-step metrics, from the atomics alone. Its metrics gate reads the first
# rollout step (mse1); the 5-step difference is printed.
STEER_CHAOTIC = ("egnn",)
STEER_MODELS = ("segnn", "egnn")
# The spatial path trains the normalized acceleration MSE (JAX's does too),
# not the position loss egnn.yaml's lr 5e-4 is set for. On this data the
# first Adam step at 5e-4 blows EGNN's dt-scaled correction heads up (loss
# 2.66e4 -> 1.52e8, on the card and on the CPU alike), and the validation
# rollout then runs out of capacity retries; at 5e-6 the loss falls.
STEER_EGNN_LR = 5e-6


def steerable_cfgs(sizes):
    """The shipped SEGNN and EGNN configs under ``parallel.spatial=3`` at
    batch 1 (both float32, as shipped), cut to ``sizes``."""
    common = {"parallel.spatial": SPATIAL_RANKS, "train.batch_size": 1,
              "eval.train.n_trajs": 1, "logging.log_steps": 1,
              "eval.n_rollout_steps": sizes["infer"]}
    return {"segnn": segnn_cfg(**common, **{"model.num_mp_steps": sizes["segnn_steps"],
                                            "model.latent_dim": sizes["segnn_latent"]}),
            "egnn": egnn_cfg(**common, **{"model.num_mp_steps": sizes["egnn_steps"],
                                          "model.latent_dim": sizes["egnn_latent"],
                                          "train.optimizer.lr_start": STEER_EGNN_LR})}


class SteerRun:
    """SEGNN or EGNN of phase 13: its config, splits, case, the port's module
    (``model_def``) and its seeded parameter tree, as every rank builds them."""

    def __init__(self, name, cfg, sizes, device):
        from lagrangebench_torch.checkpoint import flatten_tree, unflatten_tree
        from lagrangebench_torch.models import setup_model

        self.name, self.cfg, self.device = name, cfg, device
        self.data = runner_data(cfg, n_particles=sizes["n"], n_trajs=2)
        meta = self.data[0].metadata
        self.case = gns_case(cfg, meta, device)
        self.model = setup_model(cfg.model, meta, seed=0, device=device,
                                 normalization_stats=self.case.normalization_stats)
        # a copy: on the CPU the tree's arrays would share the parameters'
        # memory, and the training runs change those
        self.params = unflatten_tree({k: v.copy()
                                      for k, v in flatten_tree(self.model.jax_params()).items()})
        self.isl = int(cfg.model.input_seq_length)
        self.mp_steps = int(cfg.model.num_mp_steps)
        self.cutoff = float(meta["default_connectivity_radius"])
        self.kw = dict(box=[BOX] * DIM, cutoff=self.cutoff, input_seq_length=self.isl,
                       model_def=self.model, device=device)

    def caps(self, pos):
        from lagrangebench_torch.parallel import spatial as sp

        k_cap, cell_cap = sp.spatial_caps(pos[:, self.isl - 1], [BOX] * DIM, self.cutoff)
        return dict(k_cap=k_cap, cell_cap=cell_cap)

    def infer(self, n_space, sizes, mesh=None):
        from lagrangebench_torch.parallel import spatial as sp

        return sp.infer_spatial(
            self.params, self.case, self.data[2], n_devices=n_space,
            num_mp_steps=self.mp_steps, cfg_eval_infer={"n_trajs": 2, "metrics": SPATIAL_METRICS},
            n_rollout_steps=sizes["infer"], compute_dtype="float32", model=self.name,
            model_def=self.model, device=self.device, mesh=mesh)

    def train(self, n_space, sizes, store_ckp):
        from lagrangebench_torch.parallel import spatial as sp

        return sp.train_spatial(
            self.params, self.case, self.data[0], self.data[1], n_devices=n_space,
            model=self.name, num_mp_steps=self.mp_steps, cfg_train=self.cfg.train,
            cfg_logging=self.cfg.logging, input_seq_length=self.isl,
            metadata=self.data[0].metadata, seed=self.cfg.seed, step_max=sizes["train"],
            store_ckp=store_ckp, compute_dtype="float32", n_rollout_steps_val=sizes["infer"],
            n_trajs_val=1, model_def=self.model, device=self.device)

    def step(self, mesh):
        """The spatial train step (no noise) on the ring and this rank's slab
        of the train split's first window; (step, block)."""
        from lagrangebench_torch.parallel import spatial as sp

        pos, ptype = self.data[0][0]
        step, _ = sp.build_spatial_gns_train_step(
            mesh, self.params, normalization_stats=self.case.normalization_stats,
            compute_dtype="float32", model=self.name, num_mp_steps=self.mp_steps,
            **self.caps(pos), **self.kw)
        pos_sh, pt_sh, counts, _ = sp.spatial_partition(pos[:, :self.isl + 1], ptype, mesh.size,
                                                        BOX)
        return step, (pos_sh[mesh.rank], pt_sh[mesh.rank], counts[mesh.rank])


def steerable_inputs(sizes, device):
    return {name: SteerRun(name, cfg, sizes, device)
            for name, cfg in steerable_cfgs(sizes).items()}


def steerable_main_runs(inputs, device, n_space, sizes, store_ckp=None):
    """The main path through the port's entry points on a ring of
    ``n_space``, for SEGNN and EGNN: ``infer_spatial`` (the test split's 2
    trajectories) and ``train_spatial`` (a checkpoint in
    ``<store_ckp>_<model>``); the launch counts of every kernel, zeroed just
    before each run; ms per step."""
    import numpy as np

    from lagrangebench_torch.checkpoint import flatten_tree

    kernels = all_kernels()
    out = {"counts": {}}
    for name, run in inputs.items():
        jobs = {"infer": lambda: run.infer(n_space, sizes),
                "train": lambda: run.train(n_space, sizes,
                                           store_ckp and f"{store_ckp}_{name}")}
        for job, fn in jobs.items():
            for kern in kernels:
                kern.launches = 0
            with SpatialClock() as clock:
                result = fn()
            key = f"{name} {job}"
            out["counts"][key] = {k.name: k.launches for k in kernels if k.launches}
            out[key] = {"rollout_ms": clock.rollout, "chunks": clock.chunks,
                        "train_ms": clock.train}
            if job == "train":
                std, _, opt = result
                out[key]["finite"] = all(np.isfinite(v).all()
                                         for v in flatten_tree(std).values())
                out[key]["count"] = opt.count
            else:
                out[key]["metrics"] = result
    return out


def _normalized_acc(run, out):
    """A model's output as the normalized acceleration the spatial cores
    return (EGNN gives the physical one)."""
    if run.name == "segnn":
        return out["acc"]
    stats = run.case.normalization_stats["acceleration"]
    return (out["acc"] - stats["mean"]) / stats["std"]


def steerable_float32(inputs, device, n_space):
    """Per model on a ring of ``n_space`` (float32, TF32 off): the forward of
    the test split's first window (this slab's global rows and normalized
    accelerations) and one train step on the train split's first window
    without noise (loss and gradients by tree path)."""
    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    mesh = make_mesh(n_space)
    out = {}
    for name, run in inputs.items():
        stats = run.case.normalization_stats
        pos, ptype = run.data[2][0]
        acc_kw = {} if name == "segnn" else dict(acc_mean=stats["acceleration"]["mean"],
                                                 acc_std=stats["acceleration"]["std"])
        build = sp.build_spatial_segnn_forward if name == "segnn" else \
            sp.build_spatial_egnn_forward
        fwd = build(mesh, run.params, vel_mean=stats["velocity"]["mean"],
                    vel_std=stats["velocity"]["std"], compute_dtype="float32",
                    **acc_kw, **run.caps(pos), **run.kw)
        pos_sh, pt_sh, counts, order = sp.spatial_partition(pos[:, :run.isl], ptype, n_space,
                                                            BOX)
        r = mesh.rank
        acc, overflow = fwd(pos_sh[r], pt_sh[r], counts[r])
        rows = sp._slab_rows(counts, order, r)
        got = {"rows": rows, "acc": acc[:rows.size].cpu().numpy(), "overflow": overflow}
        step, block = run.step(mesh)
        loss, overflow = step(*block)
        got["loss"], got["step_overflow"] = float(loss), bool(overflow)
        got["grads"] = {path: (p.grad.t() if tr else p.grad).cpu().numpy()
                        for path, p, tr in run.model.jax_leaves()}
        out[name] = got
    return out


def _first_step(name, metrics):
    """The metrics the gate reads: all of them, or the first rollout step's
    (mse1) for a model whose rollout blows up (``STEER_CHAOTIC``)."""
    if name not in STEER_CHAOTIC:
        return metrics
    return {traj: {"mse1": m["mse1"]} for traj, m in metrics.items()}


def steerable_unsharded(inputs, device, sizes):
    """The unsharded port on the same float32 weights and windows, per
    model: the forward (normalized acceleration), one train step's loss
    (the kinematic-masked MSE of the normalized acceleration, no noise) and
    gradients, and ``infer``'s metrics."""
    import numpy as np
    import torch

    from lagrangebench_torch.evaluate import infer
    from lagrangebench_torch.utils import get_kinematic_mask

    out = {}
    for name, run in inputs.items():
        model, case, isl = run.model, run.case, run.isl
        model.load_jax_params(run.params)
        pos, ptype = run.data[2][0]
        window = (torch.as_tensor(pos[:, :isl], device=device),
                  torch.as_tensor(ptype, device=device))
        feats, _ = case.allocate_eval(window)
        with torch.no_grad():
            acc = _normalized_acc(run, model(feats, window[1])).cpu().numpy()
        tpos, tptype = run.data[0][0]
        sample = (torch.as_tensor(tpos[:, :isl + 1], device=device),
                  torch.as_tensor(tptype, device=device))
        _, nbrs = case.allocate_eval((sample[0][:, :isl], sample[1]))
        feats, targets, _ = case.preprocess(torch.Generator(), sample, 0.0, nbrs)
        pred = _normalized_acc(run, model(feats, sample[1]))
        keep = ~get_kinematic_mask(sample[1])
        per = torch.sum((pred - targets["acc"]) ** 2, dim=-1)
        loss = torch.where(keep, per, torch.zeros_like(per)).sum() / keep.sum()
        model.zero_grad()
        loss.backward()
        grads = {path: (p.grad.t() if tr else p.grad).cpu().numpy()
                 for path, p, tr in model.jax_leaves()}
        model.zero_grad()
        metrics = infer(model, case, run.data[2], n_rollout_steps=sizes["infer"],
                        cfg_eval_infer={"n_trajs": 2, "batch_size": 1,
                                        "metrics": SPATIAL_METRICS}, device=device)
        out[name] = {"acc": acc, "loss": float(loss.detach()), "grads": grads,
                     "metrics": metrics, "finite": bool(np.isfinite(acc).all())}
    return out


def steerable_profile(inputs, device, n_space, sizes, trace):
    """Per model, ``sizes["profile"]`` rollout steps and as many train steps
    on the ring; with ``trace`` under torch.profiler: the host ms per step
    of the halo exchange spans and of their staging."""
    import torch

    from lagrangebench_torch.parallel import make_mesh
    from lagrangebench_torch.parallel import spatial as sp

    mesh = make_mesh(n_space)
    n = sizes["profile"]
    out = {}
    for name, run in inputs.items():
        step, block = run.step(mesh)
        step(*block)  # warm
        pos, ptype = run.data[2][0]

        def rollout():
            sp.spatial_rollout(run.params, pos[:, :run.isl], ptype, mesh=mesh, n_steps=n,
                               normalization_stats=run.case.normalization_stats,
                               num_mp_steps=run.mp_steps, model=name,
                               compute_dtype="float32", **run.kw)

        for label, fn in (("rollout", rollout),
                          ("train", lambda: [step(*block) for _ in range(n)])):
            if not trace:
                fn()
                continue
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                fn()
            spans = {}
            for ev in prof.events():
                if ev.name in ("spatial::halo_exchange", "spatial::halo_staging"):
                    spans[ev.name] = spans.get(ev.name, 0.0) + ev.cpu_time_total / 1e3 / n
            out[f"{name} {label}"] = spans
    return out


def _steerable_rank(rank, pg_file, out_dir, sizes, device):
    """One of three ranks on ``device`` over gloo (spawned by
    ``steerable_path``): the main path with counts, the float32 runs and the
    profile (traced on rank 0); results to ``rank<r>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    from lagrangebench_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or SPATIAL_RANKS) // SPATIAL_RANKS))
    if device == "cuda":
        torch.cuda.set_device(0)
    init_distributed(f"file://{pg_file}", SPATIAL_RANKS, rank, device=device, backend="gloo")
    inputs = steerable_inputs(sizes, device)
    out = steerable_main_runs(inputs, device, SPATIAL_RANKS, sizes,
                              store_ckp=os.path.join(out_dir, f"ckp_rank{rank}"))
    out["float32"] = steerable_float32(inputs, device, SPATIAL_RANKS)
    out["profile"] = steerable_profile(inputs, device, SPATIAL_RANKS, sizes, trace=rank == 0)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def steerable_path(device="cuda", sizes=None):
    """Phase 13: spatial SEGNN and EGNN; three gloo ranks sharing ``device``
    run the main path (``infer_spatial`` and ``train_spatial`` of each) with
    counts, float32 gates against the unsharded port and a trace; the same
    main path in one process for comparison. Returns (ok, launches per
    rank)."""
    import pickle

    import numpy as np
    import torch.multiprocessing as mp

    from lagrangebench_torch.checkpoint import flatten_tree, load_checkpoint

    sizes = dict(STEER_SIZES, **(sizes or {}))
    t0 = time.perf_counter()
    ok = True
    inputs = steerable_inputs(sizes, device)
    one = steerable_main_runs(inputs, device, 1, sizes)
    want32 = steerable_unsharded(inputs, device, sizes)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        mp.spawn(_steerable_rank, args=(os.path.join(tmp, "pg"), tmp, sizes, device),
                 nprocs=SPATIAL_RANKS)
        log(f"steerable: {SPATIAL_RANKS} ranks on {device} over gloo: "
            f"{time.perf_counter() - t1:.1f} s wall (start-up and every run below)")
        ranks = []
        for r in range(SPATIAL_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        for name, run in inputs.items():
            ckps = [os.path.exists(os.path.join(tmp, f"ckp_rank{r}_{name}", "params.npz"))
                    for r in range(SPATIAL_RANKS)]
            layout = False
            if ckps[0]:
                params, _, _, _ = load_checkpoint(os.path.join(tmp, f"ckp_rank0_{name}"))
                layout = set(flatten_tree(params)) == set(flatten_tree(run.params))
            log(f"steerable {name} train_spatial checkpoints written by rank "
                f"{[r for r, c in enumerate(ckps) if c]}, the module's tree {layout}")
            ok &= ckps == [True] + [False] * (SPATIAL_RANKS - 1) and layout

    # launches: none of K1-K9, E1, E2 (the slab search and these models are
    # PyTorch ops, as in JAX on XLA), on every rank and in one process
    for label, got in [(f"rank {r}", g) for r, g in enumerate(ranks)] + [("one process", one)]:
        log(f"steerable {label} launches (nonzero counts): {json.dumps(got['counts'])}")
        if any(got["counts"].values()):
            log(f"FAIL: steerable {label}: a kernel launched on the SEGNN / EGNN path")
            ok = False

    for r, got in enumerate(ranks):
        finite = all(got[f"{m} train"]["finite"] and got[f"{m} train"]["count"] == sizes["train"]
                     and all(np.isfinite(v).all()
                             for v in flatten_tree(got[f"{m} infer"]["metrics"]).values())
                     for m in STEER_MODELS)
        if not finite:
            log(f"FAIL: steerable rank {r}: non-finite metrics or parameters, or steps missing")
            ok = False

    # float32: three ranks against the unsharded port
    tol = STEER_F32_TOL
    for name in STEER_MODELS:
        want = want32[name]
        acc = np.zeros_like(want["acc"])
        for got in ranks:
            acc[got["float32"][name]["rows"]] = got["float32"][name]["acc"]
        errs = {
            "forward": float(np.abs(acc - want["acc"]).max()) / float(np.abs(want["acc"]).max()),
            "loss": max(abs(r["float32"][name]["loss"] - want["loss"]) / abs(want["loss"])
                        for r in ranks),
            "grads": max(_max_rel(r["float32"][name]["grads"], want["grads"]) for r in ranks),
            "metrics": max(_rel_tree(_first_step(name, r[f"{name} infer"]["metrics"]),
                                     _first_step(name, want["metrics"])) for r in ranks)}
        every_step = max(_rel_tree(r[f"{name} infer"]["metrics"], want["metrics"])
                         for r in ranks)
        read = "the first step" if name in STEER_CHAOTIC else f"{sizes['infer']} steps"
        overflow = any(r["float32"][name]["overflow"] or r["float32"][name]["step_overflow"]
                       for r in ranks)
        log(f"steerable float32 {name} vs the unsharded port ({sizes['n']} particles): forward "
            f"{errs['forward']:.3g} of the largest acceleration, loss "
            f"{ranks[0]['float32'][name]['loss']:.6g} vs {want['loss']:.6g} (rel "
            f"{errs['loss']:.3g}), gradients {errs['grads']:.3g} of the largest, infer "
            f"metrics max rel {errs['metrics']:.3g} ({read}; every step of {sizes['infer']}: "
            f"{every_step:.3g}) (tol {json.dumps(tol)}); overflow {overflow}")
        if any(errs[k] > tol[k] for k in tol) or overflow or not want["finite"]:
            log(f"FAIL: steerable float32 {name} against the unsharded port")
            ok = False

    # times
    def med(xs):
        return float(np.median(xs)) if len(xs) else float("nan")

    for name in STEER_MODELS:
        key = f"{name} infer"
        for label, got in (("rank 0", ranks[0]), ("one process", one)):
            chunks = got[key]["chunks"]
            log(f"steerable {name} infer chunks ({label}, steps / overflow / drift, reruns "
                f"included): {len(chunks)} runs, {sum(c[1] for c in chunks)} overflowed, "
                f"{sum(c[2] for c in chunks)} drifted: {chunks}")
        roll = [med(r[key]["rollout_ms"]) for r in ranks]
        train = [med(r[f"{name} train"]["train_ms"][1:]) for r in ranks]
        log(f"steerable {name} ms per rollout step (infer_spatial, host clock per chunk, median "
            f"over chunks): ranks {[round(x, 3) for x in roll]}, one process "
            f"{med(one[key]['rollout_ms']):.3f} (every chunk, the first one cold: rank 0 "
            f"{[round(x, 2) for x in ranks[0][key]['rollout_ms']]}, one process "
            f"{[round(x, 2) for x in one[key]['rollout_ms']]})")
        log(f"steerable {name} ms per train step (train_spatial, synchronized, median of steps "
            f"1-{sizes['train'] - 1}): ranks {[round(x, 3) for x in train]}, one process "
            f"{med(one[f'{name} train']['train_ms'][1:]):.3f} (all rank 0 "
            f"{[round(x, 2) for x in ranks[0][f'{name} train']['train_ms']]}, one process "
            f"{[round(x, 2) for x in one[f'{name} train']['train_ms']]})")
        prof = ranks[0]["profile"]
        log(f"steerable {name} halo host ms per step (rank 0's trace, {sizes['profile']} steps "
            f"each): rollout exchange "
            f"{prof[f'{name} rollout'].get('spatial::halo_exchange', 0.0):.3f}, of it staging "
            f"{prof[f'{name} rollout'].get('spatial::halo_staging', 0.0):.3f}; train exchange "
            f"{prof[f'{name} train'].get('spatial::halo_exchange', 0.0):.3f}, staging "
            f"{prof[f'{name} train'].get('spatial::halo_staging', 0.0):.3f} [three processes "
            "share one card: not a scaling number]")
    log(f"phase 13 (spatial SEGNN and EGNN): {time.perf_counter() - t0:.1f} s wall")
    return ok, [r["counts"] for r in ranks]


# ---------------------------------------------------------------------------
# phase 14 (slice 13): the reference's Haiku checkpoints
# ---------------------------------------------------------------------------

REF_STEPS = {"gns": 20, "painn": 5, "painn fused": 5, "egnn": 5, "linear": 5}
REF_RTOL = 1e-5  # EGNN (float32 index_add_ atomics) and Linear; GNS and PaiNN exact
# The seeded EGNN's rollout blows up on this data, and two runs of the same
# weights differ by up to 0.93 relative after 5 steps from the order of
# the index_add_ atomics alone (NVIDIA H100): its runs take torch's
# deterministic index_add (torch.use_deterministic_algorithms), so that the
# comparison reads the weights, not the atomics.
REF_DETERMINISTIC = ("egnn",)


def reference_cfgs():
    """The shipped configs of phase 14 (``mode=infer``, batch 2)."""
    return {"gns": gns_cfg(), "painn": painn_cfg(),
            "painn fused": painn_cfg(**{"model.fused_processor": True}),
            "egnn": egnn_cfg(),
            "linear": shipped_cfg({"dataset": EGNN_CONFIG["dataset"],
                                   "model": {"name": "linear"}})}


def reference_launches(label, counts, forwards, updates):
    """The launches phase 14 expects: K1 and K2 once per neighbor update,
    and K3 (GNS), K5 (fused PaiNN) or K6 (standard PaiNN) per forward."""
    layers = {"gns": GNS_CONFIG["model"]["num_mp_steps"],
              "painn": PAINN_CONFIG["model"]["num_mp_steps"]}
    want = {k: 0 for k in counts}
    want.update({"column_table": updates, "neighbor_scan": updates})
    if label == "gns":
        want.update({"fused_mp": (layers["gns"] - 1) * forwards, "fused_mp_enc": forwards})
    elif label == "painn fused":
        want["painn_layer"] = layers["painn"] * forwards
    elif label == "painn":
        want["painn_msg"] = layers["painn"] * forwards
    return want


def reference_path(device="cuda", n_particles=N_PARTICLES):
    """Phase 14: seeded weights of GNS-10-128 bf16 (fused), PaiNN-5-128
    (standard and fused), EGNN-5-128 and Linear exported with
    ``compat.save_reference_checkpoint`` (the reference's ``save_haiku``
    layout) and inferred with ``runner.train_or_infer(mode=infer,
    load_ckp=<Haiku dir>)``, the counters zeroed around each run, against
    infer from the port's own checkpoint of the same weights: GNS and PaiNN
    equal bit for bit, EGNN (with torch's deterministic index_add) and
    Linear within 1e-5 relative."""
    import torch

    from lagrangebench_torch import checkpoint, runner
    from lagrangebench_torch.compat import save_reference_checkpoint
    from lagrangebench_torch.models import setup_model

    t0 = time.perf_counter()
    kernels = all_kernels()
    ok = True
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, base in reference_cfgs().items():
            steps = REF_STEPS[label]
            over = {"mode": "infer", "eval.n_rollout_steps": steps, "eval.infer.n_trajs": BATCH,
                    "eval.rollout_dir": f"{tmp}/rollouts"}
            if str(device) == "cpu":
                over["gpu"] = -1
            cfg = shipped_cfg(base.to_dict(), **over)
            data = runner_data(cfg, n_particles=n_particles)
            case = bounds_case(cfg, data[0].metadata, device)
            model = setup_model(cfg.model, data[0].metadata, seed=0, device=device,
                                normalization_stats=case.normalization_stats)
            params = model.jax_params()
            own, ref = f"{tmp}/{label}_own", f"{tmp}/{label}_haiku"
            checkpoint.save_checkpoint(own, params, {}, {"step": 0, "loss": None})
            save_reference_checkpoint(ref, cfg.model.name, params, cfg.model)
            out = {}
            for src, path in (("haiku", ref), ("own", own)):
                cfg.load_ckp = path
                for kern in kernels:
                    kern.launches = 0
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                torch.use_deterministic_algorithms(label in REF_DETERMINISTIC, warn_only=True)
                try:
                    with _Recorder() as rec:
                        metrics = runner.train_or_infer(cfg, data=data)
                finally:
                    torch.use_deterministic_algorithms(False)
                torch.cuda.synchronize()
                counts = {k.name: k.launches for k in kernels}
                out[src] = metrics
                if src == "haiku":
                    launches[label] = {k: v for k, v in counts.items() if v}
                    want = reference_launches(label, counts, rec.forwards,
                                              rec.forwards + rec.allocations)
                    log(f"reference {label} (mode=infer from the Haiku checkpoint, {steps} "
                        f"steps): {time.perf_counter() - t1:.1f} s wall, {rec.forwards} forward "
                        f"passes, {rec.allocations} allocations, launches "
                        f"{json.dumps(launches[label])}")
                    if counts != want:
                        log(f"FAIL: reference {label} launch counts, expected "
                            f"{json.dumps({k: v for k, v in want.items() if v})}")
                        ok = False
                ok &= _metrics_ok(metrics, f"reference {label} ({src})")
            rel = _rel_tree(out["haiku"], out["own"])
            exact = label in ("gns", "painn", "painn fused")
            log(f"reference {label}: metrics from the Haiku checkpoint {out['haiku']}; from the "
                f"port's checkpoint max rel diff {rel:.3g} ("
                f"{'must be 0' if exact else f'tol {REF_RTOL}'})")
            if (exact and out["haiku"] != out["own"]) or rel > (0.0 if exact else REF_RTOL):
                log(f"FAIL: reference {label}: the Haiku checkpoint infers otherwise")
                ok = False
    log(f"phase 14 (reference checkpoints): {time.perf_counter() - t0:.1f} s wall")
    return ok, launches


# ---------------------------------------------------------------------------
# phase 15 (slice 14): data generation
# ---------------------------------------------------------------------------

# configs/tgv_2d_gen/gns.yaml and configs/rpf_2d_gen/gns.yaml, each resolved
# over its base.yaml (the phase reads no YAML file)
GEN_GNS = {
    "model": {"name": "gns", "fused_processor": True, "compute_dtype": "bfloat16",
              "num_mp_steps": 10, "latent_dim": 128},
    "train": {"batch_size": 2, "noise_std": 3.0e-4, "overflow_sync_every": 25,
              "optimizer": {"lr_start": 5.0e-4}},
    "eval": {"n_rollout_steps": 20, "train": {"metrics_stride": 5},
             "infer": {"metrics": ["mse", "e_kin", "sinkhorn"], "out_type": "pkl"}},
    "logging": {"log_steps": 500, "eval_steps": 5000},
    "neighbors": {"backend": "auto"},
}
TGV_GEN_CONFIG = {
    **GEN_GNS,
    "dataset": {"src": "datasets/TGV_2500_gen"},
    "logging": {**GEN_GNS["logging"], "wandb_project": "tgv_2d_gen"},
    "train": {**GEN_GNS["train"], "step_max": 50000,
              "optimizer": {"lr_start": 5.0e-4, "lr_decay_steps": 15000},
              "pushforward": {"steps": [-1, 15000, 30000, 40000], "unrolls": [0, 1, 2, 3],
                              "probs": [18, 2, 1, 1]}},
    "eval": {**GEN_GNS["eval"], "train": {"n_trajs": 10, "metrics_stride": 5}},
}
RPF_GEN_CONFIG = {
    **GEN_GNS,
    "dataset": {"src": "datasets/RPF_2D_gen"},
    "logging": {**GEN_GNS["logging"], "wandb_project": "rpf_2d_gen"},
    "train": {**GEN_GNS["train"], "step_max": 25000,
              "optimizer": {"lr_start": 5.0e-4, "lr_decay_steps": 7500},
              "pushforward": {"steps": [-1, 7500, 15000, 20000], "unrolls": [0, 1, 2, 3],
                              "probs": [18, 2, 1, 1]}},
    "eval": {**GEN_GNS["eval"], "train": {"n_trajs": 4, "metrics_stride": 5}},
}
DATAGEN_CASES = ("tgv2d", "tgv3d", "dam", "rpf", "ldc")
# the reference scales (TGV: particles per side; else dx) and the phase's
# run lengths; DATAGEN_CPU_SIZES is the CPU rehearsal's default
DATAGEN_SIZES = {"tgv2d": 50, "tgv3d": 20, "dam": 0.025, "rpf": 0.025, "ldc": 1 / 46,
                 "frame": 40, "gate_substeps": 10, "tgv_trajs": 6, "tgv_frames": 30,
                 "rpf_frames": 120, "rpf_every": 60, "rpf_warmup": 600, "train_steps": 5,
                 "tgv_rollout": 20, "rpf_rollout": 6, "timing_runs": 5, "profile": 10,
                 "egnn_steps": 5}
DATAGEN_CPU_SIZES = {"tgv2d": 16, "tgv3d": 10, "dam": 0.1, "rpf": 1 / 16, "ldc": 1 / 16,
                     "frame": 8, "gate_substeps": 8, "tgv_trajs": 6, "tgv_frames": 14,
                     "rpf_frames": 120, "rpf_every": 2, "rpf_warmup": 10, "train_steps": 2,
                     "tgv_rollout": 4, "rpf_rollout": 4, "timing_runs": 1, "profile": 2,
                     "egnn_steps": 3}
# float32 solver state, card against CPU and K1 + K2 against the cell
# list, after the gates' substeps: max |r diff| (minimum image) and
# max |v diff| / max |v|. The runs differ in the order of each particle's
# neighbor sums only: on the CPU, K1 + K2's plain versions against the cell
# list at these scales read at most 4.77e-7 (DAM) and 4.03e-5 (DAM, RPF);
# the limits are ten times that.
DATAGEN_TOL = {"r": 5e-6, "v": 4e-4}
# a pair that one search keeps and the other drops must lie within this
# relative distance of the cutoff (float32 rounding of the distance)
DATAGEN_CUTOFF_TIE = 1e-5
# TGV momentum drift over 200 float32 substeps at 256 particles, max |sum
# v - sum v0|: the pair forces cancel up to float32 rounding (5.83e-5 on
# the CPU)
DATAGEN_MOMENTUM_TOL = 1e-3


def datagen_case(name, sizes, seed=0):
    """(make_sph kwargs, r, v, tag, wall mask or None) of one case family at
    ``sizes``, with the generators' physical settings."""
    import numpy as np

    from lagrangebench_torch.data_gen import wcsph

    rng = np.random.default_rng(seed)
    if name in ("tgv2d", "tgv3d"):
        dim, n_side = (2 if name == "tgv2d" else 3), sizes[name]
        r, v = wcsph.tgv_initial_state(n_side, rng, dim=dim)
        kw = dict(dx=1.0 / n_side, box=[1.0] * dim, visc=0.01, c0=10.0)
        if dim == 3:  # the tgv3d preset of data_gen.generate
            kw.update(nl_skin_h=0.25, capacity_multiplier=1.5)
        return kw, r, v, np.zeros(len(r), np.int32), None
    dx = sizes[name]
    if name == "dam":
        r, v, tag, box, wall = wcsph.dam_initial_state(dx, rng)
        return dict(dx=dx, box=box, visc=0.01, c0=15.0, pbc=[False, False], g_ext=[0.0, -1.0],
                    wall_mask=wall, free_surface=True), r, v, tag, wall
    if name == "rpf":
        r, v, tag = wcsph.rpf_initial_state(dx, rng, box=[1.0, 2.0])
        return dict(dx=dx, box=[1.0, 2.0], visc=0.1, c0=15.0, pbc=[True, True],
                    force_fn=wcsph.rpf_force_fn), r, v, tag, None
    r, v, tag, box, wall = wcsph.ldc_initial_state(dx, rng, u_lid=1.0)
    return dict(dx=dx, box=box, visc=0.01, c0=10.0, pbc=[False, False], wall_mask=wall,
                free_surface=True), r, v, tag, wall


def _state_diff(a, b, box, periodic):
    """max |a - b| over positions, under the minimum image if periodic."""
    import numpy as np

    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    if periodic:
        box = np.asarray(box, np.float64)
        d = d - box * np.round(d / box)
    return float(np.abs(d).max())


def _rows_diff(idx_a, idx_b, pos, box, periodic, cutoff):
    """(pairs kept by only one search, of which off the cutoff tie): the
    rows of two dense lists compared as sets."""
    import numpy as np

    n = pos.shape[0]
    a, b = np.asarray(idx_a), np.asarray(idx_b)
    bad, off = 0, 0
    for i in np.nonzero((np.sort(np.pad(a, ((0, 0), (0, max(b.shape[1] - a.shape[1], 0))),
                                        constant_values=n), 1)
                         != np.sort(np.pad(b, ((0, 0), (0, max(a.shape[1] - b.shape[1], 0))),
                                           constant_values=n), 1)).any(1))[0]:
        only = set(a[i][a[i] < n].tolist()) ^ set(b[i][b[i] < n].tolist())
        for j in only:
            d = pos[i].astype(np.float64) - pos[j].astype(np.float64)
            if periodic:
                d = d - np.asarray(box) * np.round(d / np.asarray(box))
            bad += 1
            off += abs(np.linalg.norm(d) - cutoff) > DATAGEN_CUTOFF_TIE * cutoff
    return bad, int(off)


# kernel groups of a WCSPH substep's profile
DATAGEN_GROUPS = {"bin_": "K1 column_table", "neighbor_scan": "K2 neighbor_scan",
                  "index": "gather/scatter", "gather": "gather/scatter",
                  "scatter": "gather/scatter", "reduce": "reductions"}


def datagen_solver(sizes, device, kernels):
    """(a) ``gate_substeps`` substeps of each case family at ``sizes``: the card
    (K1 + K2) against the CPU (their plain versions) and against the cell
    list on the card, the launches of K1 and K2 per advance, ms per
    substep. Returns (ok, ms per substep by case)."""
    import math

    import numpy as np
    import torch

    from lagrangebench_torch.data_gen import wcsph

    ok, ms = True, {}
    for name in DATAGEN_CASES:
        kw, r, v, _, wall = datagen_case(name, sizes)
        steps = sizes["gate_substeps"]
        periodic = all(kw.get("pbc", [True]))
        runs, walls = {}, {}
        for label, dev, backend in (("card", device, "auto"), ("cpu", "cpu", "auto"),
                                    ("celllist", device, "celllist")):
            nl, adv, dt = wcsph.make_sph(**kw, backend=backend, device=dev)
            for kern in kernels:
                kern.launches = 0
            t0 = time.perf_counter()
            r0 = torch.as_tensor(r, dtype=torch.float32, device=dev)
            nbrs = nl.allocate(r0)
            idx0 = nbrs.idx.cpu().numpy()
            r1, v1, nbrs = adv(r0, v, nbrs, steps)
            if str(dev) != "cpu":
                torch.cuda.synchronize()
            counts = {kern.name: kern.launches for kern in kernels}
            walls[label] = time.perf_counter() - t0
            runs[label] = (idx0, r1.cpu().numpy(), v1.cpu().numpy(),
                           bool(nbrs.did_buffer_overflow), counts, adv.nl_every, nbrs)
            if label == "card":
                times = []
                for _ in range(sizes["timing_runs"]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    adv(r1, v1, nbrs, steps)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3 / steps)
                ms[name] = min(times)
                if name in ("tgv2d", "tgv3d", "rpf"):
                    profiled(lambda: adv(r1, v1, nbrs, sizes["profile"]), sizes["profile"],
                             DATAGEN_GROUPS, f"datagen {name} profile", "substep")
        idx0, rc, vc, ovf, counts, nl_every, nbrs = runs["card"]
        want = {kern.name: 0 for kern in kernels}
        rebuilds = 1 + math.ceil(steps / nl_every)
        want.update({"column_table": rebuilds, "neighbor_scan": rebuilds})
        vmax = float(np.abs(vc).max())
        diffs = {other: (_state_diff(runs[other][1], rc, kw["box"], periodic),
                         float(np.abs(runs[other][2] - vc).max()) / vmax)
                 for other in ("cpu", "celllist")}
        cutoff = 2 * 1.5 * kw["dx"] + kw.get("nl_skin_h", 0.0) * 1.5 * kw["dx"]
        pairs, off = _rows_diff(idx0, runs["celllist"][0], r.astype(np.float32), kw["box"],
                                any(kw.get("pbc", [True])), cutoff)
        walls_still = wall is None or all(
            np.array_equal(runs[k][1][wall], r.astype(np.float32)[wall]) for k in runs)
        log(f"datagen {name}: {len(r)} particles, {steps} substeps (nl_every {nl_every}, "
            f"K {nbrs.capacity}), {ms[name]:.3f} ms per substep on the card (host clock, "
            f"synchronized, min of {sizes['timing_runs']} runs); card vs CPU max |dr| "
            f"{diffs['cpu'][0]:.3g}, |dv|/max|v| {diffs['cpu'][1]:.3g}; K1 + K2 vs the cell "
            f"list |dr| {diffs['celllist'][0]:.3g}, |dv|/max|v| {diffs['celllist'][1]:.3g}, "
            f"allocation rows differ in {pairs} pairs ({off} off the cutoff tie); launches "
            f"{json.dumps({k: n for k, n in counts.items() if n})}; s wall (allocation and "
            f"one frame) {json.dumps({k: round(w, 2) for k, w in walls.items()})}")
        if counts != want:
            log(f"FAIL: datagen {name} launches, expected "
                f"{json.dumps({k: n for k, n in want.items() if n})} (1 allocation + "
                f"ceil({steps}/{nl_every}) rebuilds)")
            ok = False
        if any(d[0] > DATAGEN_TOL["r"] or d[1] > DATAGEN_TOL["v"] for d in diffs.values()):
            log(f"FAIL: datagen {name} state off by more than {DATAGEN_TOL}")
            ok = False
        if off or any(runs[k][3] for k in runs) or not walls_still:
            log(f"FAIL: datagen {name}: rows off the cutoff tie {off}, overflow "
                f"{[runs[k][3] for k in runs]}, walls still {walls_still}")
            ok = False
        if not np.isfinite(rc).all() or not np.isfinite(vc).all():
            log(f"FAIL: datagen {name}: non-finite state")
            ok = False
    return ok, ms


def datagen_physics(device):
    """(b) The JAX tests' physical checks, in float32 on ``device``, at
    their sizes: TGV decays and conserves momentum, the hydrostatic tank
    stays still, the RPF bands drive apart, the LDC lid drags the fluid,
    and walls never move."""
    import numpy as np
    import torch

    from lagrangebench_torch.data_gen import wcsph

    def run(kw, r, v, steps):
        nl, adv, _ = wcsph.make_sph(**kw, device=device)
        r0 = torch.as_tensor(r, dtype=torch.float32, device=device)
        r1, v1, nbrs = adv(r0, v, nl.allocate(r0), steps)
        return r1.cpu().numpy(), v1.cpu().numpy(), bool(nbrs.did_buffer_overflow)

    checks = {}
    r, v = wcsph.tgv_initial_state(16, np.random.default_rng(1))
    r2, v2, ovf = run(dict(dx=1 / 16, box=[1.0, 1.0]), r, v, 200)
    v0 = v.astype(np.float32).astype(np.float64)  # the solver's float32 start
    v2 = v2.astype(np.float64)
    ke0, ke = 0.5 * np.mean(np.sum(v0**2, -1)), 0.5 * np.mean(np.sum(v2**2, -1))
    mom = float(np.abs(v2.sum(0) - v0.sum(0)).max())
    checks["tgv decays"] = (0.0 < ke < ke0, f"KE {ke0:.4f} -> {ke:.4f}")
    checks["tgv momentum"] = (mom <= DATAGEN_MOMENTUM_TOL,
                              f"max |sum v - sum v0| {mom:.3g} (limit {DATAGEN_MOMENTUM_TOL})")
    checks["tgv in box"] = (bool(np.all(r2 >= 0) and np.all(r2 < 1.0)) and not ovf, "")

    dx = 0.05
    r, v, _, box, wall = wcsph.dam_initial_state(dx, np.random.default_rng(3), tank=(1.0, 1.0),
                                                 column=(1.0, 0.5), jitter=0.01)
    r2, v2, ovf = run(dict(dx=dx, box=box, visc=0.05, c0=15.0, pbc=[False, False],
                           g_ext=[0.0, -1.0], wall_mask=wall, free_surface=True), r, v, 400)
    vf, rf = np.abs(v2[~wall]).max(), r2[~wall]
    checks["tank still"] = (vf < 0.25 and not ovf, f"max fluid |v| {vf:.4f} (< 0.25)")
    checks["tank holds"] = (bool(rf[:, 0].min() > 2 * dx and rf[:, 0].max() < box[0] - 2 * dx
                                 and rf[:, 1].min() > 2 * dx), "")
    checks["tank walls"] = (np.array_equal(r2[wall], r.astype(np.float32)[wall]), "")

    r, v, _ = wcsph.rpf_initial_state(1 / 16, np.random.default_rng(0), box=[1.0, 2.0])
    r2, v2, ovf = run(dict(dx=1 / 16, box=[1.0, 2.0], visc=0.1, pbc=[True, True],
                           force_fn=wcsph.rpf_force_fn), r, v, 100)
    lower = r2[:, 1] < 1.0
    lo, hi = float(v2[lower, 0].mean()), float(v2[~lower, 0].mean())
    checks["rpf bands"] = (lo > 0.01 and hi < -0.01 and not ovf,
                           f"mean vx lower {lo:.4f}, upper {hi:.4f}")

    dx = 1 / 16
    r, v, tag, box, wall = wcsph.ldc_initial_state(dx, np.random.default_rng(0), u_lid=1.0)
    r2, v2, ovf = run(dict(dx=dx, box=box, visc=0.05, pbc=[False, False], wall_mask=wall,
                           free_surface=True), r, v, 300)
    top = (tag == 0) & (r[:, 1] > box[1] - 6 * dx)
    drag = float(v2[top, 0].mean())
    checks["ldc drags"] = (drag > 0.02 and not ovf, f"mean vx under the lid {drag:.4f}")
    checks["ldc lid and walls"] = (bool(np.all(v2[tag == 2, 0] == 1.0))
                                   and np.array_equal(r2[wall], r.astype(np.float32)[wall]), "")
    ok = True
    for label, (passed, note) in checks.items():
        log(f"datagen physics {label}: {'ok' if passed else 'FAIL'} {note}")
        ok &= bool(passed)
    return ok


def _split_datasets(per_split, metadata, cfg, force_fn=None):
    """ArrayDatasets of a converter split, windowed as the runner's
    setup_data windows the H5 splits."""
    from lagrangebench_torch.data import ArrayDataset

    isl = int(cfg.model.input_seq_length)
    steps = max(int(cfg.eval.n_rollout_steps), 1)
    extra = {"train": max(cfg.train.pushforward.unrolls), "valid": steps, "test": steps}
    return tuple(ArrayDataset(s, [p for p, _ in per_split[s]], [t for _, t in per_split[s]],
                              metadata, input_seq_length=isl, extra_seq_length=extra[s],
                              external_force_fn=force_fn)
                 for s in ("train", "valid", "test"))


def datagen_datasets(sizes, device, kernels, cfgs, tmp):
    """(c) A TGV 2D ensemble and an RPF 2D trajectory generated on the card
    (``simulate_frames``), split by the converter's array function
    (``split_trajectories``) into metadata with statistics and then into
    ArrayDatasets; the RPF force from ``RPF_FORCE_PY`` written to ``tmp``
    and loaded by the dataset loader. Returns (ok, {case: datasets},
    frames/s by case)."""
    import math

    import numpy as np
    import torch

    from lagrangebench_torch.data.dataset import _load_force_fn
    from lagrangebench_torch.data.force import apply_force
    from lagrangebench_torch.data_gen import wcsph
    from lagrangebench_torch.data_gen.jax_sph_converter import split_trajectories

    ok, out, fps = True, {}, {}
    for name in ("tgv2d", "rpf"):
        kw, r, v, tag, _ = datagen_case(name, sizes)
        nl, adv, dt = wcsph.make_sph(**kw, device=device)
        if name == "tgv2d":
            n_trajs, frames, every, warmup, split = (sizes["tgv_trajs"], sizes["tgv_frames"],
                                                     sizes["frame"], 0, "4_1_1")
        else:
            n_trajs, frames, every, warmup, split = (1, sizes["rpf_frames"], sizes["rpf_every"],
                                                     sizes["rpf_warmup"], "80_10_10")
        rng = np.random.default_rng(0)
        for kern in kernels:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trajs = []
        for i in range(n_trajs):
            if name == "tgv2d":  # one jitter realization per trajectory
                r, v = wcsph.tgv_initial_state(sizes["tgv2d"], rng)
            got, _, _ = wcsph.simulate_frames(r, v, nl, adv, frames, every, warmup,
                                              device=device, label=f"{name} {i}")
            trajs.append((got, tag))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {kern.name: kern.launches for kern in kernels}
        rebuilds = n_trajs * (1 + math.ceil(warmup / adv.nl_every)
                              + (frames - 1) * math.ceil(every / adv.nl_every))
        want = {kern.name: 0 for kern in kernels}
        want.update({"column_table": rebuilds, "neighbor_scan": rebuilds})
        substeps = n_trajs * (warmup + (frames - 1) * every)
        fps[name] = n_trajs * frames / wall
        config = wcsph.traj_config(name[:3].upper(), kw["dx"], len(kw["box"]), kw["box"],
                                   kw.get("pbc", [True] * len(kw["box"])), kw["visc"], dt,
                                   kw["c0"], every)
        per_split, meta = split_trajectories(trajs, config, split)
        force = None
        if name == "rpf":
            with open(os.path.join(tmp, "force.py"), "w") as f:
                f.write(wcsph.RPF_FORCE_PY)
            force = _load_force_fn(tmp)
            pos = torch.as_tensor(trajs[0][0][-1], device=device)
            same = torch.equal(apply_force(force, pos), apply_force(wcsph.rpf_force_fn, pos))
            log(f"datagen rpf: RPF_FORCE_PY loaded through the port's jax.numpy namespace, "
                f"applied on the card, equals rpf_force_fn: {same}")
            ok &= same
        cfg = cfgs[name]
        out[name] = _split_datasets(per_split, meta, cfg, force)
        finite = all(np.isfinite(p).all() for p, _ in trajs)
        stats_ok = all(np.isfinite(meta[k]).all() and min(meta[k]) > 0
                       for k in ("vel_std", "acc_std"))
        log(f"datagen {name} generation: {n_trajs} x {frames} frames x {every} substeps "
            f"(+{warmup} warmup) of {trajs[0][0].shape[1]} particles in {wall:.2f} s wall: "
            f"{fps[name]:.2f} frames/s, {wall * 1e3 / substeps:.3f} ms per substep; launches "
            f"{json.dumps({k: n for k, n in counts.items() if n})}; split {split}: "
            f"{[len(per_split[s]) for s in ('train', 'valid', 'test')]} trajectories, "
            f"sequence_length_train {meta['sequence_length_train']}, radius "
            f"{meta['default_connectivity_radius']}, vel_std {meta['vel_std']}, acc_std "
            f"{meta['acc_std']}")
        if counts != want or not finite or not stats_ok:
            log(f"FAIL: datagen {name} generation: launches expected "
                f"{json.dumps({k: n for k, n in want.items() if n})}, finite {finite}, "
                f"statistics positive {stats_ok}")
            ok = False
    return ok, out, fps


def datagen_gns(label, cfg, data, sizes, device):
    """(d) GNS-10-128 (fused, bf16, batch 2) through runner.train_or_infer
    with ``mode=all`` on generated data: K1 and K2 once per neighbor update,
    K3 9 plain + 1 with the encoder per forward, K4 (and its reduction) 10
    per training step (one backward per step; the pushforward does not
    unroll in these steps); finite losses and metrics; the forced case's
    model takes the force feature; then ms per rollout step of the trained
    model on the test trajectory (batch 1, finite predictions)."""
    import numpy as np
    import torch

    from lagrangebench_torch.models import setup_model

    mp = int(cfg.model.num_mp_steps)

    def expect(rec):
        return {"fused_mp": (mp - 1) * rec.forwards, "fused_mp_enc": rec.forwards,
                "fused_mp_bwd": mp * len(rec.losses), "fused_mp_bwd_reduce": mp * len(rec.losses)}

    metrics, counts, rec, ok = _runner_call(f"datagen {label} (mode=all)", cfg, data,
                                            all_kernels(), expect=expect)
    steps = int(cfg.train.step_max) + 1
    if len(rec.losses) != steps or not np.all(np.isfinite(rec.losses)):
        log(f"FAIL: datagen {label}: {len(rec.losses)} of {steps} training steps, losses "
            f"{rec.losses}")
        ok = False
    log(f"datagen {label}: losses {[round(x, 5) for x in rec.losses]}")
    forced = data[0].external_force_fn is not None
    if forced:
        model, case = rec.models[0], rec.cases[0]
        sizes_of = [sum(p.numel() for p in setup_model(cfg.model, data[0].metadata,
                                                       has_external_force=f,
                                                       device=device).parameters())
                    for f in (True, False)]
        got = sum(p.numel() for p in model.parameters())
        pos, ptype = test_batch(data[2], device, 1)
        feats, _ = case.allocate_eval((pos[0, :, :int(cfg.model.input_seq_length)], ptype[0]))
        signs = set(torch.sign(feats["force"][:, 0]).tolist()) if "force" in feats else set()
        log(f"datagen {label}: the model has {got} parameters (with the force feature "
            f"{sizes_of[0]}, without {sizes_of[1]}); force feature signs {sorted(signs)}")
        if got != sizes_of[0] or got == sizes_of[1] or signs != {-1.0, 1.0}:
            log(f"FAIL: datagen {label}: the model was not built with the force")
            ok = False
    d = np.asarray(rec.trainers[0].timer.durations) * 1e3 if rec.trainers else np.zeros(0)
    if d.size:
        log(f"datagen {label} train: ms per step (host clock, synchronized) median "
            f"{np.median(d):.2f} (all {np.round(d, 2).tolist()})")
    model = rec.models[0]
    model.eval()
    _, finite, _ = _rollout_ms(model, rec.cases[0], data[2], int(cfg.model.input_seq_length),
                               int(cfg.eval.n_rollout_steps), f"datagen {label}, trained "
                               f"GNS-{mp}-{cfg.model.latent_dim} bf16", bsz=1)
    return ok and finite, metrics, counts


def datagen_egnn_witness(sizes, device, tmp):
    """Printed, not gated: the seeded EGNN-5-128 of phase 13
    (``configs/rpf_3d/egnn.yaml``, float32, seed 0) inferred for
    ``egnn_steps`` steps on the synthetic RPF-3D-scale data of phases 2-14
    and on a TGV 3D trajectory generated here at the same scale (8,000
    particles, one trajectory): does the blow-up follow the data?"""
    import numpy as np

    from lagrangebench_torch import runner
    from lagrangebench_torch.data_gen import wcsph
    from lagrangebench_torch.data_gen.jax_sph_converter import split_trajectories

    steps = sizes["egnn_steps"]
    over = {"mode": "infer", "eval.n_rollout_steps": steps, "eval.infer.n_trajs": 1,
            "eval.infer.batch_size": 1, "eval.rollout_dir": f"{tmp}/egnn_rollouts"}
    if str(device) == "cpu":
        over["gpu"] = -1
    kw, r, v, tag, _ = datagen_case("tgv3d", sizes)
    nl, adv, dt = wcsph.make_sph(**kw, device=device)
    frames, _, _ = wcsph.simulate_frames(r, v, nl, adv, 6 + steps + 1, sizes["frame"],
                                         device=device, label="tgv3d witness")
    config = wcsph.traj_config("TGV", kw["dx"], 3, kw["box"], [True] * 3, kw["visc"], dt,
                               kw["c0"], sizes["frame"])
    # one trajectory: the same frames serve every split
    _, meta = split_trajectories([(frames, tag)] * 3, config, "1_1_1")
    for label in ("synthetic", "generated TGV 3D"):
        cfg = egnn_cfg(**over)
        if label == "synthetic":
            data = runner_data(cfg, n_particles=sizes["tgv3d"] ** 3, n_trajs=1)
        else:
            data = _split_datasets({s: [(frames, tag)] for s in ("train", "valid", "test")},
                                   meta, cfg)
        cfg.load_ckp = f"{tmp}/egnn_{label.split()[0]}"
        _seeded_checkpoint(cfg, data, device, cfg.load_ckp)
        metrics = runner.train_or_infer(cfg, data=data)
        # the data's own kinetic energy over the rollout window, as the
        # e_kin metric computes it (its mse is against this)
        m = data[2].metadata
        pos = np.asarray(data[2][0][0], np.float64)[:, 6 - 1:6 + steps]  # (N, steps+1, dim)
        box = np.asarray(m["bounds"])[:, 1] - np.asarray(m["bounds"])[:, 0]
        vel = np.diff(pos, axis=1)
        vel = vel - box * np.round(vel / box)
        e_data = np.sum((vel / (m["dt"] * m["write_every"])) ** 2, axis=(0, 2)) * m["dx"] ** 3
        log(f"datagen egnn witness, {label} ({m['num_particles_max']} particles, {steps} "
            f"steps, seeded EGNN-5-128 float32): val/e_kin (mse of the kinetic energy) "
            f"{metrics.get('val/e_kin')} against the data's kinetic energy "
            f"{np.round(e_data, 5).tolist()}; val/loss {metrics.get('val/loss')}; finite "
            f"{bool(all(np.isfinite(x) for x in metrics.values()))}")


def datagen_path(device="cuda", sizes=None):
    """Phase 15: data generation on the card. (a) the WCSPH solver at the
    reference scales against the CPU and the cell list, with K1 + K2's
    launches per advance; (b) the JAX tests' physical checks; (c) a TGV 2D
    ensemble and an RPF 2D trajectory generated on the card into
    ArrayDatasets; (d) GNS-10-128 trained and inferred on them through the
    runner. ``sizes`` defaults to DATAGEN_SIZES on the card and to
    DATAGEN_CPU_SIZES on the CPU. Returns (ok, launches by run)."""
    import torch

    t0 = time.perf_counter()
    cpu = str(device) == "cpu"
    sizes = sizes or (DATAGEN_CPU_SIZES if cpu else DATAGEN_SIZES)
    kernels = all_kernels()
    card = card_line()
    ok, ms = datagen_solver(sizes, device, kernels)
    log("datagen ms per substep (host clock, synchronized): " + json.dumps(
        {k: round(v, 4) for k, v in ms.items()}) + f" [{card}]")
    ok &= datagen_physics(device)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = {}
        for name, config, steps in (("tgv2d", TGV_GEN_CONFIG, sizes["tgv_rollout"]),
                                    ("rpf", RPF_GEN_CONFIG, sizes["rpf_rollout"])):
            over = {"mode": "all", "train.step_max": sizes["train_steps"] - 1,
                    "logging.eval_steps": sizes["train_steps"] - 1,
                    "eval.n_rollout_steps": steps, "eval.train.n_trajs": 1,
                    "eval.infer.n_trajs": 1, "eval.infer.batch_size": 1,
                    "eval.rollout_dir": f"{tmp}/{name}_rollouts",
                    "logging.ckp_dir": f"{tmp}/{name}_ckp"}
            if cpu:
                over["gpu"] = -1
            cfgs[name] = shipped_cfg(config, **over)
            if cpu:
                cfgs[name].model.latent_dim, cfgs[name].model.num_mp_steps = 16, 2
        gen_ok, data, fps = datagen_datasets(sizes, device, kernels, cfgs, tmp)
        ok &= gen_ok
        for name in ("tgv2d", "rpf"):
            run_ok, metrics, counts = datagen_gns(name, cfgs[name], data[name], sizes, device)
            ok &= run_ok
            launches[name] = {k: v for k, v in counts.items() if v}
        datagen_egnn_witness(sizes, device, tmp)
    log(f"datagen frames/s of generation: {json.dumps({k: round(v, 3) for k, v in fps.items()})}"
        f" [{card}]")
    log(f"phase 15 (data generation): {time.perf_counter() - t0:.1f} s wall [{card}]")
    if not cpu:
        torch.cuda.synchronize()
    return ok, launches


# ---------------------------------------------------------------------------
# slice 15: GNS-5-64, the fused GNS kernels at latent width 64
# ---------------------------------------------------------------------------

# GNS-5-64 (LagrangeBench's baseline table) is configs/rpf_3d/gns.yaml with
# these CLI overrides: python -m lagrangebench_torch
# config=configs/rpf_3d/gns.yaml model.num_mp_steps=5 model.latent_dim=64
GNS64 = {"model.num_mp_steps": 5, "model.latent_dim": 64}
GNS64_ROLLOUT = 20
GNS64_PUSHFORWARD = {"steps": [-1, UNROLL_FROM - 1], "unrolls": [0, 1], "probs": [0, 1]}
WIDTH = "@64"  # ends the F = 64 instances' names in the kernels line


def gns64_kernel_checks(device):
    """K3 (plain and encoder step), K4, K8 and E2 at F = 64 against their
    plain versions, bf16 and float32 (TF32 off), under phase 2's, 3's, 5's
    and 6's limits, timed beside their bounds: K3 on the inputs of one
    GNS-5-64 forward and K4 on those of one training backward (8,000
    particles in 3D, batch 2), K8 on one slot forward at batch 1, E2 on
    the probe's structure at F = 64. Rows are named ``name@64``."""
    from lagrangebench_torch.experiments import window_select as ws

    mp, f = GNS64["model.num_mp_steps"], GNS64["model.latent_dim"]
    log(f"phase 16: the fused GNS kernels at F = {f} (rows {WIDTH} in the kernels line)")
    data, metadata = make_data(N_PARTICLES, ISL + 1)
    case, model = build_case_model(metadata, device, mp_steps=mp, latent=f)
    seen, _ = capture_kernel_inputs(case, model, data)
    rows, ok = compare_kernels(seen, names=("fused_mp", "fused_mp_enc"))
    del seen, case, model

    trainer, _, _ = train_setup(device, N_PARTICLES, mp_steps=mp, latent=f)
    sets, _ = capture_bwd_inputs(trainer, mp_steps=mp)
    row, passed = compare_bwd(sets)
    rows[row["name"]] = row
    ok &= passed
    del sets, trainer

    seen, _, _ = capture_slot_inputs(device, **GNS64)
    slot_rows, passed = compare_slot_kernels(seen, names=("fused_mp_slot", "fused_mp_slot_enc"))
    rows.update(slot_rows)
    ok &= passed
    del seen

    row, passed = compare_window(ws.build_structure(ws.N, ws.DIM, ws.K, ws.CUTOFF, ws.T,
                                                    ws.SUB), device, f=f)
    rows[row["name"]] = row
    return {name + WIDTH: dict(r, name=name + WIDTH) for name, r in rows.items()}, ok & passed


def gns64_path(device):
    """Slice 15 ("phase 16"): the F = 64 kernel gates, then GNS-5-64 (bf16,
    fused, dense, backend auto) through runner.train_or_infer: mode=all, 12
    training steps at batch 2 with one pushforward unroll from step 4 and a
    20-step infer (mse, e_kin, Sinkhorn), the counters zeroed around it: K1
    and K2 once per neighbor update, K3 4 + 1 per forward, K4 and its
    reduction 5 per training step; finite losses and metrics, ms per train
    and rollout step and a rollout profile; then mode=infer in the slot
    layout at batch 1 from its checkpoint (K8 4 + 1 per forward) and
    ``window_select.main --latent 64`` (E2), for the F = 64 instances'
    launches; and a 3-step float32 GNS-5-64 training run on the card held
    against the CPU."""
    import numpy as np

    from lagrangebench_torch.config import Config, merge
    from lagrangebench_torch.experiments import window_select
    from lagrangebench_torch.ops import fused_mp

    t_phase = time.perf_counter()
    rows, ok = gns64_kernel_checks(device)
    mp, f = GNS64["model.num_mp_steps"], GNS64["model.latent_dim"]
    label = f"GNS-{mp}-{f}"
    step_ms = {}

    def expect(rec):
        steps = len(rec.losses)
        return {"fused_mp": (mp - 1) * rec.forwards, "fused_mp_enc": rec.forwards,
                "fused_mp_bwd": mp * steps, "fused_mp_bwd_reduce": mp * steps}

    with tempfile.TemporaryDirectory() as tmp:
        common = {"eval.n_rollout_steps": GNS64_ROLLOUT, "eval.infer.n_trajs": BATCH,
                  "eval.train.n_trajs": 1, "eval.rollout_dir": f"{tmp}/rollouts",
                  "logging.ckp_dir": f"{tmp}/ckp", "logging.log_steps": 1,
                  "logging.eval_steps": TRAIN_STEPS - 1, **GNS64}
        if str(device) == "cpu":  # a rehearsal on the CPU; the card is the runner's default
            common["gpu"] = -1
        cfg = gns_cfg(mode="all", **{"train.step_max": TRAIN_STEPS - 1}, **common)
        cfg = merge(cfg, Config({"train": {"pushforward": GNS64_PUSHFORWARD}}))
        data = runner_data(cfg)
        _, counts, rec, passed = _runner_call(f"{label} (mode=all)", cfg, data, all_kernels(),
                                              expect=expect)
        ok &= passed
        want_unrolls = [int(i >= UNROLL_FROM) for i in range(TRAIN_STEPS)]
        log(f"{label}: losses {[round(x, 5) for x in rec.losses]}, unrolls {rec.unrolls}")
        if (rec.unrolls != want_unrolls or not np.all(np.isfinite(rec.losses))):
            log(f"FAIL: {label} training steps (unrolls {want_unrolls} expected, finite losses)")
            ok = False
        for name in ("fused_mp", "fused_mp_enc", "fused_mp_bwd"):
            rows[name + WIDTH]["launches"] = counts[name]
        d = np.asarray(rec.trainers[0].timer.durations) * 1e3  # d[i]: step i + 1
        if len(d) >= TRAIN_STEPS - 1:
            step_ms[f"{label} train (unroll steps 5-11 median)"] = float(np.median(d[UNROLL_FROM:]))
            step_ms[f"{label} train (steps 1-3 median)"] = float(np.median(d[:3]))
            log(f"{label} train: ms per step (host clock, synchronized): unroll steps 5-11 "
                f"median {np.median(d[UNROLL_FROM:]):.2f} (all "
                f"{np.round(d[UNROLL_FROM:], 2).tolist()}), steps 1-3 median "
                f"{np.median(d[:3]):.2f} (all {np.round(d[:3], 2).tolist()}) [batch "
                f"{cfg.train.batch_size} x {N_PARTICLES} particles, {label} bf16]")
        model, case = rec.models[0], rec.cases[0]
        model.eval()
        isl = int(cfg.model.input_seq_length)
        times, finite, (pos, ptype, nbrs) = _rollout_ms(model, case, data[2], isl,
                                                        GNS64_ROLLOUT, f"{label} bf16")
        ok &= finite
        step_ms[f"{label} rollout"] = min(times)
        profile_steps(model, case, pos, ptype, nbrs, steps=3, isl=isl,
                      label=f"{label} rollout profile")
        del model, case, rec

        # the slot layout at batch 1 from that checkpoint: K8 at F = 64
        (run,) = os.listdir(f"{tmp}/ckp")
        cfg_a = gns_cfg(mode="infer", load_ckp=f"{tmp}/ckp/{run}",
                        **{"neighbors.format": "slot", "eval.infer.batch_size": 1}, **common)

        def expect_slot(rec):
            updates = rec.forwards + rec.allocations
            return {"neighbor_scan": 0, "slot_scan": updates,
                    "fused_mp_slot": (mp - 1) * rec.forwards, "fused_mp_slot_enc": rec.forwards}

        _, counts_a, _, passed = _runner_call(f"{label} (mode=infer, slot, batch 1)", cfg_a,
                                              data, all_kernels(), expect=expect_slot)
        ok &= passed
        rows["fused_mp_slot" + WIDTH]["launches"] = counts_a["fused_mp_slot"]
        rows["fused_mp_slot_enc" + WIDTH]["launches"] = counts_a["fused_mp_slot_enc"]

    # E2 at F = 64: the probe's main at that width
    fused_mp.FUSED_MP_WINDOW.launches = 0
    ws = window_select.main(["--latent", str(f)], device=device)
    want_e2 = ws["loops"] * ws["steps"] + ws["check_launches"]
    got_e2 = fused_mp.FUSED_MP_WINDOW.launches
    log(f"window_select --latent {f}: launches {got_e2} (expected {want_e2}); ms per MP step "
        f"(b) hs[ext_idx] + E2 {ws['window_ms']:.4f}, (a) hs[senders] + K3 "
        f"{ws['gather_ms']:.4f}; max |E2 - plain| {ws['max_abs_err']}")
    if got_e2 != want_e2 or ws["max_abs_err"] > K3_TOL["bfloat16"]:
        log(f"FAIL: window_select --latent {f} (launches or its check)")
        ok = False
    rows["fused_mp_window" + WIDTH]["launches"] = got_e2

    ok &= train_reference_check(device, mp_steps=mp, latent=f)
    log(f"phase 16 ({label}): {time.perf_counter() - t_phase:.1f} s wall")
    return rows, ok, step_ms


# ---------------------------------------------------------------------------
# slice 16: every latent width (GNS-10-256, GNS-10-96, PaiNN-5-64)
# ---------------------------------------------------------------------------

# configs/rpf_3d/gns.yaml and configs/rpf_3d/painn.yaml with these CLI
# overrides, at full depth: python -m lagrangebench_torch
# config=configs/rpf_3d/gns.yaml model.latent_dim=256 (or 96)
GNS256, GNS96, PAINN64 = ({"model.latent_dim": 256}, {"model.latent_dim": 96},
                          {"model.latent_dim": 64})
WIDTH_F = (32, 96, 100, 192, 256)  # the fused GNS kernels' gate widths
# the CUDA kernels behind each fused GNS wrapper in the bf16 stream design (F
# = 192, 256; csrc/mp_stream.cuh), named in the kernels line's rows at 256
STREAM_KERNELS = {
    "fused_mp": ("fused_mp_edge_stream", "fused_mp_node_stream"),
    "fused_mp_enc": ("fused_mp_edge_stream", "fused_mp_node_stream"),
    "fused_mp_slot": ("fused_mp_edge_stream", "fused_mp_node_stream"),
    "fused_mp_slot_enc": ("fused_mp_edge_stream", "fused_mp_node_stream"),
    "fused_mp_window": ("fused_mp_edge_stream", "fused_mp_node_stream"),
    "fused_mp_bwd": ("fused_mp_bwd_agg_stream", "fused_mp_bwd_node_stream",
                     "fused_mp_bwd_edge_stream", "fused_mp_bwd_tn", "fused_mp_bwd_reduce"),
}
WIDTH_H = (32, 64, 100, 256)  # K5's and K6's gate widths
WIDTH_R = (8, 20, 32)  # K5's gate basis widths
W_TRAIN_STEPS, W_ROLLOUT, W_CAPTURE_STEPS = 10, 20, 3
W_GATE_PARTICLES = 2000  # the K5/K6 gates' particles per sample (3D; 2D the nearest square)


def _unpad(args, width, latent):
    """Captured step arguments at the kernels' instance width cut back to
    the true width: the floating tensors' last axis, the parameters' every
    axis of that width; the ``latent`` argument dropped."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    def cut(x):
        if isinstance(x, dict):
            return {k: fused_mp._sliced(v, tuple(latent if d == width else d for d in v.shape))
                    .contiguous() for k, v in x.items()}
        if isinstance(x, torch.Tensor) and x.is_floating_point() and x.shape[-1] == width:
            return x[..., :latent].contiguous()
        return x

    return tuple(cut(x) for x in args if not isinstance(x, int) or isinstance(x, bool))


def width_step_inputs(device, f, n_particles=None):
    """K3's (plain and encoder step) and K4's inputs from one bf16 training
    step of a GNS-3-F on the phase's data (``n_particles``, N_PARTICLES
    unless given, in 3D, batch 2), as the model hands them to the kernels: at the kernels' width,
    with the true width ``latent`` where F is not one. Run on the plain
    versions."""
    import torch

    from lagrangebench_torch.ops import fused_mp

    trainer, _, _ = train_setup(device, n_particles or N_PARTICLES, mp_steps=W_CAPTURE_STEPS,
                                latent=f)
    fwd, bwd = {}, []
    real = fused_mp.gns_mp_step, fused_mp.gns_mp_step_bwd

    def clone(args, kw):  # the true width ``latent``, where padded, last
        args = args + (kw["latent"],) if kw else args
        return tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args)

    def rec_fwd(*args, **kw):
        fwd.setdefault("fused_mp_enc" if args[6] is not None else "fused_mp", clone(args, kw))
        return fused_mp.gns_mp_step_plain(*args, **kw)

    def rec_bwd(*args, **kw):
        bwd.append(clone(args, kw))
        return fused_mp.gns_mp_step_bwd_plain(*args, **kw)

    pos, ptype = next(iter(trainer.loader_train))
    raw = trainer._batch((pos, ptype))
    _, _, nbrs = trainer.case.allocate(trainer.generator, (pos[0], ptype[0]))
    fused_mp.gns_mp_step, fused_mp.gns_mp_step_bwd = rec_fwd, rec_bwd
    try:
        trainer.train_step(raw, nbrs.broadcast(BATCH), 3e-4, 0)
    finally:
        fused_mp.gns_mp_step, fused_mp.gns_mp_step_bwd = real
    torch.cuda.synchronize()
    return fwd, {"plain step": bwd[1], "encoder step": bwd[-1]}


def width_gns_checks(device, f, rows, main_widths, phase="phase 17", n_particles=None):
    """K3 (plain and encoder step), K4, K8 (plain and encoder step) and E2
    at latent width f against their plain versions under phases 2's, 3's,
    5's and 6's limits (bf16, and float32 with TF32 off; K4's weight
    gradients bit-identical over two launches), on inputs captured from the
    models (E2 on the probe's structure), through the wrappers at the true
    width (padding, kernel, slicing where f is not an instance width).
    Timed as the models launch them (at the instance width) beside the
    bound of the true width's work; rows named ``name@f`` for the widths
    of ``main_widths`` (a main path of the phase launches them). K3, K4 and
    K8's inputs come from models on ``n_particles`` per sample (N_PARTICLES
    unless given)."""
    import torch

    from lagrangebench_torch.experiments import window_select as ws
    from lagrangebench_torch.ops import fused_mp

    width = fused_mp.kernel_width(f)
    design = fused_mp._design(torch.bfloat16, width)
    log(f"{phase}: the fused GNS kernels at F = {f} (width {width}, bf16 {design} design)")
    fwd, bwd = width_step_inputs(device, f, n_particles)
    seen = {name: (_unpad(args, width, f)[:7], {}) for name, args in fwd.items()}
    got_rows, ok = compare_kernels(seen, names=("fused_mp", "fused_mp_enc"))
    for name, args in fwd.items():  # the launch the model makes: no padding copy
        ms = cuda_time(lambda: fused_mp.gns_mp_step(*args))
        log(f"{name} at F = {f} as the model launches it: {ms:.4f} ms")
        got_rows[name]["ms"] = ms
    del seen
    row, passed = compare_bwd({k: _unpad(v, width, f) for k, v in bwd.items()},
                              tie_rule=f in BF16_TIE_WIDTHS)
    ok &= passed
    args = bwd["plain step"]
    kp = fused_mp.kernel_params(args[5], torch.bfloat16)
    row["ms"] = cuda_time(lambda: fused_mp.gns_mp_step_bwd(*args[:5], kp, *args[6:]))
    log(f"fused_mp_bwd at F = {f} as the model launches it: {row['ms']:.4f} ms")
    got_rows["fused_mp_bwd"] = row
    del fwd, bwd, args

    seen, _, _ = capture_slot_inputs(device, n_particles, **{
        "model.num_mp_steps": W_CAPTURE_STEPS, "model.latent_dim": f})
    seen = {name: (_unpad(args, width, f), {}) for name, (args, _) in seen.items()
            if name.startswith("fused_mp_slot")}
    slot_rows, passed = compare_slot_kernels(seen, names=("fused_mp_slot", "fused_mp_slot_enc"))
    got_rows.update(slot_rows)
    ok &= passed
    del seen
    row, passed = compare_window(ws.build_structure(ws.N, ws.DIM, ws.K, ws.CUTOFF, ws.T,
                                                    ws.SUB), device, f=f)
    got_rows[row["name"]] = row
    ok &= passed
    if f in main_widths:
        for name, r in got_rows.items():
            rows[f"{name}@{f}"] = dict(r, name=f"{name}@{f}")
            if design in ("stream", "wgmma", "wide"):  # the CUDA kernels behind the wrapper
                kernels = {"stream": STREAM_KERNELS, "wgmma": WGMMA_KERNELS,
                           "wide": WIDE_KERNELS}[design]
                rows[f"{name}@{f}"]["cuda_kernels"] = list(kernels[name])
    return ok


def width_painn_inputs(device, h, r, dim, n_particles):
    """K6's and K5's inputs from one float32 forward of a one-layer PaiNN
    (standard and fused, the fused one carrying the standard one's weights)
    at hidden width h and basis width r, on synthetic data in ``dim``
    dimensions at batch 2; run on the plain versions."""
    import numpy as np
    import torch

    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.data.synthetic import make_synthetic_arrays
    from lagrangebench_torch.models import PaiNN
    from lagrangebench_torch.ops import painn_msg

    isl = int(painn_cfg().model.input_seq_length)
    side = round(n_particles ** (1 / dim))
    splits, metadata = make_synthetic_arrays(
        n_particles=side ** dim, dim=dim, box=BOX, dx=BOX / side, seq_len_train=12,
        seq_len_eval=isl + 1, n_trajs=BATCH, name="RPF")
    pos = np.stack([t.transpose(1, 0, 2)[:, :isl] for t in splits["test"]])
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    ptype = torch.zeros(pos.shape[:2], dtype=torch.int64, device=device)
    case = case_builder([BOX] * dim, metadata, isl, cfg_neighbors={"backend": "auto"},
                        cfg_model={"isotropic_norm": True, "magnitude_features": True},
                        device=device)
    radius = 1.5 * float(metadata["default_connectivity_radius"])
    std = PaiNN(h, 1, r, radius, isl - 1, fused=False, device=device)
    fused = PaiNN(h, 1, r, radius, isl - 1, fused=True, device=device)
    fused.load_jax_params(std.jax_params())
    _, nbrs = case.allocate_eval((pos[0], ptype[0]))
    seen = {}
    real = painn_msg.painn_message, painn_msg.painn_layer

    def rec_msg(g, wij, nd, hh):
        seen.setdefault("painn_msg", (g.clone(), wij.clone(), nd.clone(), hh))
        return painn_msg.painn_message_plain(g, wij, nd, hh)

    def rec_layer(packed, sidx, phi, nd, s, v, p):
        kp = painn_msg.layer_kernel_params(p, s.dtype)
        seen.setdefault("painn_layer",
                        tuple(t.clone() for t in (packed, sidx, phi, nd, s, v)) + (kp,))
        return painn_msg.painn_layer_plain(packed, sidx, phi, nd, s, v, p)

    painn_msg.painn_message, painn_msg.painn_layer = rec_msg, rec_layer
    try:
        with torch.no_grad():
            feats, _ = case.preprocess_eval_batched((pos, ptype), nbrs.broadcast(BATCH))
            std(feats, ptype.reshape(-1))
            fused(feats, ptype.reshape(-1))
    finally:
        painn_msg.painn_message, painn_msg.painn_layer = real
    return seen


def width_painn_checks(device):
    """K6 at H in WIDTH_H and K5 at H x R in WIDTH_H x WIDTH_R, in 2D and 3D,
    against their plain versions under phase 3's limits (float32 with TF32
    off 1e-4 of the largest magnitude; bf16 relative 2-norm: K6 1e-5, K5
    1e-4), on inputs of one-layer PaiNNs at those widths (2,000 particles
    per sample, batch 2); not timed (PaiNN-5-64's instance is timed on its
    own inputs in ``width_path``)."""
    ok = True
    for dim in (2, 3):
        for h in WIDTH_H:
            for r in WIDTH_R:
                seen = width_painn_inputs(device, h, r, dim, W_GATE_PARTICLES)
                names = ("painn_layer",) if r != WIDTH_R[0] else ("painn_msg", "painn_layer")
                log(f"phase 17: K6/K5 gates at H = {h}, R = {r}, dim {dim}")
                _, passed = compare_painn_kernels(seen, names, timed=False)
                ok &= passed
    return ok


def width_reference_check(device, widths, hidden, train_latent=96, adam_ties=False):
    """float32 card against CPU (TF32 off) at the phase's widths: GNS-2-F
    for F in ``widths``, phase 7's 3-step rollout of 1,000 particles
    (positions 1e-5), and 3 training steps at F = ``train_latent`` (losses
    1e-5 relative, parameters 1e-5, Adam ties apart with ``adam_ties``:
    ``train_reference_check``); PaiNN-2-``hidden``, both layouts, one
    forward of 1,000 particles at batch 2 (acc 1e-5 of its largest
    magnitude: a rollout of the seeded PaiNN-2-64 moves particles across
    the cutoff within 3 steps, so that the two sides' neighbor lists part)."""
    import numpy as np
    import torch

    ok = True
    for f in widths:
        ok &= reference_check(device, latent=f)
    ok &= train_reference_check(device, mp_steps=2, latent=train_latent, adam_ties=adam_ties)
    for fused in (False, True):
        cfg = painn_cfg(**{"model.num_mp_steps": 2, "model.fused_processor": fused,
                           "model.latent_dim": hidden})
        _, _, test = runner_data(cfg, n_particles=1000)
        isl = int(cfg.model.input_seq_length)
        accs = []
        for dev in (device, "cpu"):
            case, model = painn_case_model(cfg, test.metadata, dev)
            pos, ptype = test_batch(test, case.device, BATCH)
            _, nbrs = case.allocate_eval((pos[0, :, :isl], ptype[0]))
            with torch.no_grad():
                feats, _ = case.preprocess_eval_batched((pos[:, :, :isl], ptype),
                                                        nbrs.broadcast(BATCH))
                accs.append(model(feats, ptype.reshape(-1))["acc"].cpu())
        err = float((accs[0] - accs[1]).abs().max() / accs[1].abs().max())
        passed = bool(np.isfinite(err)) and err <= 1e-5
        ok &= passed
        log(f"painn reference (PaiNN-2-{hidden}, {'fused' if fused else 'standard'}): one "
            f"forward, max |cuda - cpu| acc {err:.3g} of the largest (tol 1e-5)"
            f"{'' if passed else '  FAIL'}")
    return ok


def width_path(device):
    """Slice 16 ("phase 17"): every fused GNS kernel at F in WIDTH_F and
    K5/K6 at H in WIDTH_H (x R in WIDTH_R) against their plain versions;
    then through runner.train_or_infer (``width_runs``): GNS-10-256 (bf16,
    fused, dense) mode=all and a slot infer, GNS-10-96 mode=all, PaiNN-5-64
    standard mode=all and fused mode=infer, window_select --latent 96 and
    256 (E2); and float32 card-vs-CPU checks (``width_reference_check``)."""
    t_phase = time.perf_counter()
    rows, ok, step_ms = {}, True, {}
    mains = (GNS256["model.latent_dim"], GNS96["model.latent_dim"])
    if str(device) != "cpu":  # the stream design's registers and spills (F = 192, 256)
        from lagrangebench_torch.ops import build

        log("phase 17: the bf16 stream design's kernels (F = 192 and 256)")
        ptxas_report(build, ("fused_mp", "fused_mp_bwd"),
                     only={k for ks in STREAM_KERNELS.values() for k in ks})
    for f in WIDTH_F:
        ok &= width_gns_checks(device, f, rows, mains)
    ok &= width_painn_checks(device)
    log(f"phase 17 kernel gates: {time.perf_counter() - t_phase:.1f} s wall")
    ok &= width_runs(device, "phase 17", (GNS256, GNS96), PAINN64, rows, step_ms)
    ok &= width_reference_check(device, mains, PAINN64["model.latent_dim"])
    log(f"phase 17 (every latent width): {time.perf_counter() - t_phase:.1f} s wall "
        f"[{card_line()}]")
    return rows, ok, step_ms


def width_runs(device, phase, gns_overs, painn_over, rows, step_ms):
    """The runs of a width phase through ``runner.train_or_infer``, each with
    the counters zeroed around it: for each of ``gns_overs`` (latent widths
    over the shipped ``configs/rpf_3d/gns.yaml``: bf16, fused, dense)
    mode=all, 10 training steps at batch 2 with one pushforward unroll from
    step 4 and a 20-step infer, and for the first of them mode=infer in the
    slot layout at batch 1 from its checkpoint (K8); ``painn_over`` (over
    ``configs/rpf_3d/painn.yaml``) standard mode=all and fused mode=infer
    from its checkpoint, K6 and K5 gated and timed on its own inputs;
    window_select at each GNS width (E2). Finite losses and metrics, launch
    counts (K1 and K2 once per neighbor update, K3 9 + 1 per forward, K4
    and its reduction 10 per training step, K6 and K5 5 per forward), ms per
    train and rollout step into ``step_ms``; the launches into the rows
    ``name@F`` of ``rows``, which the width's gates made."""
    import numpy as np

    from lagrangebench_torch.config import Config, merge
    from lagrangebench_torch.experiments import window_select
    from lagrangebench_torch.ops import fused_mp

    ok = True
    mains = tuple(over["model.latent_dim"] for over in gns_overs)
    mp = int(GNS_CONFIG["model"]["num_mp_steps"])
    with tempfile.TemporaryDirectory() as tmp:
        common = {"eval.n_rollout_steps": W_ROLLOUT, "eval.infer.n_trajs": BATCH,
                  "eval.train.n_trajs": 1, "logging.log_steps": 1,
                  "logging.eval_steps": W_TRAIN_STEPS - 1}
        if str(device) == "cpu":  # a rehearsal on the CPU; the card is the runner's default
            common["gpu"] = -1
        for over in gns_overs:
            f = over["model.latent_dim"]
            label = f"GNS-{mp}-{f}"
            run = {**common, "eval.rollout_dir": f"{tmp}/rollouts{f}",
                   "logging.ckp_dir": f"{tmp}/ckp{f}", **over}

            def expect(rec):
                steps = len(rec.losses)
                return {"fused_mp": (mp - 1) * rec.forwards, "fused_mp_enc": rec.forwards,
                        "fused_mp_bwd": mp * steps, "fused_mp_bwd_reduce": mp * steps}

            cfg = gns_cfg(mode="all", **{"train.step_max": W_TRAIN_STEPS - 1}, **run)
            cfg = merge(cfg, Config({"train": {"pushforward": GNS64_PUSHFORWARD}}))
            data = runner_data(cfg)
            t_run = time.perf_counter()
            _, counts, rec, passed = _runner_call(f"{label} (mode=all)", cfg, data,
                                                  all_kernels(), expect=expect)
            ok &= passed
            want_unrolls = [int(i >= UNROLL_FROM) for i in range(W_TRAIN_STEPS)]
            log(f"{label}: losses {[round(x, 5) for x in rec.losses]}, unrolls {rec.unrolls}")
            if rec.unrolls != want_unrolls or not np.all(np.isfinite(rec.losses)):
                log(f"FAIL: {label} training steps (unrolls {want_unrolls} expected, finite "
                    f"losses)")
                ok = False
            for name in ("fused_mp", "fused_mp_enc", "fused_mp_bwd"):
                rows[f"{name}@{f}"]["launches"] = counts[name]
            d = np.asarray(rec.trainers[0].timer.durations) * 1e3  # d[i]: step i + 1
            if len(d) >= W_TRAIN_STEPS - 1:
                step_ms[f"{label} train (unroll steps 5-{W_TRAIN_STEPS - 1} median)"] = float(
                    np.median(d[UNROLL_FROM:]))
                step_ms[f"{label} train (steps 1-3 median)"] = float(np.median(d[:3]))
                log(f"{label} train: ms per step (host clock, synchronized): unroll steps "
                    f"median {np.median(d[UNROLL_FROM:]):.2f} (all "
                    f"{np.round(d[UNROLL_FROM:], 2).tolist()}), steps 1-3 median "
                    f"{np.median(d[:3]):.2f} (all {np.round(d[:3], 2).tolist()}) [batch "
                    f"{cfg.train.batch_size} x {N_PARTICLES} particles, {label} bf16]")
            model, case = rec.models[0], rec.cases[0]
            model.eval()
            isl = int(cfg.model.input_seq_length)
            cuda = str(device) != "cpu"
            if cuda:
                import torch

                torch.cuda.reset_peak_memory_stats()
            times, finite, _ = _rollout_ms(model, case, data[2], isl, W_ROLLOUT, f"{label} bf16")
            if cuda:
                log(f"{label} rollout: peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (the run's weights and "
                    f"data included)")
            ok &= finite
            step_ms[f"{label} rollout"] = min(times)
            del model, case, rec
            log(f"{label} (mode=all and its rollout timing): {time.perf_counter() - t_run:.1f} "
                f"s wall")
            if f != mains[0]:
                continue
            # the slot layout at batch 1 from that checkpoint: K8 at this width
            (run_dir,) = os.listdir(f"{tmp}/ckp{f}")
            cfg_a = gns_cfg(mode="infer", load_ckp=f"{tmp}/ckp{f}/{run_dir}",
                            **{"neighbors.format": "slot", "eval.infer.batch_size": 1}, **run)

            def expect_slot(rec):
                updates = rec.forwards + rec.allocations
                return {"neighbor_scan": 0, "slot_scan": updates,
                        "fused_mp_slot": (mp - 1) * rec.forwards,
                        "fused_mp_slot_enc": rec.forwards}

            _, counts_a, _, passed = _runner_call(f"{label} (mode=infer, slot, batch 1)", cfg_a,
                                                  data, all_kernels(), expect=expect_slot)
            ok &= passed
            for name in ("fused_mp_slot", "fused_mp_slot_enc"):
                rows[f"{name}@{f}"]["launches"] = counts_a[name]
        for f in mains[1:]:  # the other GNS widths run no slot path
            for name in ("fused_mp_slot", "fused_mp_slot_enc"):
                rows.pop(f"{name}@{f}", None)

        # PaiNN-5-H: the standard layout (K6) mode=all, the fused (K5) mode=infer
        h = painn_over["model.latent_dim"]
        layers = int(PAINN_CONFIG["model"]["num_mp_steps"])
        label = f"PaiNN-{layers}-{h}"
        run = {**common, "eval.rollout_dir": f"{tmp}/rollouts_painn",
               "logging.ckp_dir": f"{tmp}/ckp_painn", **painn_over}
        cfg = painn_cfg(mode="all", **{"train.step_max": W_TRAIN_STEPS - 1}, **run)
        data = runner_data(cfg)
        seen = width_painn_inputs(device, h, 20, DIM, N_PARTICLES)
        painn_rows, passed = compare_painn_kernels(seen)
        ok &= passed
        del seen
        _, counts, rec, passed = _runner_call(
            f"{label} standard (mode=all)", cfg, data, all_kernels(),
            expect=lambda rec: {"painn_msg": layers * rec.forwards})
        ok &= passed
        if len(rec.losses) != W_TRAIN_STEPS or not np.all(np.isfinite(rec.losses)):
            log(f"FAIL: {label} standard training steps (finite losses)")
            ok = False
        log(f"{label} standard: losses {[round(x, 5) for x in rec.losses]}")
        d = np.asarray(rec.trainers[0].timer.durations) * 1e3
        step_ms[f"{label} standard train (median)"] = float(np.median(d))
        model, case = rec.models[0], rec.cases[0]
        model.eval()
        isl = int(cfg.model.input_seq_length)
        times, finite, _ = _rollout_ms(model, case, data[2], isl, W_ROLLOUT,
                                       f"{label} standard float32")
        ok &= finite
        step_ms[f"{label} standard rollout"] = min(times)
        painn_rows["painn_msg"]["launches"] = counts["painn_msg"]
        del model, case, rec
        (run_dir,) = os.listdir(f"{tmp}/ckp_painn")
        cfg_f = painn_cfg(mode="infer", load_ckp=f"{tmp}/ckp_painn/{run_dir}",
                          **{"model.fused_processor": True}, **run)
        _, counts_f, rec, passed = _runner_call(
            f"{label} fused (mode=infer)", cfg_f, data, all_kernels(),
            expect=lambda rec: {"painn_layer": layers * rec.forwards})
        ok &= passed
        painn_rows["painn_layer"]["launches"] = counts_f["painn_layer"]
        model, case = rec.models[0], rec.cases[0]
        times, finite, _ = _rollout_ms(model, case, data[2], isl, W_ROLLOUT,
                                       f"{label} fused float32")
        ok &= finite
        step_ms[f"{label} fused rollout"] = min(times)
        del model, case, rec
        rows.update({f"{name}@{h}": dict(r, name=f"{name}@{h}") for name, r in painn_rows.items()})

    # E2 at the GNS widths: the probe's main at those widths
    for f in mains:
        fused_mp.FUSED_MP_WINDOW.launches = 0
        ws = window_select.main(["--latent", str(f)], device=device)
        want_e2 = ws["loops"] * ws["steps"] + ws["check_launches"]
        got_e2 = fused_mp.FUSED_MP_WINDOW.launches
        log(f"window_select --latent {f}: launches {got_e2} (expected {want_e2}); ms per MP "
            f"step (b) hs[ext_idx] + E2 {ws['window_ms']:.4f}, (a) hs[senders] + K3 "
            f"{ws['gather_ms']:.4f}; max |E2 - plain| {ws['max_abs_err']}")
        if got_e2 != want_e2 or ws["max_abs_err"] > K3_TOL["bfloat16"]:
            log(f"FAIL: window_select --latent {f} (launches or its check)")
            ok = False
        rows[f"fused_mp_window@{f}"]["launches"] = got_e2
    log(f"{phase} runs: {', '.join(f'GNS-{mp}-{f}' for f in mains)}, PaiNN-{layers}-{h}, E2")
    return ok


# ---------------------------------------------------------------------------
# slice 18 ("phase 18"): the fused GNS kernels past F = 256, K5 past H = 256
# and R = 64
# ---------------------------------------------------------------------------

WIDE_F = (257, 320, 384, 512, 768, 1024)  # the wide path's gate widths
# from F = 768 on the gates' models run on 4,000 particles a sample (not
# 8,000): K4's float64 references (node_first64, the tie checks) hold
# several (N, K, F) float64 tensors, 5.2 GB each at 16,000 x 40 x 1,024
WIDE_SMALL_FROM, WIDE_SMALL_PARTICLES = 768, 4000
WIDE_H, WIDE_R = (320, 512, 1024), (20, 96, 128)  # K5's gate widths
# K5's tensor-core design (H > 256 or R > 64): its kernels, named in the
# kernels line's K5 row at H = 512, and their identifiers in ptxas's report
K5_TC_KERNELS = ("painn_edge_tc", "painn_node_tc<kVmix>", "painn_node_tc<kMix1>",
                 "painn_node_tc<kOut>")
K5_TC_IDENTS = ("painn_edge_tc", "painn_node_tc")
GNS512, PAINN512 = {"model.latent_dim": 512}, {"model.latent_dim": 512}
# the CUDA kernels behind each fused GNS wrapper on the wide path: in bf16
# at F = 512 the wgmma design (csrc/mp_wgmma.cuh: the edge side in one kernel,
# the agg sum, the node side on the wide path's launches; K4's edge side in
# one kernel and dW_e, dW2 in a wgmma product kernel, csrc/mp_wgmma_bwd.cuh),
# named in the kernels line's rows at F = 512; past 512 and in float32 the
# wide path's own (csrc/mp_wide.cuh)
_WGMMA_NODE = ("fused_mp_wide_gemm", "fused_mp_wide_ln")
WGMMA_KERNELS = {
    "fused_mp": ("fused_mp_edge_wgmma", "fused_mp_wide_agg") + _WGMMA_NODE,
    "fused_mp_enc": ("fused_mp_edge_wgmma", "fused_mp_wide_agg") + _WGMMA_NODE,
    "fused_mp_slot": ("fused_mp_wide_senders", "fused_mp_edge_wgmma", "fused_mp_wide_agg")
    + _WGMMA_NODE,
    "fused_mp_slot_enc": ("fused_mp_wide_senders", "fused_mp_edge_wgmma", "fused_mp_wide_agg")
    + _WGMMA_NODE,
    "fused_mp_window": ("fused_mp_wide_senders", "fused_mp_edge_wgmma", "fused_mp_wide_agg")
    + _WGMMA_NODE,
    "fused_mp_bwd": ("fused_mp_edge_wgmma", "fused_mp_wide_agg", "fused_mp_wide_gemm",
                     "fused_mp_bwd_wide_node", "fused_mp_bwd_wide_post", "fused_mp_bwd_edge_wgmma",
                     "fused_mp_bwd_tn_wgmma", "fused_mp_bwd_wide_reduce"),
}
WIDE_KERNELS = {
    "fused_mp": ("fused_mp_wide_gemm", "fused_mp_wide_edge_ln", "fused_mp_wide_ln"),
    "fused_mp_enc": ("fused_mp_wide_enc_first", "fused_mp_wide_gemm", "fused_mp_wide_ln",
                     "fused_mp_wide_edge_ln"),
    "fused_mp_slot": ("fused_mp_wide_senders", "fused_mp_wide_gemm", "fused_mp_wide_edge_ln",
                      "fused_mp_wide_ln"),
    "fused_mp_slot_enc": ("fused_mp_wide_senders", "fused_mp_wide_enc_first",
                          "fused_mp_wide_gemm", "fused_mp_wide_ln", "fused_mp_wide_edge_ln"),
    "fused_mp_window": ("fused_mp_wide_senders", "fused_mp_wide_gemm", "fused_mp_wide_edge_ln",
                        "fused_mp_wide_ln"),
    "fused_mp_bwd": ("fused_mp_wide_gemm", "fused_mp_wide_edge_ln", "fused_mp_bwd_wide_node",
                     "fused_mp_bwd_wide_post", "fused_mp_bwd_wide_edge",
                     "fused_mp_bwd_wide_reduce"),
}


def wide_painn_checks(device):
    """K5's tensor-core design at H in WIDE_H x R in WIDE_R, in 2D and 3D,
    against its plain version under phase 3's limits, on inputs of
    one-layer PaiNNs at those widths (``width_painn_inputs``, 2,000
    particles per sample, batch 2); not timed (PaiNN-5-512's is timed on its
    own inputs in ``width_runs``)."""
    ok = True
    for dim in (2, 3):
        for h in WIDE_H:
            for r in WIDE_R:
                seen = width_painn_inputs(device, h, r, dim, W_GATE_PARTICLES)
                log(f"phase 18: K5 gate at H = {h}, R = {r}, dim {dim}")
                _, passed = compare_painn_kernels(seen, ("painn_layer",), timed=False)
                ok &= passed
    return ok


def wide_path(device):
    """Slice 18 ("phase 18"): K3 (plain and encoder step), K4, K8 (plain and
    encoder step) and E2 at F in WIDE_F on the wide path, bf16 and float32,
    against their plain versions under phases 2's, 3's, 5's and 6's limits
    (K4's weight gradients bit-identical over two launches; from F = 768 on
    the models' inputs at WIDE_SMALL_PARTICLES a sample), and K5's
    tensor-core design at H in WIDE_H x R in WIDE_R; then through runner.train_or_infer
    (``width_runs``): GNS-10-512 mode=all and a slot infer at batch 1,
    PaiNN-5-512 standard mode=all and fused mode=infer, window_select
    --latent 512; and float32 card-vs-CPU checks: a 3-step rollout of
    GNS-2-320 and GNS-2-512, 3 training steps of GNS-2-320, one forward of
    PaiNN-2-320 in both layouts. Prints the wide kernels' registers and
    spills, each run's wall time and the phase's."""
    t_phase = time.perf_counter()
    rows, ok, step_ms = {}, True, {}
    main = GNS512["model.latent_dim"]
    if str(device) != "cpu":
        from lagrangebench_torch.ops import build

        log("phase 18: the wide path's kernels (csrc/mp_wide.cuh, csrc/mp_wgmma.cuh) and K5's "
            "tensor-core design")
        ptxas_report(build, ("fused_mp", "fused_mp_bwd"),
                     only={k for d in (WGMMA_KERNELS, WIDE_KERNELS) for ks in d.values()
                           for k in ks} | {"fused_mp_wide_gemm_f32"})
        ptxas_report(build, ("painn_layer",), only=set(K5_TC_IDENTS))
    for f in WIDE_F:
        t_f = time.perf_counter()
        n = WIDE_SMALL_PARTICLES if f >= WIDE_SMALL_FROM else None
        ok &= width_gns_checks(device, f, rows, (main,), phase="phase 18", n_particles=n)
        log(f"phase 18: the gates at F = {f}: {time.perf_counter() - t_f:.1f} s wall")
    ok &= wide_painn_checks(device)
    log(f"phase 18 kernel gates: {time.perf_counter() - t_phase:.1f} s wall")
    ok &= width_runs(device, "phase 18", (GNS512,), PAINN512, rows, step_ms)
    rows[f"painn_layer@{PAINN512['model.latent_dim']}"]["cuda_kernels"] = list(K5_TC_KERNELS)
    ok &= width_reference_check(device, (320, 512), 320, train_latent=320, adam_ties=True)
    log(f"phase 18 (past F = 256, H = 256, R = 64): {time.perf_counter() - t_phase:.1f} s "
        f"wall [{card_line()}]")
    return rows, ok, step_ms


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
    t_start = time.perf_counter()

    def stamp(label):  # the run's wall clock at the end of each phase
        log(f"[{time.perf_counter() - t_start:.1f} s] {label} done")

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
    stamp("phase 2 (inference)")
    bwd_row, train_ok, counts, train_ref = train_path("cuda")
    ok &= train_ok
    ok &= train_reference_check("cuda")
    stamp("phase 3 (training)")
    for name, row in rows.items():
        row["launches"] = counts[name]
    rows["fused_mp_bwd"] = bwd_row
    painn_rows, painn_ok, painn_ms = painn_path("cuda")
    ok &= painn_ok
    ok &= painn_reference_check("cuda")
    log(f"PaiNN inference path: {painn_ms['standard']:.3f} ms per rollout step (standard, K6), "
        f"{painn_ms['fused']:.3f} (fused, K5)")
    stamp("phase 4 (PaiNN)")
    rows.update(painn_rows)
    slot_rows, slot_ok, slot_ms = slot_path("cuda")
    ok &= slot_ok
    ok &= slot_reference_check("cuda")
    log("slot and geometry paths (ms per rollout step): " + json.dumps(
        {k: round(v, 3) for k, v in slot_ms.items()}))
    stamp("phase 5 (slot, geometry)")
    rows.update(slot_rows)
    egnn_ok, egnn_ms = egnn_path("cuda")
    ok &= egnn_ok
    ok &= egnn_reference_check("cuda")
    std_ok, std_ms = standard_gns_path("cuda")
    ok &= std_ok
    ok &= linear_path("cuda")
    log("EGNN and standard GNS paths (ms per step): " + json.dumps(
        {k: round(v, 3) for k, v in {**egnn_ms, **std_ms}.items()}))
    stamp("phase 7 (EGNN, standard GNS, Linear)")
    segnn_ok, segnn_ms = segnn_path("cuda")
    ok &= segnn_ok
    ok &= segnn_reference_check("cuda")
    log("SEGNN path (ms per step): " + json.dumps({k: round(v, 3) for k, v in segnn_ms.items()}))
    stamp("phase 8 (SEGNN)")
    sparse_ok, sparse_ms, search_ms = sparse_path("cuda")
    ok &= sparse_ok
    log("sparse and cell-list paths (ms per step): " + json.dumps(
        {k: round(v, 3) for k, v in sparse_ms.items()}))
    stamp("phase 9 (sparse)")
    exp_rows, exp_ok = experiments_path("cuda")
    ok &= exp_ok
    rows.update(exp_rows)
    stamp("phase 6 (experiments)")
    dp_ok, dp_counts = dp_path({**train_ref, "counts": counts}, "cuda")
    ok &= dp_ok
    log(f"data-parallel path launches per rank: {json.dumps(dp_counts)}")
    stamp("phase 11 (data parallelism)")
    spatial_ok, spatial_counts = spatial_path("cuda")
    ok &= spatial_ok
    log(f"spatial path launches per rank: {json.dumps(spatial_counts)}")
    stamp("phase 12 (spatial)")
    steer_ok, steer_counts = steerable_path("cuda")
    ok &= steer_ok
    log(f"spatial SEGNN and EGNN path launches per rank: {json.dumps(steer_counts)}")
    stamp("phase 13 (spatial SEGNN, EGNN)")
    ref_ok, ref_counts = reference_path("cuda")
    ok &= ref_ok
    log(f"reference-checkpoint path launches: {json.dumps(ref_counts)}")
    stamp("phase 14 (reference checkpoints)")
    gen_ok, gen_counts = datagen_path("cuda")
    ok &= gen_ok
    log(f"data-generation path launches (GNS runs): {json.dumps(gen_counts)}")
    stamp("phase 15 (data generation)")
    w64_rows, w64_ok, w64_ms = gns64_path("cuda")
    ok &= w64_ok
    rows.update(w64_rows)
    log("GNS-5-64 path (ms per step): " + json.dumps({k: round(v, 3) for k, v in w64_ms.items()}))
    stamp("phase 16 (GNS-5-64)")
    width_rows, width_ok, width_ms = width_path("cuda")
    ok &= width_ok
    rows.update(width_rows)
    log("GNS-10-256, GNS-10-96 and PaiNN-5-64 paths (ms per step): " + json.dumps(
        {k: round(v, 3) for k, v in width_ms.items()}))
    stamp("phase 17 (every width to 256)")
    wide_rows, wide_ok, wide_ms = wide_path("cuda")
    ok &= wide_ok
    rows.update(wide_rows)
    log("GNS-10-512 and PaiNN-5-512 paths (ms per step): " + json.dumps(
        {k: round(v, 3) for k, v in wide_ms.items()}))
    stamp("phase 18 (past 256)")
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
    if sys.argv[1:2] == ["--dp-launched"]:  # the worker of phase 11 (b)
        sys.exit(dp_launched(*sys.argv[2:4]))
    sys.exit(main())
