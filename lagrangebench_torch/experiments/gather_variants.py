"""Row-gather probes (E1): the sender gather ``h[idx]`` in every form the
TPU probes used, the port's kernel against PyTorch's own gathers.

Counterpart of ``scripts/experiments/gather_variants.py``. The TPU probes
were seven Pallas kernels, one function in different tilings; the port
computes that function with one kernel (``ops/row_gather.py``,
``csrc/row_gather.cu``) and runs it in each form the probes took:

1. whole rows and one index column at a time (E1a, E1b): bf16, (N, K) index;
2. ``take_along_axis`` (E1c), float32 and bf16, beside the library gathers;
3. a grid over K (E1d), float32 and bf16;
4. the transposed (K, N) index (E1e), float32 and bf16;
5. the table-size sweep N in {8, ..., 2048}: one gather of a flat (N,) index
   (E1f) and the float32 sum of min(N K / n, 24) repeated gathers (E1g), in
   rows per ms;
6. the library forms on the real neighbor indices of an 8,000-particle 3D
   case (K1 and K2 build them) and on random ones: ``h[idx]``,
   ``index_select`` on the flat index, ``take_along_dim``, sorted flat
   indices, rows 256 wide in float32 and 1024 wide in bf16; the kernel on
   the same indices beside them.

Every kernel result is held equal to ``h[idx]`` (or the plain float32 sum);
a difference raises. Times are device time per call on the card (CUDA
events, the queue filled ahead: ``profiling.device_ms``), the host clock on
the CPU.

    python -m lagrangebench_torch.experiments.gather_variants [1-6 ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.row_gather import row_gather, row_gather_plain
from ..profiling import call_ms
from ..utils import resolve_device
from ._setup import real_neighbor_indices

N, K, F = 8192, 24, 128  # variants 1-4
SWEEP = (8, 64, 256, 1024, 2048)  # variant 5's table sizes
N_REAL, ISL = 8000, 6  # variant 6's case
ITERS = 20  # timed calls per measurement (variant 5: 50)


class Probe:
    """Times calls and checks kernel results on one device; keeps every
    time in ``results[variant][name]`` (ms per call)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.results: Dict[int, Dict[str, float]] = {}
        self.variant = 0

    def time(self, name: str, fn: Callable, n: int = ITERS) -> float:
        ms = call_ms(fn, self.device, n)
        self.results.setdefault(self.variant, {})[name.strip()] = ms
        print(f"{name}: {ms:.4f} ms ({self.device.type})", flush=True)
        return ms

    def check(self, name: str, got: torch.Tensor, want: torch.Tensor) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{name}: {tuple(got.shape)} {got.dtype}, expected "
                               f"{tuple(want.shape)} {want.dtype}")
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        print(f"{name}: max err {err}", flush=True)
        if err != 0.0:
            raise RuntimeError(f"{name}: the row gather differs from h[idx] by {err}")

    def tensor(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)


def variant_1(probe: Probe) -> None:
    """Whole-row and column-at-a-time gathers (E1a, E1b), bf16."""
    rng = np.random.default_rng(0)
    h = probe.tensor(rng.normal(size=(N, F)), torch.bfloat16)
    idx = probe.tensor(rng.integers(0, N, size=(N, K)), torch.int32)
    idx64, flat = idx.long(), idx.reshape(-1).long()
    probe.time("library_gather", lambda: h[idx64])
    probe.time("index_select", lambda: torch.index_select(h, 0, flat))
    probe.check("row_gather (take, cols)", row_gather(h, idx), h[idx64])
    probe.time("row_gather", lambda: row_gather(h, idx))


def variant_2(probe: Probe) -> None:
    """take_along_axis forms (E1c) and the float32 gather."""
    rng = np.random.default_rng(0)
    h = probe.tensor(rng.normal(size=(N, F)), torch.bfloat16)
    hf = h.float()
    idx = probe.tensor(rng.integers(0, N, size=(N, K)), torch.int32)
    idx64 = idx.long()
    ids = idx64.reshape(-1, 1).expand(-1, F)
    probe.time("library_gather_bf16", lambda: h[idx64])
    probe.time("library_gather_f32", lambda: hf[idx64])
    probe.time("take_along_dim_f32", lambda: torch.take_along_dim(hf, ids, dim=0))
    for name, src in (("f32", hf), ("bf16", h)):
        probe.check(f"row_gather_taa_{name}", row_gather(src, idx), src[idx64])
        probe.time(f"row_gather_taa_{name}", lambda: row_gather(src, idx))


def variant_3(probe: Probe) -> None:
    """A grid over K (E1d): one index column per program on the TPU."""
    rng = np.random.default_rng(0)
    hb = probe.tensor(rng.normal(size=(N, F)), torch.bfloat16)
    hf = hb.float()
    idx = probe.tensor(rng.integers(0, N, size=(N, K)), torch.int32)
    idx64 = idx.long()
    for name, src in (("f32", hf), ("bf16", hb)):
        probe.check(f"row_gather_k_{name}", row_gather(src, idx), src[idx64])
        probe.time(f"row_gather_k_{name}", lambda: row_gather(src, idx))
    probe.time("library_gather_f32", lambda: hf[idx64])


def variant_4(probe: Probe) -> None:
    """The transposed (K, N) index (E1e)."""
    rng = np.random.default_rng(0)
    hb = probe.tensor(rng.normal(size=(N, F)), torch.bfloat16)
    hf = hb.float()
    idx = probe.tensor(rng.integers(0, N, size=(N, K)), torch.int32)
    idx_t = idx.t().contiguous()  # (K, N)
    idx64 = idx.long()
    for name, src in (("f32", hf), ("bf16", hb)):
        probe.check(f"row_gather_t_{name}", row_gather(src, idx_t, transposed=True),
                    src[idx64])
        probe.time(f"row_gather_t_{name}", lambda: row_gather(src, idx_t, transposed=True))


def variant_5(probe: Probe) -> None:
    """Table-size sweep of the flat gather (E1f) and repeated sums (E1g).

    float32; the repeated form prints rows per ms."""
    rng = np.random.default_rng(0)
    for n in SWEEP:
        h = probe.tensor(rng.normal(size=(n, F)), torch.float32)
        idxs = probe.tensor(rng.integers(0, n, size=(n,)), torch.int32)
        probe.check(f"N={n}", row_gather(h, idxs), h[idxs.long()])
        reps = min(max(1, (N * K) // n), 24)
        probe.check(f"loop_{reps}x_N{n}", row_gather(h, idxs, reps=reps),
                    row_gather_plain(h, idxs, reps=reps))
        t = probe.time(f"  loop_{reps}x_gather_N{n}",
                       lambda: row_gather(h, idxs, reps=reps), n=50)
        print(f"  -> {n * reps / t / 1e3:.0f}k rows/ms", flush=True)


def variant_6(probe: Probe) -> None:
    """Library gathers on real neighbor indices, the kernel beside them.

    The forms vary dtype, flatness, sortedness and row width."""
    n = N_REAL
    idx = real_neighbor_indices(n, 3, ISL, device=probe.device)
    k = idx.shape[1]
    print(f"K = {k}", flush=True)
    rng = np.random.default_rng(0)
    hb = probe.tensor(rng.normal(size=(n, F)), torch.bfloat16)
    hf = hb.float()
    idx_rand = probe.tensor(rng.integers(0, n, size=tuple(idx.shape)), torch.int32)
    idx64, rand64 = idx.long(), idx_rand.long()
    flat = idx64.reshape(-1)
    ids = flat[:, None].expand(-1, F)
    flat_sorted = torch.sort(flat).values
    sorted32 = flat_sorted.to(torch.int32)
    h2 = torch.cat([hf, hf], dim=1)  # 256 wide: two steps' rows at once
    h8 = hb.repeat(1, 8)  # 1024 wide bf16: eight steps at once

    probe.time("gather_real_bf16", lambda: hb[idx64])
    probe.time("gather_real_f32", lambda: hf[idx64])
    probe.time("gather_rand_f32", lambda: hf[rand64])
    probe.time("index_select_flat_real_f32", lambda: torch.index_select(hf, 0, flat))
    probe.time("take_along_dim_real_f32", lambda: torch.take_along_dim(hf, ids, dim=0))
    probe.time("index_select_sorted_f32", lambda: torch.index_select(hf, 0, flat_sorted))
    probe.time("gather_real_f32_256wide", lambda: h2[idx64])
    probe.time("gather_real_bf16_1024wide", lambda: h8[idx64])
    for name, src, ix, want in (
            ("row_gather_real_bf16", hb, idx, hb[idx64]),
            ("row_gather_real_f32", hf, idx, hf[idx64]),
            ("row_gather_rand_f32", hf, idx_rand, hf[rand64]),
            ("row_gather_sorted_f32", hf, sorted32, hf[flat_sorted]),
            ("row_gather_real_f32_256wide", h2, idx, h2[idx64]),
            ("row_gather_real_bf16_1024wide", h8, idx, h8[idx64])):
        probe.check(name, row_gather(src, ix), want)
        probe.time(name, lambda: row_gather(src, ix))


VARIANTS = {1: variant_1, 2: variant_2, 3: variant_3, 4: variant_4, 5: variant_5,
            6: variant_6}


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict[int, Dict[str, float]]:
    """Run the named variants (all six without one) and return their times,
    ``{variant: {name: ms}}``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", type=int, choices=sorted(VARIANTS),
                        help="variants to run (default: all)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv or [])
    probe = Probe(resolve_device(device or args.device))
    for v in args.variants or sorted(VARIANTS):
        print(f"# variant {v}: {VARIANTS[v].__doc__.splitlines()[0]}", flush=True)
        probe.variant = v
        VARIANTS[v](probe)
    return probe.results


if __name__ == "__main__":
    main(sys.argv[1:])
