"""The cell list's selection of its valid candidates in three designs, on
the card: one neighbor update of ``ops.neighbors``' cell list, dense and
sparse, with each design in place of the port's.

Batch 2 x 8,000 particles in 3D (two seeds of ``_setup.grid_positions``
in a periodic unit box, cutoff 0.0725, capacities x1.0, sample 1 with 100
padded particles), float32:

- scatter: every candidate scattered to its slot, the rejected ones (and
  those past capacity) to one spare slot per row (dense) or per sample
  (sparse), sliced off after;
- row_scan: each slot's candidate found by a binary search of the running
  count (``torch.searchsorted``) and gathered, the count a scan along each
  row;
- flat_scan (the port's ``neighbors._nth_true``): the same search, the
  count one scan of the flattened mask less each row's start (on CUDA a
  scan along the last axis takes one block per row, and the sparse list
  has one row of ~3.5M candidates per sample).

Prints one JSON line: the card, and per format and design the device ms
of one update (``profiling.call_ms``, run in turns: scatter, row_scan,
flat_scan, flat_scan, row_scan, scatter) and whether its list equals the
port's.

    python -m lagrangebench_torch.experiments.compaction [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import neighbors as nb
from ..ops import space
from ..profiling import call_ms
from ..utils import resolve_device
from . import _setup


def scatter_select(cand, mask, k_cap: int, n: int):
    """``neighbors._dense_select`` by a scatter into a spare slot."""
    bsz, rows, c = cand.shape
    slot = torch.cumsum(mask, dim=-1) - 1
    slot = torch.where(mask & (slot < k_cap), slot, k_cap)
    out = torch.full((bsz, rows, k_cap + 1), n, dtype=torch.int32, device=cand.device)
    out.scatter_(2, slot, cand.to(torch.int32).expand(bsz, rows, c))
    return out[..., :k_cap], (mask.sum(dim=-1) > k_cap).any(dim=1)


def scatter_compact(mask, senders, e_cap: int, n: int):
    """``neighbors._compact_edges`` by a scatter into a spare slot."""
    bsz, rows, c = mask.shape
    flat = mask.reshape(bsz, -1)
    slots = torch.cumsum(flat, dim=1) - 1
    slots = torch.where(flat & (slots < e_cap), slots, e_cap)
    recv = torch.arange(rows, dtype=torch.int32, device=mask.device)[:, None].expand(rows, c)
    pairs = torch.stack([recv.expand(bsz, rows, c), senders.to(torch.int32).expand(bsz, rows, c)],
                        dim=1)
    out = torch.full((bsz, 2, e_cap + 1), n, dtype=torch.int32, device=mask.device)
    out.scatter_(2, slots[:, None, :].expand(-1, 2, -1), pairs.reshape(bsz, 2, -1))
    return out[..., :e_cap], flat.sum(dim=1)


def row_scan_nth_true(mask, count: int):
    """``neighbors._nth_true`` with the running count scanned along rows."""
    running = torch.cumsum(mask, dim=-1)
    nth = torch.arange(1, count + 1, device=mask.device).expand(
        tuple(mask.shape[:-1]) + (count,)).contiguous()
    return torch.searchsorted(running, nth), running


DESIGNS = ("scatter", "row_scan", "flat_scan")


class _Design:
    """Puts one design's functions in ``neighbors`` while active (the edge
    builders look them up there on every call)."""

    def __init__(self, name: str):
        self.swap = {}
        if name == "scatter":
            self.swap = {"_dense_select": scatter_select, "_compact_edges": scatter_compact}
        elif name == "row_scan":
            self.swap = {"_nth_true": row_scan_nth_true}

    def __enter__(self):
        self.saved = {k: getattr(nb, k) for k in self.swap}
        for k, fn in self.swap.items():
            setattr(nb, k, fn)

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(nb, k, fn)


def main(argv: Optional[Sequence[str]] = None, device=None,
         n_particles: int = 8000) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv or [])
    device = resolve_device(device or args.device)
    meta = _setup.synthetic_metadata(n_particles)
    cutoff = float(meta["default_connectivity_radius"])
    pos_np = np.stack([_setup.grid_positions(n_particles, 3, 1.0, 1, seed=s)[:, 0]
                       for s in range(2)]).astype(np.float32)
    x = torch.as_tensor(pos_np, device=device)
    npart = torch.tensor([n_particles, n_particles - 100], device=device)
    disp = space.periodic(torch.full((3,), 1.0, device=device))[0]
    out = {"device": str(device), "n": n_particles}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    for fmt in ("dense", "sparse"):
        fns = nb.neighbor_list(disp, [1.0] * 3, cutoff, backend="celllist", format=fmt)
        shell = fns.allocate_shell(pos_np[0], num_particles=n_particles,
                                   device=device).broadcast(2)
        want = shell.update(x, num_particles=npart)
        for name in DESIGNS + DESIGNS[::-1]:
            with _Design(name):
                got = shell.update(x, num_particles=npart)
                ms = call_ms(lambda: shell.update(x, num_particles=npart), device, iters=10)
            row = out.setdefault(f"{fmt} {name}", {"ms": [], "equal": True})
            row["ms"].append(ms)
            row["equal"] &= (torch.equal(got.idx, want.idx)
                             and torch.equal(got.did_buffer_overflow, want.did_buffer_overflow))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
