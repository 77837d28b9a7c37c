"""Windowed sender select (E2) against the gather followed by K3.

Counterpart of ``scripts/experiments/window_select.py``. The rows stay
compact but cell-sorted (sort key: the x-slab at the neighbor-list column
width, then y at a quarter of the cutoff), and each 32-row sub-tile of a
128-row receiver tile gets three sender windows, one per neighboring
x-slab, into a ghost-extended copy of the sender rows (``hs_ext``). An
edge's candidate id ``c`` names its sender as row ``w0s[t, u, c // WSUB] *
8 + c % WSUB`` of ``hs_ext``; ``c = 3 WSUB`` is a padded slot.

``main`` runs at the probe's size (8,000 particles in 3D, K = 24, F = 128
or ``--latent``, bf16, real cell-sorted positions) and times 50-step loops of

- (b) ``hs_ext = hs[ext_idx]`` followed by E2 (``fused_mp.gns_mp_step_window``),
- (a) ``hs[senders_abs]`` followed by K3 (``fused_mp.gns_mp_step``),

in device time (CUDA events, the queue filled ahead: ``profiling.device_ms``),
then checks one step of E2 against its plain version.

    python -m lagrangebench_torch.experiments.window_select [--device cpu] [--latent 64]
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import fused_mp
from ..profiling import call_ms
from ..utils import resolve_device
from ._setup import grid_positions

N, DIM, K, F = 8000, 3, 24, 128
CUTOFF = 1.45 * 0.05
T = 128  # receiver rows per tile
SUB = 32  # rows per sub-tile (one set of three windows)
STEPS = 50  # MP steps per timed loop
REPEATS = 3  # timed loops of each path, after one warm-up loop
DTYPE = torch.bfloat16


def build_structure(n=N, dim=DIM, k=K, cutoff=CUTOFF, t=T, sub=SUB, seed=0):
    """Sorted order, windows, and a real radius graph in sorted space.

    A copy of the probe's ``build_structure`` with its module constants as
    arguments (the slab count ``floor(1 / cutoff)`` and the fine y-bin count,
    four per slab, follow from ``cutoff``). Returns (n_rows, n_ext, ext_idx
    (n_ext,) int64, cand (n_rows, k) int32, w0s (n_tiles, sub-tiles, 3)
    int32 in 8-row units, w0s_rows (the same in rows), WSUB), equal to the
    probe's outputs for the same arguments.
    """
    if dim != 3:
        raise ValueError(f"build_structure: the radius graph is 3D, got dim={dim}")
    ncx = math.floor(1.0 / cutoff)
    yf = 4 * ncx
    rng = np.random.default_rng(seed)
    pos = grid_positions(n, dim, 1.0, 6)[:, 5] + rng.normal(scale=0.002, size=(n, dim))
    pos %= 1.0

    xs = np.clip((pos[:, 0] * ncx).astype(int), 0, ncx - 1)
    yfi = np.clip((pos[:, 1] * yf).astype(int), 0, yf - 1)
    key = xs * yf + yfi
    order = np.argsort(key, kind="stable")
    pos_s = pos[order]
    xs_s, yf_s = xs[order], yfi[order]

    # slab-aligned padded rows
    slab_occ = np.bincount(xs_s, minlength=ncx)
    slab_pad = ((slab_occ + t - 1) // t) * t
    sstart = np.concatenate([[0], np.cumsum(slab_pad)])
    n_rows = int(sstart[-1])
    row_of_sorted = np.empty(n, int)
    for s in range(ncx):
        idx = np.where(xs_s == s)[0]
        row_of_sorted[idx] = sstart[s] + np.arange(len(idx))
    # fine-bin prefix sums per slab (absolute padded rows)
    finestart = np.full((ncx, yf + 1), 0, int)
    for s in range(ncx):
        occ = np.bincount(yf_s[xs_s == s], minlength=yf)
        finestart[s, :] = sstart[s] + np.concatenate([[0], np.cumsum(occ)])

    # radius graph in sorted-row space (dense k per receiver), candidates in
    # the (dx, dy, dz) stencil order and bucket insertion order
    cell = np.clip((pos_s * ncx).astype(int), 0, ncx - 1)
    cid = (cell[:, 0] * ncx + cell[:, 1]) * ncx + cell[:, 2]
    buckets = {}
    for i, c in enumerate(cid):
        buckets.setdefault(c, []).append(i)
    senders = np.full((n_rows, k), -1, int)
    counts = np.zeros(n_rows, int)
    maxk = 0
    for i in range(n):
        ci = cell[i]
        cands = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    cc = ((ci[0] + dx) % ncx * ncx + (ci[1] + dy) % ncx) * ncx + (
                        ci[2] + dz
                    ) % ncx
                    cands.extend(buckets.get(cc, []))
        d = pos_s[cands] - pos_s[i]
        d -= np.round(d)
        good = np.where((d * d).sum(1) <= cutoff * cutoff)[0]
        maxk = max(maxk, len(good))
        r = row_of_sorted[i]
        for j, g in enumerate(good[:k]):
            senders[r, j] = row_of_sorted[cands[g]]
        counts[r] = min(len(good), k)
    print(f"max neighbors: {maxk} (K={k})")
    assert maxk <= k

    # ghost-extended row layout: per slab [pre ghost = rows of the last gb
    # y-bins][slab content][post ghost = rows of the first gb y-bins], so
    # y-periodic windows never wrap; ghost segments padded to a static cap
    gb = 4  # ghost y-bins = ceil(cutoff / fine bin)
    fine_occ = finestart[:, 1:] - finestart[:, :-1]  # (ncx, yf)
    gc = max(int(fine_occ[:, :gb].sum(1).max()), int(fine_occ[:, -gb:].sum(1).max()))
    gcap = -(-int(gc * 1.15) // 8) * 8
    slab_ext = slab_pad + 2 * gcap
    estart = np.concatenate([[0], np.cumsum(slab_ext)])
    n_ext = int(estart[-1])
    ext_idx = np.zeros(n_ext, np.int64)  # ext row -> compact row (clamped)
    for s in range(ncx):
        base = estart[s]
        pre_rows = finestart[s, yf] - finestart[s, yf - gb]
        # pre ghost: rows of the last gb bins, packed at the end of the pre
        # segment so they abut the content start
        a = finestart[s, yf - gb]
        ext_idx[base + gcap - pre_rows: base + gcap] = np.arange(a, finestart[s, yf])
        ext_idx[base: base + gcap - pre_rows] = 0
        # content
        ext_idx[base + gcap: base + gcap + slab_occ[s]] = np.arange(
            sstart[s], sstart[s] + slab_occ[s])
        ext_idx[base + gcap + slab_occ[s]: base + gcap + slab_pad[s]] = 0
        # post ghost: rows of the first gb bins
        post0 = base + gcap + slab_occ[s]
        b = finestart[s, gb] - finestart[s, 0]
        ext_idx[post0: post0 + b] = np.arange(finestart[s, 0], finestart[s, gb])
        ext_idx[post0 + b: base + slab_ext[s]] = 0

    def ext_of_bin(s, j):
        """ext row of the first row of fine bin j (j in [-gb, yf + gb))."""
        base = estart[s]
        if j < 0:
            pre_rows = finestart[s, yf] - finestart[s, yf - gb]
            return base + gcap - pre_rows + (finestart[s, yf + j] - finestart[s, yf - gb])
        if j >= yf:
            post0 = base + gcap + slab_occ[s]
            return post0 + (finestart[s, j - yf] - finestart[s, 0])
        return base + gcap + (finestart[s, j] - sstart[s])

    n_tiles = n_rows // t
    nsub = t // sub
    yf_of_row = np.full(n_rows, -1, int)
    yf_of_row[row_of_sorted] = yf_s
    xs_of_tile = np.searchsorted(sstart, np.arange(n_tiles) * t, side="right") - 1

    spans = []
    sub_bins = np.zeros((n_tiles, nsub, 2), int)
    subw = np.zeros((n_tiles, nsub, 3, 2), int)
    for ti in range(n_tiles):
        s = xs_of_tile[ti]
        for u in range(nsub):
            rows = yf_of_row[ti * t + u * sub: ti * t + (u + 1) * sub]
            rows = rows[rows >= 0]
            if len(rows) == 0:
                lo, hi = 0, 1
            else:
                lo, hi = int(rows.min()) - gb, int(rows.max()) + gb
            sub_bins[ti, u] = (lo, hi)
            for j, dxs in enumerate((-1, 0, 1)):
                s2 = (s + dxs) % ncx
                a = ext_of_bin(s2, lo)
                b = ext_of_bin(s2, hi) + fine_occ[s2, hi % yf]
                a8 = a // 8 * 8
                subw[ti, u, j] = (a8, b)
                spans.append(b - a8)
    wsub = -(-max(b - a for a, b in subw.reshape(-1, 2)) // 8) * 8
    # absolute 8-aligned window starts, clamped so the window stays inside
    # the ext array; stored in 8-row units
    w0s = np.minimum(subw[..., 0], (n_ext - wsub) // 8 * 8).astype(np.int32)
    assert (w0s % 8 == 0).all()
    w0s_rows = w0s.copy()
    w0s = w0s // 8
    print(f"n_rows={n_rows} n_ext={n_ext} tiles={n_tiles} WSUB={wsub} "
        f"p99 sub-span={int(np.percentile(spans, 99))}")

    # encode cand: sx*WSUB + (sender_ext - w0s[t,u,sx]); fill = 3*WSUB. A
    # sender reached across the y-wrap encodes at its ghost image: the
    # periodic bin image that falls inside the sub-tile's bin window.
    cand = np.full((n_rows, k), 3 * wsub, np.int32)
    for ti in range(n_tiles):
        s = xs_of_tile[ti]
        for u in range(nsub):
            lo, hi = sub_bins[ti, u]
            for r in range(ti * t + u * sub, ti * t + (u + 1) * sub):
                for j in range(counts[r]):
                    srow = senders[r, j]
                    sslab = np.searchsorted(sstart, srow, side="right") - 1
                    dxs = (sslab - s) % ncx
                    sx = {ncx - 1: 0, 0: 1, 1: 2}.get(dxs)
                    assert sx is not None, (dxs,)
                    yfs = yf_of_row[srow]
                    rank = srow - finestart[sslab, yfs]
                    for v in (yfs, yfs - yf, yfs + yf):
                        if lo <= v <= hi:
                            break
                    else:
                        raise AssertionError((ti, u, r, j, yfs, lo, hi))
                    sext = ext_of_bin(sslab, v) + rank
                    local = sext - w0s_rows[ti, u, sx]
                    assert 0 <= local < wsub, (srow, sext, w0s_rows[ti, u, sx], wsub)
                    cand[r, j] = sx * wsub + local
    return n_rows, n_ext, np.asarray(ext_idx), cand, w0s, w0s_rows, wsub


def decode_senders(cand, w0s_rows, ext_idx, wsub, t=T, sub=SUB):
    """The compact sender row of every edge (``n_rows`` on a padded slot):
    the probe's decode of ``cand`` for the gather path, in numpy."""
    n_rows, _ = cand.shape
    n_ext = len(ext_idx)
    senders_abs = np.full(cand.shape, n_rows, np.int32)
    for ti in range(n_rows // t):
        for u in range(t // sub):
            rows = slice(ti * t + u * sub, ti * t + (u + 1) * sub)
            c = cand[rows]
            valid = c < 3 * wsub
            sx = np.clip(c // wsub, 0, 2)
            extrow = w0s_rows[ti, u][sx] + c % wsub
            senders_abs[rows] = np.where(valid, ext_idx[np.clip(extrow, 0, n_ext - 1)], n_rows)
    return senders_abs


def init_step_params(f: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Lecun-normal weights and the LayerNorm identity for one fused MP
    step, float32 (``lagrangebench_tpu/ops/fused_mp.py::init_step_params``
    on a ``torch.Generator``)."""
    from ..models.utils import lecun_normal_

    p = {}
    for name in fused_mp.PARAM_NAMES:
        if name.startswith("w"):
            w = torch.empty(f, f)
            lecun_normal_(w, f, generator)
            p[name] = w
        else:
            p[name] = torch.ones(f) if name.endswith("_scale") else torch.zeros(f)
    return p


def main(argv: Optional[Sequence[str]] = None, device=None) -> Dict:
    """Time (b) the window step and (a) the gather + K3 step, 50-step loops,
    then check one E2 step against its plain version.

    Returns the ms per step of each path, the loop counts, E2's check
    launches and its max |E2 - plain| and |E2 - K3 on the decoded gather|."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--latent", type=int, default=F,
                        help="latent width F (any; on the card the wide path "
                             "above 256)")
    args = parser.parse_args(argv or [])
    device = resolve_device(device or args.device)
    f = args.latent

    n_rows, n_ext, ext_idx, cand, w0s, w0s_rows, wsub = build_structure(
        N, DIM, K, CUTOFF, T, SUB)
    rng = np.random.default_rng(1)
    cdt = DTYPE

    def arr(shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=cdt, device=device)

    e, h, hr, hs = arr((n_rows, K, f)), arr((n_rows, f)), arr((n_rows, f)), arr((n_rows, f))
    p = fused_mp.kernel_params(init_step_params(f, torch.Generator().manual_seed(0)), cdt)
    p = {name: v.to(device) for name, v in p.items()}
    ext_idx_t = torch.as_tensor(ext_idx, device=device)
    cand_t = torch.as_tensor(cand, device=device)
    w0s_t = torch.as_tensor(w0s, device=device)
    senders_abs = decode_senders(cand, w0s_rows, ext_idx, wsub)
    senders_t = torch.as_tensor(np.minimum(senders_abs, n_rows - 1).astype(np.int64),
                                device=device)
    mask_t = torch.as_tensor((senders_abs < n_rows).astype(np.float32), device=device)

    loops = {"window": 0, "gather": 0}  # loops run, warm-up included

    def window_step(*a):
        return fused_mp.at_true_width("gns_mp_step_window", *a, latent=f)

    def gather_step(*a):
        return fused_mp.at_true_width("gns_mp_step", *a, latent=f)

    def window_steps():
        loops["window"] += 1
        ee, hh = e, h
        for _ in range(STEPS):
            hs_ext = hs[ext_idx_t]  # ghost-extended layout, built per step
            ee, hh = window_step(ee, cand_t, w0s_t, wsub, hs_ext, hr, hh, p)
        return ee, hh

    def gather_steps():
        loops["gather"] += 1
        ee, hh = e, h
        for _ in range(STEPS):
            hs_g = hs[senders_t]
            ee, hh = gather_step(ee, hs_g, hr, hh, mask_t, p)
        return ee, hh

    ms = {label: call_ms(fn, device, iters=REPEATS, warmup=1) / STEPS
          for label, fn in (("window", window_steps), ("gather", gather_steps))}
    print(f"window kernel: {ms['window']:.3f} ms/step ({device.type})", flush=True)
    print(f"gather+fused : {ms['gather']:.3f} ms/step ({device.type})", flush=True)

    # numerical check: one step, E2 against its plain version and against
    # the fused step (K3) on the decoded, masked gather
    hs_ext = hs[ext_idx_t]
    e1, h1 = window_step(e, cand_t, w0s_t, wsub, hs_ext, hr, h, p)
    e2, h2 = fused_mp.gns_mp_step_window_plain(e, cand_t, w0s_t, wsub, hs_ext, hr, h, p)
    hs_g = hs[senders_t] * mask_t[..., None].to(cdt)
    e3, h3 = gather_step(e, hs_g, hr, h, mask_t, p)

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())

    err = max(diff(e1, e2), diff(h1, h2))
    err_k3 = max(diff(e1, e3), diff(h1, h3))
    print(f"max |e| diff: {diff(e1, e2)}, max |h| diff: {diff(h1, h2)} (window vs plain)",
          flush=True)
    print(f"max diff window vs gather + fused step on the decoded gather: {err_k3}", flush=True)
    return {"window_ms": ms["window"], "gather_ms": ms["gather"], "loops": loops["window"],
            "steps": STEPS, "check_launches": 1, "max_abs_err": err, "vs_gather": err_k3,
            "n_rows": n_rows, "n_ext": n_ext, "wsub": wsub, "latent": f}


if __name__ == "__main__":
    main(sys.argv[1:])
