"""Device times of the fused GNS message-passing kernels, K3 and K4, at the
main path's shape, for this checkout or another one.

    python lagrangebench_torch/experiments/mp_times.py [--tree DIR] [--label NAME]

Seeded random inputs at the GNS rollout shape (16,000 receivers x K = 40,
F = 128, bf16: batch 2 x 8,000 particles): K3's plain step, K3's
encoder-folded step (raw edge features of width 4) and K4, each timed with
CUDA events with the card's queue filled ahead (``profiling.device_ms``) and
checked against its plain version (max |kernel - plain|). ``--tree DIR``
imports ``lagrangebench_torch`` from the checkout at DIR instead (an earlier
commit unpacked with ``git archive``, or a scratch copy with a variant of a
kernel), so that versions are timed on the same inputs and the same card, in
one call. Prints one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

N, K = 16000, 40


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


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None, help="checkout whose lagrangebench_torch is timed")
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.tree or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)
    import torch

    from lagrangebench_torch.ops import fused_mp
    from lagrangebench_torch.profiling import device_ms

    if not torch.cuda.is_available():
        raise RuntimeError("mp_times needs a CUDA device")
    if not fused_mp.__file__.startswith(root):
        raise RuntimeError(f"imported {fused_mp.__file__}, not the package under {root}")
    device = torch.device("cuda")
    t, p, enc = _inputs(fused_mp, torch, device)
    plain = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], p)
    folded = (t["raw"], t["hs"], t["hr"], t["h"], t["mask"], p, enc)
    bwd = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], p, t["ge"], t["gh"])
    out = {"label": args.label or root, "card": torch.cuda.get_device_name(0), "N": N, "K": K}
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
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
