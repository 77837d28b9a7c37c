"""Where the device time of the bf16 stream design (K3 and K4 at F = 192 and
256, ``csrc/mp_stream.cuh``) goes: each kernel of K3 and K4 timed by
torch.profiler in this package and in copies with one part of the stream
kernels taken out; with ``--design wgmma``, K4's edge-backward kernel of the
wgmma design (F = 320 to 512, ``csrc/mp_wgmma_bwd.cuh``) instead
(``WGMMA_ABLATIONS``).

    python -m lagrangebench_torch.experiments.stream_ablation [--design stream|wgmma]
        [--latent F] [--only A,B]

Each ablation edits the CUDA sources of a copy of this package written to a
temporary directory (the package itself is never changed), builds it, and
times K3 (plain step) and K4 on ``mp_times``' seeded inputs at the rollout
shape (16,000 x 40, bf16), every kernel by name, in a process of its own.
An ablated copy computes wrong values: only its times count. ``ABLATIONS``
lists them; "base" is the unedited copy. Needs a card. Prints one JSON line:
{ablation: {kernel: ms per launch}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (file under csrc/, regular expression, replacement): each must match
_E2 = (r"      // LN1 backward: dm = ge \+ dagg \* mask; dx1 = inv \(dm s - mean\(dm s\) -\n"
       r"      // xhat mean\(dm s xhat\)\); dm is formed twice rather than kept, its"
       r".*?(?=      __syncwarp\(\);\n      store_slice<F>\(ops\.dx1c)")
_E3_SUMS = (r"#pragma unroll\n      for \(int b0 = 0; b0 < NB; b0 \+= 8\)\n#pragma unroll\n"
            r"        for \(int jj.*?colsum8_to\(own, v, b0, jj, g, t\);\n        \}\n")
_DHR = (r"      // dhr: dfirst summed per receiver, in row order.*?"
        r"(?=      __syncwarp\(\);\n      copy_slice<F>\(sb \+ s_1, ge)")
_RELU = (r"if \(live\) relu_first\(acc, smem, s_x, a\.hr, b1, vg, vg8, ig, ig8, lane\);",
         "if (live) put_pairs(acc, smem, s_x, lane);")
_RELU_BWD = (r"relu_first\(acc, smem, s_1, hr, b1, vg, vg8, ig, ig8, lane\);",
             "put_pairs(acc, smem, s_1, lane);")
ABLATIONS: Dict[str, List[Tuple[str, str, str]]] = {
    "base": [],
    # K4 edge: W2 and W_e streamed as row blocks into the plain product
    "transposed": [("fused_mp_bwd.cu", r"product<true>", "product<false>"),
                   ("fused_mp_bwd.cu", r"ring\.cols = 0b1100;", "ring.cols = 0;")],
    # K4 edge: LN1's backward (dm, the two passes, their sums) left out
    "ln1_backward": [("fused_mp_bwd.cu", _E2, "      put_pairs(acc, smem, s_0, lane);\n")],
    # K4 edge: dagg read as zeros
    "dagg_loads": [("fused_mp_bwd.cu",
                    r"__ldg\(reinterpret_cast<const float2\*>\(a\.dagg \+ ig8? \* F \+ c\)\)",
                    "make_float2(0.f, 0.f)")],
    # K4 edge: b1's column sums and dhr left out
    "dfirst_sums": [("fused_mp_bwd.cu", _E3_SUMS, ""), ("fused_mp_bwd.cu", _DHR, "")],
    # K4 edge: the four slice stores (T(relu(first)), T(dx1), dhs, de) left out
    "stores": [("fused_mp_bwd.cu", r"      store_slice<F>\((ops\.r1c|ops\.dx1c|dhs|de), .*?\);\n", "")],
    # K3 edge and K4's agg pass: hr read as zeros
    "hr_loads": [("mp_stream.cuh", r"vg \? ldg32\(hr \+ ig \* F \+ c\) : 0u", "0u"),
                 ("mp_stream.cuh", r"ldg32\(hr \+ ig8 \* F \+ c\)", "0u")],
    # K3 edge and K4's agg pass: relu_first (hr, hs, b1) and the agg sums left out
    "fwd_products": [("mp_stream.cuh", *_RELU),
                     ("mp_stream.cuh", r"      // agg: the masked messages summed per receiver.*?"
                                       r"(?=      __syncwarp\(\);  // both slots)", "")],
    # K4 edge: its products, with relu_first, LN1's backward and the sums left out
    "bwd_products": [("fused_mp_bwd.cu", _E2, "      put_pairs(acc, smem, s_0, lane);\n"),
                     ("fused_mp_bwd.cu", _E3_SUMS, ""), ("fused_mp_bwd.cu", _DHR, ""),
                     ("fused_mp_bwd.cu", *_RELU_BWD)],
}


_WG = "mp_wgmma_bwd.cuh"
WGMMA_ABLATIONS: Dict[str, List[Tuple[str, str, str]]] = {
    "base": [],
    # the vector sums (b2, ln1_scale, ln1_bias) and their reduce-scatters left out
    "vector_sums": [
        (_WG, r"        const float ps = reduce_scatter4\(vs, lane\), pb = .*?"
              r"vec\[2 \* N \+ 8 \* j0 \+ vcol\] \+= pb;\n", ""),
        (_WG, r"      vec\[8 \* j0 \+ vcol\] \+= reduce_scatter4\(vd, lane\);\n", "")],
    # LN1's backward: ge (shared memory) and dagg (device memory) read as zeros
    "dm_loads": [(_WG, r"const float2 g%s = unpack_bf2\(lds32\(sE \+ swz128\(rA[^;]*;" % r,
                  "const float2 g%s = make_float2(0.f, 0.f);" % r) for r in "AB"] + [
        (_WG, r"const float2 a%s = dg%s != nullptr \? [^;]*;" % (r, r),
         "const float2 a%s = make_float2(0.f, 0.f);" % r) for r in "AB"],
    # the x1 product left out (the ring still moves)
    "x1_product": [(_WG, r"    product\(sR, true\);\n#pragma unroll\n    for \(int j = 0; j < NJ; \+\+j\) \{\n"
                         r"      const float2 b = ",
                    "    product(sR, false);\n#pragma unroll\n    for (int j = 0; j < NJ; ++j) {\n"
                    "      const float2 b = ")],
    # the dfirst pass (the dhr partials, b1) left out
    "dfirst_sums": [(_WG, r"    // dhr partials and b1: dfirst through the E tile.*?"
                          r"(?=    named_bar\(1, 256\);  // both warpgroups are past the E)", "")],
    # the de epilogue's second read of ge (its TMA load and its wait stay): zeros
    "ge_reload": [(_WG, r"h%s\[jj\] = lds32\(sE \+ swz128\(rA[^;]*;" % r, "h%s[jj] = 0u;" % r)
                  for r in "AB"],
    # the three TMA stores (T(dx1), dhs, de) left out
    "stores": [(_WG, r"tma_store\(&tm_(dx1|dhs|de), [^;]*;", ";")],
    # every product skipped (the ring still moves)
    "products": [(_WG, r"product\(s([ER]), true\);", "product(sE, false);")],
}


def ablate(csrc: str, name: str, table=None) -> None:
    """Apply ablation ``name`` of ``table`` (``ABLATIONS`` by default) to the
    CUDA sources in directory ``csrc``; ``ValueError`` if one of its edits
    matches nothing (the sources moved on without the probe)."""
    for source, pattern, repl in (table or ABLATIONS)[name]:
        path = os.path.join(csrc, source)
        with open(path) as f:
            text = f.read()
        new, count = re.subn(pattern, lambda m: repl, text, flags=re.S)
        if count == 0:
            raise ValueError(f"ablation {name}: {pattern!r} matches nothing in {source}")
        with open(path, "w") as f:
            f.write(new)


_TIME = """
import json, re, sys, torch
sys.path.insert(0, ".")
from lagrangebench_torch.experiments import mp_times
from lagrangebench_torch.ops import build, fused_mp
build.build(["fused_mp", "fused_mp_bwd"])
t, p, _ = mp_times._inputs(fused_mp, torch, torch.device("cuda"), f={f})
fwd = (t["e"], t["hs"], t["hr"], t["h"], t["mask"], p)
bwd = fwd + (t["ge"], t["gh"])
for _ in range(2):
    fused_mp.gns_mp_step(*fwd), fused_mp.gns_mp_step_bwd(*bwd)
torch.cuda.synchronize()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        fused_mp.gns_mp_step(*fwd), fused_mp.gns_mp_step_bwd(*bwd)
    torch.cuda.synchronize()
out = {{}}
for ev in prof.key_averages():
    total = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
    name = re.search(r"fused_mp\\w*", ev.key)
    if total > 0 and name:
        out[name.group(0)] = total / ev.count / 1e3
print(json.dumps(out))
"""


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--design", default="stream", choices=("stream", "wgmma"))
    ap.add_argument("--latent", type=int, default=256,
                    help="the instance width: 192 or 256 (stream), 320 to 512 (wgmma)")
    ap.add_argument("--only", default=None, help="comma-separated ablations (all by default)")
    args = ap.parse_args(argv)
    table = ABLATIONS if args.design == "stream" else WGMMA_ABLATIONS
    names = args.only.split(",") if args.only else list(table)
    if args.design == "stream" and args.latent not in (192, 256):
        raise ValueError("the stream design runs F = 192 and 256")
    if args.design == "wgmma" and args.latent not in (320, 384, 448, 512):
        raise ValueError("the wgmma design runs F = 320, 384, 448 and 512")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in names:
            root = os.path.join(tmp, name)
            shutil.copytree(_PKG, os.path.join(root, "lagrangebench_torch"),
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            ablate(os.path.join(root, "lagrangebench_torch", "csrc"), name, table)
            env = dict(os.environ, LAGRANGEBENCH_TORCH_BUILD_DIR=os.path.join(root, "_build"))
            procs[name] = subprocess.Popen(  # build every copy at once
                [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); from "
                 "lagrangebench_torch.ops import build; build.build(['fused_mp', 'fused_mp_bwd'])"],
                cwd=root, env=env)
        for proc in procs.values():
            if proc.wait() != 0:
                raise RuntimeError("an ablated copy did not build")
        out = {}
        for name in names:
            root = os.path.join(tmp, name)
            env = dict(os.environ, LAGRANGEBENCH_TORCH_BUILD_DIR=os.path.join(root, "_build"))
            res = subprocess.run([sys.executable, "-c", _TIME.format(f=args.latent)], cwd=root,
                                 env=env, capture_output=True, text=True, check=True)
            out[name] = json.loads(res.stdout.strip().splitlines()[-1])
    print(json.dumps({"design": args.design, "latent": args.latent, "ablations": out}))
    return out


if __name__ == "__main__":
    main()
