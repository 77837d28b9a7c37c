"""Generate a LagrangeBench-format SPH dataset with the port, end to end.

Counterpart of ``scripts/generate_sph_dataset.py``: runs the port's WCSPH
solver (``data_gen.wcsph``, neighbor search K1 + K2 on the card) over one
of the reference's case families and converts the per-frame output into
``train/valid/test.h5`` + ``metadata.json`` with ``data_gen.jax_sph_converter``.
The cases, options, per-case defaults and splits are the JAX script's;
``--device`` (default ``cuda``) takes the place of its ``--platform``.

Cases:

* ``tgv2d``: 2500 particles, periodic, unforced decay (70 trajectories,
  126 frames, split 50/10/10);
* ``tgv3d``: 8000 particles, periodic 3D, a Verlet skin of 0.25 h and a
  capacity multiplier of 1.5; the last two (test) trajectories run 426
  frames for long-horizon rollouts (split 14/3/3);
* ``dam``: 2D dam break: walls, gravity, free surface (split 28/6/6);
* ``rpf``: 2D reverse Poiseuille flow, one long periodic trajectory at
  c0 15 after 18,000 warmup substeps, time-split 80/10/10; the dataset's
  ``force.py`` (``wcsph.RPF_FORCE_PY``) is written next to the splits;
* ``ldc``: 2D lid-driven cavity: walls and a moving lid, one long
  trajectory (80/10/10).

Usage:

    python -m lagrangebench_torch.data_gen.generate --case tgv2d \\
        --sim_dir datasets/sims/2D_TGV_2500 --dst_dir datasets/TGV_2500_gen
    python -m lagrangebench_torch.data_gen.generate --case rpf --device cpu \\
        --sim_dir /tmp/rpf_sim --dst_dir /tmp/rpf --n_frames 60 --warmup_steps 100
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from . import wcsph
from .jax_sph_converter import convert_jax_sph_dir


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--case", type=str, default="tgv2d",
                   choices=["tgv2d", "tgv3d", "dam", "rpf", "ldc"])
    p.add_argument("--sim_dir", type=str, required=True,
                   help="scratch dir for per-frame solver output")
    p.add_argument("--dst_dir", type=str, required=True,
                   help="output dataset dir (train/valid/test.h5 + metadata)")
    p.add_argument("--n_side", type=int, default=None,
                   help="tgv: particles per side (n_side^dim total)")
    p.add_argument("--n_trajs", type=int, default=None)
    p.add_argument("--n_frames", type=int, default=None)
    p.add_argument("--n_frames_last", type=int, default=None,
                   help="tgv3d: frame count for the last --n_last (test) trajectories")
    p.add_argument("--n_last", type=int, default=None)
    p.add_argument("--write_every", type=int, default=None,
                   help="solver substeps per written frame")
    p.add_argument("--warmup_steps", type=int, default=None,
                   help="rpf/ldc: substeps before frame 0")
    p.add_argument("--split", type=str, default=None)
    p.add_argument("--visc", type=float, default=None)
    p.add_argument("--rng_seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the solver runs: cuda (K1 + K2) or cpu (their plain versions)")
    p.add_argument("--skip_simulate", action="store_true",
                   help="reuse an existing --sim_dir, only convert")
    args = p.parse_args(argv)

    def opts(**defaults):
        out = dict(defaults)
        for k in list(out):
            v = getattr(args, k, None)
            if v is not None:
                out[k] = v
        return out

    dev = {"device": args.device}
    split = args.split
    if not args.skip_simulate:
        if args.case == "tgv2d":
            wcsph.generate_tgv_ensemble(
                args.sim_dir, dim=2, **dev,
                **opts(n_side=50, n_trajs=70, n_frames=126, write_every=40,
                       visc=0.01, rng_seed=0),
            )
            split = split or "50_10_10"
        elif args.case == "tgv3d":
            # a Verlet skin (rebuild every 3 substeps) and a tight capacity;
            # 20 trajectories (14/3/3) with the last two test trajectories
            # long for 400-step rollouts
            wcsph.generate_tgv_ensemble(
                args.sim_dir, dim=3, nl_skin_h=0.25, capacity_multiplier=1.5, **dev,
                **opts(n_side=20, n_trajs=20, n_frames=126, write_every=40,
                       visc=0.01, rng_seed=0, n_frames_last=426, n_last=2),
            )
            split = split or "14_3_3"
        elif args.case == "dam":
            wcsph.generate_dam_ensemble(
                args.sim_dir, **dev,
                **opts(n_trajs=40, n_frames=126, write_every=50, visc=0.01, rng_seed=0),
            )
            split = split or "28_6_6"
        elif args.case == "rpf":
            # c0 = 15 (Mach 0.078 at the ~1.2 terminal band speed) -> a
            # smaller CFL dt, so write_every and the warmup scale by 1.5x
            # to keep the physical frame spacing
            wcsph.generate_rpf_trajectory(
                args.sim_dir, **dev,
                **opts(n_frames=1260, write_every=60, warmup_steps=18000, visc=0.1,
                       rng_seed=0),
            )
            split = split or "80_10_10"
        elif args.case == "ldc":
            wcsph.generate_ldc_trajectory(
                args.sim_dir, **dev,
                **opts(n_frames=1260, write_every=40, warmup_steps=12000, visc=0.01,
                       rng_seed=0),
            )
            split = split or "80_10_10"

    convert_jax_sph_dir(args.sim_dir, args.dst_dir, split=split or "80_10_10", trim=False)
    if args.case == "rpf":
        force_path = os.path.join(args.dst_dir, "force.py")
        with open(force_path, "w") as f:
            f.write(wcsph.RPF_FORCE_PY)
        print(f"wrote {force_path}")
    print(f"dataset written to {args.dst_dir}")
    return args.dst_dir


if __name__ == "__main__":
    main()
