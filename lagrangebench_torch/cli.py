"""Command line: ``python -m lagrangebench_torch config=<yaml> [k=v ...]``
(the ``lagrangebench-torch`` console script).

Counterpart of ``lagrangebench_tpu/cli.py``. Config priority: CLI dotlist >
YAML ``extends:`` chain > built-in defaults. ``load_ckp=ckp/<run>`` without
``config=`` reuses the run's saved ``config.yaml``. ``gpu=-1`` runs on the
CPU (each kernel's plain PyTorch version), ``gpu=k`` on ``cuda:k``; without
it the run needs a CUDA device.

Data-parallel: ``python -m torch.distributed.run --nproc_per_node=N -m
lagrangebench_torch config=<yaml> parallel.data=-1`` runs one rank per card
(``cuda:LOCAL_RANK``; add ``gpu=-1`` for N ranks on the CPU over gloo); only
rank 0 prints and writes. A process group this call initialized is
destroyed when the run ends.
"""

from __future__ import annotations

import os
import sys


def main(argv=None):
    from .config import check_subset, from_dotlist, load_with_extends, merge
    from .defaults import defaults

    argv = argv if argv is not None else sys.argv[1:]
    cli = from_dotlist(argv)
    if cli.get("config") is not None:
        config_path = cli.config
    elif cli.get("load_ckp") is not None:
        config_path = os.path.join(cli.load_ckp, "config.yaml")
    else:
        raise ValueError("Either config=... or load_ckp=... must be specified.")

    cfg_yaml = load_with_extends(config_path, defaults)
    check_subset(defaults, cli)
    cfg = merge(cfg_yaml, cli)
    if cfg.get("config") is None:
        cfg.config = config_path

    import torch.distributed as dist

    from .runner import train_or_infer

    had_group = dist.is_initialized()
    try:
        return train_or_infer(cfg)
    finally:
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()
