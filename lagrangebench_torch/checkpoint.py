"""Checkpoints in the JAX package's layout, with numpy only.

A checkpoint directory holds ``params.npz`` and ``state.npz``, each keyed
by the '/'-joined tree path of every leaf (``MLP_0/Dense_0/kernel``,
``mp3_w_e``, ...), and ``metadata_ckp.json``. The same files are read and
written by ``lagrangebench_tpu.checkpoint``, so a parameter tree moves
between the packages unchanged; ``models.gns.GNS.load_jax_params`` carries
it into the PyTorch module. The best model (lowest ``loss``) is mirrored
into ``<ckp_dir>/best``. Optimizer state is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def save_pytree(ckp_dir: str, tree: Dict, name: str) -> None:
    """Write a nested dict of arrays as ``<name>.npz`` keyed by path."""
    np.savez(os.path.join(ckp_dir, f"{name}.npz"), **_flatten(tree))


def load_pytree(ckp_dir: str, name: str) -> Dict:
    """Read ``<name>.npz`` back into a nested dict of numpy arrays."""
    with np.load(os.path.join(ckp_dir, f"{name}.npz")) as data:
        return _unflatten({k: data[k] for k in data.files})


def save_checkpoint(ckp_dir: str, params: Dict, state: Optional[Dict],
                    metadata_ckp: Dict) -> None:
    """Save params/state + metadata; mirror the best model into ``best/``."""
    os.makedirs(ckp_dir, exist_ok=True)
    save_pytree(ckp_dir, params, "params")
    save_pytree(ckp_dir, state or {}, "state")
    with open(os.path.join(ckp_dir, "metadata_ckp.json"), "w") as f:
        json.dump(metadata_ckp, f)
    if os.path.basename(os.path.normpath(ckp_dir)) == "best":
        return
    best_dir = os.path.join(ckp_dir, "best")
    best_meta = os.path.join(best_dir, "metadata_ckp.json")
    if os.path.exists(best_meta):
        with open(best_meta, "r") as f:
            best = json.load(f)
        loss, best_loss = metadata_ckp.get("loss"), best.get("loss")
        if loss is None or best_loss is None or loss >= best_loss:
            return
    save_checkpoint(best_dir, params, state, metadata_ckp)


def load_checkpoint(ckp_dir: str) -> Tuple[Dict, Dict, None, int]:
    """Load (params, state, opt_state, step); opt_state is None (the
    optimizer is not ported yet)."""
    params = load_pytree(ckp_dir, "params")
    state = (
        load_pytree(ckp_dir, "state")
        if os.path.exists(os.path.join(ckp_dir, "state.npz"))
        else {}
    )
    with open(os.path.join(ckp_dir, "metadata_ckp.json"), "r") as f:
        metadata_ckp = json.load(f)
    return params, state, None, metadata_ckp["step"]
