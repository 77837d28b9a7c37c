"""Checkpoints in the JAX package's layout, with numpy only.

A checkpoint directory holds ``params.npz`` and ``state.npz``, each keyed
by the '/'-joined tree path of every leaf (``MLP_0/Dense_0/kernel``,
``mp3_w_e``, ...), and ``metadata_ckp.json``. The same files are read and
written by ``lagrangebench_tpu.checkpoint``, so a parameter tree moves
between the packages unchanged; ``models.gns.GNS.load_jax_params`` carries
it into the PyTorch module. The best model (lowest ``loss``) is mirrored
into ``<ckp_dir>/best``.

The optimizer state goes to ``opt_state.npz`` as ``leaf_0``, ``leaf_1``, ...
in the leaf order of the JAX package's ``optax.adamw`` state (adam count,
the first-moment leaves, the second-moment leaves, the schedule count; the
moments in the order JAX flattens the parameter tree), which is what
``lagrangebench_tpu.checkpoint`` writes and reads back into an optax state.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays as {'/'-joined path: numpy array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    """The inverse of :func:`flatten_tree`."""
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
    np.savez(os.path.join(ckp_dir, f"{name}.npz"), **flatten_tree(tree))


def load_pytree(ckp_dir: str, name: str) -> Dict:
    """Read ``<name>.npz`` back into a nested dict of numpy arrays."""
    with np.load(os.path.join(ckp_dir, f"{name}.npz")) as data:
        return unflatten_tree({k: data[k] for k in data.files})


class OptStateLeaves:
    """Array leaves of a saved optimizer state, in the JAX leaf order."""

    def __init__(self, leaves: Sequence[np.ndarray]):
        self.leaves: List[np.ndarray] = [np.asarray(x) for x in leaves]


def save_checkpoint(ckp_dir: str, params: Dict, state: Optional[Dict],
                    metadata_ckp: Dict,
                    opt_state: Optional[Sequence[np.ndarray]] = None) -> None:
    """Save params/state (+ the optimizer state's leaves) and metadata;
    mirror the best model into ``best/``."""
    os.makedirs(ckp_dir, exist_ok=True)
    save_pytree(ckp_dir, params, "params")
    save_pytree(ckp_dir, state or {}, "state")
    if opt_state is not None:
        np.savez(os.path.join(ckp_dir, "opt_state.npz"),
                 **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(opt_state)})
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
    save_checkpoint(best_dir, params, state, metadata_ckp, opt_state)


def load_checkpoint(ckp_dir: str) -> Tuple[Dict, Dict, Optional[OptStateLeaves], int]:
    """Load (params, state, opt_state, step); ``opt_state`` is the saved
    :class:`OptStateLeaves`, or None if the checkpoint has none."""
    params = load_pytree(ckp_dir, "params")
    state = (
        load_pytree(ckp_dir, "state")
        if os.path.exists(os.path.join(ckp_dir, "state.npz"))
        else {}
    )
    opt_state = None
    opt_npz = os.path.join(ckp_dir, "opt_state.npz")
    if os.path.exists(opt_npz):
        with np.load(opt_npz) as data:
            opt_state = OptStateLeaves([data[f"leaf_{i}"] for i in range(len(data.files))])
    with open(os.path.join(ckp_dir, "metadata_ckp.json"), "r") as f:
        metadata_ckp = json.load(f)
    return params, state, opt_state, metadata_ckp["step"]
