"""Model contract, feature concatenation and the JAX parameter bridge.

A model is an ``nn.Module`` called as ``model(features, particle_type)``
with a FeatureDict (see ``case/features.py``) and an (N,) integer type
tensor, returning a dict with "acc" (N, dim), the normalized acceleration
that ``case.integrate`` consumes, or with "pos" (N, dim), the next absolute
positions (EGNN, which also returns "vel" and "acc").

Every model also lists its parameters as the leaves of the JAX package's
parameter tree (``jax_leaves``), which carries weights across both ways
(``JaxTree``) and orders the optimizer state in ``opt_state.npz``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..checkpoint import flatten_tree, unflatten_tree

_NODE_KEYS = ("vel_hist", "vel_mag", "bound", "force")
_EDGE_KEYS = ("rel_disp", "rel_dist")


def concat_node_features(features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate the available node features in the canonical order."""
    return torch.cat([features[k] for k in _NODE_KEYS if k in features], dim=-1)


def concat_edge_features(features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate the available edge features in the canonical order."""
    return torch.cat([features[k] for k in _EDGE_KEYS if k in features], dim=-1)


class JaxTree:
    """Weights from and to a JAX parameter tree of numpy arrays, through
    ``jax_leaves()``: every parameter as (JAX tree path, parameter,
    transposed), in the order JAX flattens the tree (dict keys sorted at
    every level). ``transposed`` marks ``nn.Linear`` weights, stored (out,
    in) against the Flax kernel's (in, out)."""

    def jax_leaves(self) -> List[Tuple[str, nn.Parameter, bool]]:
        raise NotImplementedError

    def load_jax_params(self, params: Dict) -> None:
        """Copy a JAX tree in the module's layout into the parameters."""
        flat = flatten_tree(params)
        with torch.no_grad():
            for path, p, transposed in self.jax_leaves():
                value = torch.as_tensor(flat[path])
                p.copy_(value.t() if transposed else value)

    def jax_params(self) -> Dict:
        """The parameters as a JAX tree of numpy arrays."""
        return unflatten_tree({
            path: (p.detach().t() if transposed else p.detach()).cpu().numpy()
            for path, p, transposed in self.jax_leaves()
        })


def sorted_leaves(leaves):
    """Leaves in JAX's flatten order: dict keys sorted at every level."""
    return sorted(leaves, key=lambda leaf: leaf[0].split("/"))
