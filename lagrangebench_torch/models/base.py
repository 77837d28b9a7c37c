"""Model contract and feature concatenation.

A model is an ``nn.Module`` called as ``model(features, particle_type)``
with a FeatureDict (see ``case/features.py``) and an (N,) integer type
tensor, returning a dict with "acc" (N, dim): the normalized acceleration
that ``case.integrate`` consumes.
"""

from __future__ import annotations

from typing import Dict

import torch

_NODE_KEYS = ("vel_hist", "vel_mag", "bound", "force")
_EDGE_KEYS = ("rel_disp", "rel_dist")


def concat_node_features(features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate the available node features in the canonical order."""
    return torch.cat([features[k] for k in _NODE_KEYS if k in features], dim=-1)


def concat_edge_features(features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate the available edge features in the canonical order."""
    return torch.cat([features[k] for k in _EDGE_KEYS if k in features], dim=-1)
