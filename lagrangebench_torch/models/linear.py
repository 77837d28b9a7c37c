"""Linear baseline: one Dense layer from the concatenated node features to
the acceleration (the reference's CI model).

Counterpart of ``lagrangebench_tpu/models/linear.py``: ``nn.Dense(dim,
precision="highest")`` over ``concat_node_features``, lecun-normal kernel
and zero bias, computed in the features' dtype (a float32 product with
TF32 off on the card). Its parameter tree is ``Dense_0/{kernel, bias}``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .base import JaxTree, concat_node_features
from .gns import gns_input_sizes
from .utils import Dense, dense_leaves


class Linear(JaxTree, nn.Module):
    """Per-node linear map from the scalar node features to "acc"."""

    def __init__(self, node_in: int, dimension_out: int, seed: int = 0, device="cuda"):
        from ..utils import resolve_device

        super().__init__()
        self.dense = Dense(node_in, dimension_out, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, features: Dict[str, torch.Tensor],
                particle_type: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"acc": self.dense(concat_node_features(features))}

    def jax_leaves(self) -> List[Tuple[str, nn.Parameter, bool]]:
        return dense_leaves("Dense_0", self.dense)


def build_linear(cfg_model, metadata: Dict, input_seq_length: Optional[int] = None,
                 has_external_force: bool = False, seed: int = 0, device="cuda") -> Linear:
    """A Linear model for the dataset's node features."""
    isl = input_seq_length or int(cfg_model.input_seq_length)
    node_in, _ = gns_input_sizes(metadata, isl, bool(cfg_model.magnitude_features),
                                 has_external_force)
    return Linear(node_in, int(metadata["dim"]), seed=seed, device=device)
