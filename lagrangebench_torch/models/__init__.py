"""Models (GNS with the fused processor, PaiNN) and the factory."""

from __future__ import annotations

from typing import Dict

from torch import nn

from .gns import GNS, build_gns, fused_params_from_standard, gns_input_sizes
from .painn import (
    PaiNN,
    build_painn,
    painn_fused_params_from_standard,
    painn_standard_params_from_fused,
)

__all__ = [
    "GNS",
    "PaiNN",
    "build_gns",
    "build_painn",
    "ensure_fused_params",
    "fused_params_from_standard",
    "gns_input_sizes",
    "painn_fused_params_from_standard",
    "painn_standard_params_from_fused",
    "setup_model",
]

# models of the JAX package not ported yet, with their ROADMAP.md §1 item
_NOT_PORTED = {"linear": 2, "egnn": 4, "segnn": 5}


def ensure_fused_params(params: Dict, cfg_model) -> Dict:
    """Re-layout a standard-layout tree for the fused processor (a rename
    and split; the math is identical) when the config asks for the fused
    path and ``params`` is in the standard layout; else ``params`` as is."""
    if not cfg_model.get("fused_processor", False):
        return params
    name = cfg_model.name.lower()
    if name == "gns" and not any(str(k).startswith("mp0_") for k in params):
        return fused_params_from_standard(params, int(cfg_model.num_mp_steps))
    if name == "painn" and "filt_w" not in params.get("PaiNNLayer_0", {}):
        return painn_fused_params_from_standard(params, int(cfg_model.num_mp_steps))
    return params


def setup_model(cfg_model, metadata: Dict, has_external_force: bool = False, seed: int = 0,
                device="cuda") -> nn.Module:
    """The model a config section names, built for the dataset's metadata
    (the JAX package's ``setup_model``), with seeded weights on ``device``."""
    name = cfg_model.name.lower()
    if name == "gns":
        return build_gns(cfg_model, metadata, has_external_force=has_external_force, seed=seed,
                         device=device)
    if name == "painn":
        return build_painn(cfg_model, metadata, has_external_force=has_external_force,
                           seed=seed, device=device)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to lagrangebench_torch yet "
            f"(ROADMAP.md §1 item {_NOT_PORTED[name]})"
        )
    raise ValueError(f"Unknown model {name!r}")
