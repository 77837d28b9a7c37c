"""Boundary-condition-aware displacement and shift functions.

Convention (jax-md's): ``displacement(Ra, Rb) = Ra - Rb`` under the
minimum-image rule for periodic boxes; ``shift(R, dR) = R + dR`` wrapped
back into the box. The functions broadcast over leading axes.

``torch.remainder`` takes the divisor's sign, as ``jnp.mod`` does
(``torch.fmod`` would take the dividend's).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

DisplacementFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
ShiftFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def periodic(side: torch.Tensor) -> Tuple[DisplacementFn, ShiftFn]:
    """Minimum-image displacement and wrapping shift for a periodic box.

    Args:
        side: box side length(s), a tensor of shape () or (dim,) on the
            device and in the dtype of the positions it will see.
    """

    def displacement(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
        dR = Ra - Rb
        # fold into [-side/2, side/2)
        return torch.remainder(dR + side * 0.5, side) - side * 0.5

    def shift(R: torch.Tensor, dR: torch.Tensor) -> torch.Tensor:
        return torch.remainder(R + dR, side)

    return displacement, shift


def free() -> Tuple[DisplacementFn, ShiftFn]:
    """Euclidean displacement and shift (no boundaries)."""

    def displacement(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
        return Ra - Rb

    def shift(R: torch.Tensor, dR: torch.Tensor) -> torch.Tensor:
        return R + dR

    return displacement, shift


def distance(dR: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, safe at zero (finite gradients for
    the self-edges that ``mask_self=False`` keeps)."""
    sq = torch.sum(dR**2, dim=-1)
    nonzero = sq != 0.0
    return torch.sqrt(torch.where(nonzero, sq, torch.ones_like(sq))) * nonzero
