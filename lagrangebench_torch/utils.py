"""Shared utilities: particle typing, kinematic masks and device selection."""

from __future__ import annotations

import enum
from typing import Union

import torch


class NodeType(enum.IntEnum):
    """Particle type tags used across all datasets.

    Padding particles carry ``-1`` and kinematic walls 1/2 (the LagrangeBench
    convention).
    """

    PAD_VALUE = -1
    FLUID = 0
    SOLID_WALL = 1
    MOVING_WALL = 2
    RIGID_BODY = 3
    SIZE = 9


def get_kinematic_mask(particle_type: torch.Tensor) -> torch.Tensor:
    """Boolean mask, True for kinematic particles (walls and padding).

    Kinematic particles are not predicted by the model: the rollout replaces
    them with the ground truth.
    """
    return (
        (particle_type == NodeType.SOLID_WALL)
        | (particle_type == NodeType.MOVING_WALL)
        | (particle_type == NodeType.PAD_VALUE)
    )


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for CPU.

    Raises when CUDA is requested (the default) and no card is visible: the
    port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lagrangebench_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
