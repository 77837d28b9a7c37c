"""Numerical primitives: spaces, neighbor search and the CUDA kernels."""

from .neighbors import NeighborList, NeighborListFns, neighbor_list
from .space import distance, free, periodic

__all__ = ["NeighborList", "NeighborListFns", "neighbor_list", "periodic", "free", "distance"]
