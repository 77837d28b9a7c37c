"""Minimal self-contained O(3) steerable-feature engine for SEGNN
(counterpart of ``lagrangebench_tpu/models/e3``)."""

from .basis import clebsch_gordan, spherical_harmonics_fn, wigner_d
from .irreps import Irrep, Irreps, IrrepsArray, MulIrrep, concatenate, from_mul_major
from .tensor import O3TensorProduct, O3TensorProductGate, gate

__all__ = [
    "Irrep",
    "Irreps",
    "IrrepsArray",
    "MulIrrep",
    "concatenate",
    "from_mul_major",
    "O3TensorProduct",
    "O3TensorProductGate",
    "gate",
    "clebsch_gordan",
    "spherical_harmonics_fn",
    "wigner_d",
]
