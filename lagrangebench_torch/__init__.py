"""LagrangeBench on PyTorch and CUDA.

The port of ``lagrangebench_tpu`` (JAX, the reference) to PyTorch with
hand-written CUDA kernels for Hopper. It covers training and rollout
inference of GNS, PaiNN, EGNN, SEGNN and Linear on the dense and the sparse
``(2, E)`` neighbor layouts (and of the fused GNS on the slot layout), on
one device or data-parallel over ``torch.distributed`` ranks
(``parallel``): datasets and stats, case setup with noise and targets,
neighbor search (kernels K1, the column table, and K2, the stencil scan; K7
and K9 for the slot layout and the in-kernel edge geometry; the cell list
and all-pairs in PyTorch ops), GNS with its fused message-passing step
(kernel K3; K8 in the slot layout) and that step's backward (kernel K4) or
with the standard processor (PyTorch products at any MLP depth and width),
PaiNN with its message block (kernel K6) or its fused layer (kernel K5),
EGNN and Linear (PyTorch products), SEGNN on its steerable engine
(``models.e3``, PyTorch products), the trainer with AdamW, pushforward and
a torch.profiler hook, checkpoints with optimizer state, rollouts, metrics
and VTK output, and the runner and CLI (``python -m lagrangebench_torch``).
``experiments`` holds the probes of the row gather (kernel E1) and of the
windowed-select MP step (kernel E2). ``data_gen`` generates datasets: a
WCSPH solver whose neighbor search is K1 + K2, and the converters to the
LagrangeBench layout (``python -m lagrangebench_torch.data_gen.generate``).

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
each kernel's plain PyTorch version runs instead.
"""

from .case import case_builder
from .data import DAM2D, LDC2D, LDC3D, RPF2D, RPF3D, TGV2D, TGV3D, ArrayDataset, H5Dataset
from .defaults import defaults
from .evaluate import infer
from .models import EGNN, GNS, SEGNN, GNSStandard, Linear, PaiNN
from .train import Trainer

__all__ = [
    "case_builder", "ArrayDataset", "H5Dataset", "TGV2D", "TGV3D", "RPF2D", "RPF3D", "LDC2D",
    "LDC3D", "DAM2D", "defaults", "infer", "EGNN", "GNS",
    "GNSStandard", "Linear", "PaiNN", "SEGNN", "Trainer",
]
