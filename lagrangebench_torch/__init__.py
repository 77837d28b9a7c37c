"""LagrangeBench on PyTorch and CUDA.

The port of ``lagrangebench_tpu`` (JAX, the reference) to PyTorch with
hand-written CUDA kernels for Hopper. It covers GNS and PaiNN training and
rollout inference on the dense neighbor layout: datasets and stats, case
setup with noise and targets, neighbor search (kernels K1 binning and K2
stencil scan), the GNS model with its fused message-passing step (kernel
K3) and that step's backward (kernel K4), PaiNN with its message block
(kernel K6) or its fused layer (kernel K5), the trainer with AdamW and
pushforward, checkpoints with optimizer state, rollouts, metrics and VTK
output, and the runner and CLI (``python -m lagrangebench_torch``).
``experiments`` holds the probes of the row gather (kernel E1) and of the
windowed-select MP step (kernel E2).

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
each kernel's plain PyTorch version runs instead.
"""

from .case import case_builder
from .data import ArrayDataset, H5Dataset
from .defaults import defaults
from .evaluate import infer
from .models import GNS, PaiNN
from .train import Trainer

__all__ = [
    "case_builder", "ArrayDataset", "H5Dataset", "defaults", "infer", "GNS", "PaiNN", "Trainer",
]
