"""Experiment probes of the port, counterparts of ``scripts/experiments/``.

- ``gather_variants``: the row gather ``h[idx]`` (kernel E1,
  ``csrc/row_gather.cu``) in every form the TPU probes used, against
  PyTorch's own gathers.
- ``window_select``: the fused GNS step with each edge's sender row
  selected from three per-sub-tile windows of a ghost-extended row array
  (kernel E2, the ``WINDOW`` instance of ``csrc/fused_mp.cu``), against the
  gather followed by K3.
- ``e3_layout``: SEGNN-10-64's first message product in the engine's
  stacked layout (weights first), in the stacked layout with the
  Clebsch-Gordan contraction first, and on the JAX package's per-m parts.

Each module runs on the card unless asked for the CPU::

    python -m lagrangebench_torch.experiments.gather_variants [1-6] [--device cpu]
    python -m lagrangebench_torch.experiments.window_select [--device cpu]
    python -m lagrangebench_torch.experiments.e3_layout [--edges E] [--device cpu]
"""
