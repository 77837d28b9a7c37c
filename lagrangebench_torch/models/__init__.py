"""Models: GNS with the fused processor."""

from .gns import GNS, build_gns, fused_params_from_standard, gns_input_sizes

__all__ = ["GNS", "build_gns", "fused_params_from_standard", "gns_input_sizes"]
