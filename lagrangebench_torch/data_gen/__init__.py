"""Dataset generation and tooling: the WCSPH solver (``wcsph``),
statistics and consolidation (``h5_tools``), the jax-sph and GNS-tfrecord
converters, and the generator's driver (``generate``)."""

from .h5_tools import compute_statistics_h5, consolidate_frames

__all__ = ["compute_statistics_h5", "consolidate_frames"]
