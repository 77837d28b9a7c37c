"""ctypes bindings for the host-side C++ neighbor engine (capacity sizing).

Compiles ``lagrangebench_torch/native/neighbors.cpp`` with g++ on first use
into the port's build directory (``ops/build.py``; never next to the JAX
package's source) and exposes:

* ``count_edges(positions, box, periodic, cutoff, num_particles)``
* ``build_edges(...) -> (idx (2, e_cap) int32 fill=n, count)``

``available()`` is False when no compiler is present; the caller then sizes
capacities with chunked numpy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from .build import build_dir

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "neighbors.cpp",
)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = os.path.join(build_dir(), "libneighbors_host.so")
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.neighbor_edges.restype = ctypes.c_int64
        lib.neighbor_edges.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # positions
            ctypes.c_int64,  # n
            ctypes.c_int,  # dim
            ctypes.POINTER(ctypes.c_double),  # box
            ctypes.c_int,  # periodic
            ctypes.c_double,  # cutoff
            ctypes.c_int64,  # num_particles
            ctypes.POINTER(ctypes.c_int32),  # receivers
            ctypes.POINTER(ctypes.c_int32),  # senders
            ctypes.c_int64,  # e_cap
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def _prep(positions, box):
    pos = np.ascontiguousarray(np.asarray(positions), dtype=np.float64)
    box_arr = np.ascontiguousarray(np.asarray(box, dtype=np.float64).reshape(-1))
    return pos, box_arr


def _call(positions, box, periodic, cutoff, num_particles, receivers, senders, e_cap):
    lib = _load()
    if lib is None:
        raise RuntimeError("host neighbor library unavailable (no g++?)")
    pos, box_arr = _prep(positions, box)
    n, dim = pos.shape
    npart = n if num_particles is None else int(num_particles)
    out = [None, None]
    if receivers is not None:
        out = [
            receivers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            senders.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ]
    count = lib.neighbor_edges(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, dim,
        box_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(bool(periodic)), float(cutoff), npart, out[0], out[1], e_cap,
    )
    if count < 0:
        raise ValueError("host neighbor_edges rejected its input")
    return int(count)


def count_edges(positions, box, periodic: bool, cutoff: float,
                num_particles: Optional[int] = None) -> int:
    """Exact number of radius-graph edges (self-edges included)."""
    return _call(positions, box, periodic, cutoff, num_particles, None, None, 0)


def build_edges(positions, box, periodic: bool, cutoff: float, e_cap: int,
                num_particles: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """(idx (2, e_cap) int32 with fill=n, total_count), receiver-major."""
    n = np.asarray(positions).shape[0]
    receivers = np.full(e_cap, n, dtype=np.int32)
    senders = np.full(e_cap, n, dtype=np.int32)
    count = _call(positions, box, periodic, cutoff, num_particles,
                  receivers, senders, e_cap)
    return np.stack([receivers, senders]), count
