"""Build and load the port's CUDA kernels (``csrc/*.cu``) with nvcc.

Each source compiles on first use into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``), loaded
with ctypes. Libraries are named by a hash of their sources and flags, so a
changed source rebuilds and an unchanged one loads at once. ``build()``
starts one nvcc per stale source, all at once, and waits for them. Builds
of one library by several processes (the ranks of a distributed run share
the build directory) are serialized by a lock file per library: the first
compiles, the others wait and then load its result.

The build directory is ``lagrangebench_torch/_build`` (listed in
``.gitignore``) unless ``LAGRANGEBENCH_TORCH_BUILD_DIR`` names another.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
_HEADERS = ("common.cuh", "mp_common.cuh", "mp_warp.cuh", "mp_stream.cuh", "mp_wide.cuh",
            "mp_wgmma.cuh", "mp_wgmma_bwd.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    path = os.environ.get("LAGRANGEBENCH_TORCH_BUILD_DIR") or os.path.join(
        _PKG, "_build"
    )
    os.makedirs(path, exist_ok=True)
    return path


def nvcc() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin/nvcc``, else PATH, else
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu",) + _HEADERS:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _locked(paths):
    """Exclusive locks on ``<path>.lock`` for every path, taken in sorted
    order (so two processes never wait on each other), released on exit."""
    with contextlib.ExitStack() as stack:
        for path in sorted(paths):
            f = stack.enter_context(open(f"{path}.lock", "w"))
            fcntl.flock(f, fcntl.LOCK_EX)
            stack.callback(fcntl.flock, f, fcntl.LOCK_UN)
        yield


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, in parallel.

    Returns the wall seconds of each compile that ran (0.0 for a library
    that was already built, or that another process built while this one
    waited for its lock). Raises with nvcc's output if one fails; the
    compiler's resource report (-Xptxas -v) goes to ``<lib>.log``.
    """
    names = list(names)
    stale = [_lib_path(name) for name in names if not os.path.exists(_lib_path(name))]
    if not stale:
        return {name: 0.0 for name in names}
    with _locked(stale):
        return _build_unlocked(names)


def _build_unlocked(names) -> Dict[str, float]:
    pending = {}
    out = {}
    exe = None
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            out[name] = 0.0
            continue
        exe = exe or nvcc()
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending[name] = (proc, path, tmp, time.perf_counter())
    errors = []
    for name, (proc, path, tmp, t0) in pending.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        with open(f"{path}.log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
        return lib


class Kernel:
    """One hand-written CUDA kernel: its library, C entry and launch count.

    ``launches`` is a plain integer that the wrapper raises by one each
    time it launches the kernel (and at no other time), so a run can show
    that its path went through the kernel.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    @property
    def source_path(self) -> str:
        return os.path.join("lagrangebench_torch", "csrc", f"{self.source}.cu")

    def __call__(self, *args, device) -> None:
        """Launch through the C entry on ``device``: with that card current
        and on its current stream, passed as the entry's last argument.
        Raises on a nonzero CUDA error."""
        import torch

        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args, stream(device))
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {err}"
            )
        self.launches += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """The current stream of ``device`` (a CUDA ``torch.device``), not of
    the current card."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
