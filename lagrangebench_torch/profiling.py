"""Step timing for the trainer, and the time of one call on the card.

Counterpart of ``lagrangebench_tpu/profiling.py``'s ``StepTimer``: rolling
wall-clock statistics (mean/p50/p95, steps/s, particle-steps/s) reported at
every log interval. The trainer synchronizes the card before each tick, so
a duration is the step's time on the host clock, device work included.

``call_ms`` times a call on the card with CUDA events, the queue filled
ahead so that the host's launch overhead does not stand in for the card's
time (on the CPU: the host clock). ``launch_floor_ms`` is the device time
of an empty kernel, the floor under any kernel's time.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np


class StepTimer:
    """Rolling wall-clock statistics over training steps."""

    def __init__(self, window: int = 200):
        self.window = window
        self._durations: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        """Mark the end of a step."""
        now = time.perf_counter()
        if self._last is not None:
            self._durations.append(now - self._last)
            if len(self._durations) > self.window:
                self._durations.pop(0)
        self._last = now

    def reset_clock(self) -> None:
        """Forget the last timestamp (e.g. after an eval pause)."""
        self._last = None

    @property
    def durations(self) -> List[float]:
        """Seconds of the recorded steps, oldest first."""
        return list(self._durations)

    def stats(self, particles_per_step: Optional[int] = None) -> Dict[str, float]:
        if not self._durations:
            return {}
        d = np.asarray(self._durations)
        out = {
            "perf/ms_per_step": float(d.mean() * 1e3),
            "perf/ms_per_step_p50": float(np.percentile(d, 50) * 1e3),
            "perf/ms_per_step_p95": float(np.percentile(d, 95) * 1e3),
            "perf/steps_per_sec": float(1.0 / d.mean()),
        }
        if particles_per_step:
            out["perf/particle_steps_per_sec"] = float(particles_per_step / d.mean())
        return out


def device_ms(fn: Callable, iters: int = 20, warmup: int = 2,
              sleep_cycles: int = 20_000_000) -> float:
    """Milliseconds of device time per ``fn()`` call, by CUDA events.

    The card first spins for ``sleep_cycles`` clock cycles
    (``torch.cuda._sleep``) while the host enqueues all ``iters`` calls, so
    the events measure the calls back to back on the card and not the
    host's launch overhead (which bounds a short kernel's loop otherwise).
    Where the host took longer to enqueue than the card spun, it retries
    once with a 4x longer spin; a ``fn`` that synchronizes is measured with
    its host time.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(sleep_cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if host_ms < marks[0].elapsed_time(marks[1]):
            break
        sleep_cycles *= 4
    return marks[1].elapsed_time(marks[2]) / iters


def call_ms(fn: Callable, device, iters: int = 20, warmup: int = 2) -> float:
    """ms per ``fn()`` call: :func:`device_ms` on a CUDA device, the host
    clock over ``iters`` calls on the CPU."""
    if str(device).startswith("cuda"):
        return device_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def launch_floor_ms(device="cuda", iters: int = 200) -> float:
    """Device time (ms) of one launch of an empty kernel (one block of 32
    threads, ``lbt_empty`` in ``csrc/binning.cu``), by :func:`device_ms`."""
    import ctypes

    import torch

    from .ops.build import Kernel

    empty = Kernel("empty", "binning", "lbt_empty", [ctypes.c_void_p], replaces="")
    dev = torch.device(device)
    return device_ms(lambda: empty(device=dev), iters, 5)
