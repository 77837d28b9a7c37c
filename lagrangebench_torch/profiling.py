"""Step timing for the trainer.

Counterpart of ``lagrangebench_tpu/profiling.py``'s ``StepTimer``: rolling
wall-clock statistics (mean/p50/p95, steps/s, particle-steps/s) reported at
every log interval. The trainer synchronizes the card before each tick, so
a duration is the step's time on the host clock, device work included.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

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
