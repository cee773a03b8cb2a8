"""Step-time / pairs-per-second counter (port of
witw_tpu/utils/profiling.py:StepTimer). Host clock: on the card, a step's
time is right only where the loop synchronizes once a step (the train loop
fetches each loss one step late)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class StepTimer:
    """Track per-step wall time and throughput, skipping ``warmup`` steps."""

    def __init__(self, items_per_step: int, warmup: int = 2):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self._last: Optional[float] = None
        self._times: List[float] = []
        self._steps = 0

    def tick(self) -> Optional[float]:
        """Call once per step; returns the last step's duration (or None)."""
        now = time.perf_counter()
        duration = None
        if self._last is not None:
            duration = now - self._last
            self._steps += 1
            if self._steps > self.warmup:
                self._times.append(duration)
        self._last = now
        return duration

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    @property
    def items_per_sec(self) -> float:
        return self.steps_per_sec * self.items_per_step

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        times = sorted(self._times)
        return {
            "steps": len(self._times),
            "step_time_mean_s": sum(times) / len(times),
            "step_time_p50_s": times[len(times) // 2],
            "step_time_max_s": times[-1],
            "steps_per_sec": self.steps_per_sec,
            "items_per_sec": self.items_per_sec,
        }
