"""Step-time / pairs-per-second counter (port of
witw_tpu/utils/profiling.py:StepTimer) and a device timer. Host clock: on
the card, a step's time is right only where the loop synchronizes once a
step (the train loop fetches each loss one step late). :func:`cuda_ms` times
device work with CUDA events, :func:`graph_ms` launch-bound work;
:func:`trace_profile` records a torch.profiler trace of a run."""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch


def cuda_ms(fn: Callable[[], object], calls: int, reps: int) -> float:
    """Median device ms per call of ``fn`` over ``reps`` runs of ``calls``
    calls each, CUDA events around each run, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn: Callable[[], object], calls: int = 64, reps: int = 5) -> float:
    """Device ms per call of ``fn`` from a CUDA graph of ``calls``
    back-to-back calls (median of ``reps`` replays): for work that takes less
    device time than the host takes to launch it. ``fn`` runs once on a side
    stream first, so that library calls pick their kernels before capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, 1, reps) / calls


@contextlib.contextmanager
def trace_profile(profile_dir: Optional[str]) -> Iterator[None]:
    """Record a torch.profiler trace (host, and the card's kernels where
    CUDA is available) of the body into ``profile_dir`` as a Chrome /
    TensorBoard trace file; a no-op when ``profile_dir`` is None."""
    if profile_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir)):
        yield


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
