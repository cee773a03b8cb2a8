"""From a torch.profiler trace of the window to the traced run's summary.

The profiler records CUDA activity alone: the device's kernels, copies and
sets, and the host's CUDA runtime calls. Recording every PyTorch op as well
cost the host-paced SAFA eval 31% of its rate, against 15% this way (on an
H100 80GB HBM3). Device time is split by kernel name, as ``chip_smoke.device_split_us``
does: the port launches its kernels through ctypes, so no PyTorch op owns
them, and their names are the only attribution. Busy time is the union of the
device intervals, so that work overlapping on two streams counts once. Each
idle gap is put down to the CUDA call the host was in at its middle, or to
``host`` where it was in none (Python, PyTorch's dispatch, the allocator).
The window's bounds come from the host's clock (``time.time_ns``), the
profiler's time base.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

class Event(NamedTuple):
    name: str
    on_device: bool
    start_ns: int
    dur_ns: int


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged [start, end) intervals, sorted."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label_gaps(spans: List[Tuple[int, int, str]], gaps: List[Tuple[int, int]]) -> Dict[str, float]:
    """Idle seconds by the innermost host event open at each gap's middle,
    ``host`` where none is. One sweep over ``spans`` (sorted by start, the
    longer first at one start) with a stack of open events: host events of
    one thread nest."""
    idle: Dict[str, float] = collections.defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        idle[stack[-1][2] if stack else "host"] += (g1 - g0) * 1e-9
    return idle


def summarize(events: Iterable[Event], window: Tuple[int, int], top: int = 10) -> Dict:
    """The window's device summary: ``window_s``, ``busy_s`` (the union of
    device intervals clipped to the window), ``kernels`` (device events
    started in it), ``by_name`` {device event name: seconds}, and the
    contract's ``breakdown``: the ``top`` device ops by time and the idle
    seconds by the innermost host event at each gap's middle."""
    w0, w1 = window
    device, spans = [], []
    for e in events:
        end = e.start_ns + e.dur_ns
        if not e.on_device:
            spans.append((e.start_ns, end, e.name))
        elif w0 <= e.start_ns < w1:
            device.append(e)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        by_name[e.name] += e.dur_ns * 1e-9
    busy = union((e.start_ns, min(e.start_ns + e.dur_ns, w1)) for e in device)
    busy_ns = sum(e - s for s, e in busy)
    spans.sort(key=lambda sp: (sp[0], -sp[1]))  # at one start the enclosing span first
    gaps, t = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    idle = _label_gaps(spans, gaps)
    by_time = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "kernels": len(device),
        "by_name": dict(by_name),
        "breakdown": {"device_ops": [[n, s] for n, s in by_time],
                      "idle_gaps": [[n, s] for n, s in gaps]},
    }


def kernel_seconds(summary: Dict, fragment: str) -> float:
    """Device seconds of the events whose name holds ``fragment``."""
    return sum(s for n, s in summary["by_name"].items() if fragment in n)


def kineto_events(prof) -> List[Event]:
    """The profiler's raw events (no FunctionEvent tree is built: a window
    holds some hundred thousand)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # An annotation's copy on the device's timeline is no work.
    return [Event(e.name(), e.device_type() == cuda, e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if not (e.device_type() == cuda and e.is_user_annotation())]


class Tracer:
    """torch.profiler's CUDA activity around the window, or a no-op."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def __enter__(self) -> "Tracer":
        if self.enabled:
            import torch

            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def summary(self, window_ns: Tuple[int, int]) -> Optional[Dict]:
        """The summary of the window [start, end) in ``time.time_ns``."""
        if self.prof is None:
            return None
        return summarize(kineto_events(self.prof), window_ns)
