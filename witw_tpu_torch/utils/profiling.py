"""Step-time / pairs-per-second counter (port of
witw_tpu/utils/profiling.py:StepTimer), device timers and the program's
spans. Host clock: on the card, a step's time is right only where the loop
synchronizes once a step (the train loop fetches each loss one step late).
:func:`cuda_ms` times device work with CUDA events, :func:`graph_ms`
launch-bound work; :func:`trace_profile` records a torch.profiler trace of a
run.

:func:`span` marks a layer of the program (``with span("rank"):``). It
records only while a torch profiler records (``trace_profile``, or any
``torch.profiler.profile``); otherwise it returns one shared no-op object,
at the cost of a flag read. While one records, a span keeps its name, its
parent and root spans (a per-thread stack: every span of one batch or
request shares its root), its start and end on ``time.time_ns()`` (the
profiler's clock), a range of its name in the trace where the profiler
records host activity (``trace_profile`` does), and, for a span opened with
``stretch=True`` where CUDA is initialised, two timing events on the
current stream, whose elapsed time is the span's device stretch: the part
of the in-order stream between its markers, busy or waiting. Records go
into one bounded buffer of ``SPAN_CAPACITY``; past it spans are counted in
:func:`dropped` and not kept. :func:`spans` returns the records,
:func:`reset` clears them; :func:`spanned` runs each call of a function in
a span.

Spans of the program (* with a device stretch): ``eval``
(``train.loop.embed_all``, ``test_ranks``); ``embed`` (``embed_step``) with
``preprocess`` *, ``tower.surface``, ``tower.overhead``; ``rank`` *
(``FovGalleryEvaluator.ranks``, ``euclidean_ranks``) with ``rank.true``,
``rank.block`` (one a query block; the FOV sweep's on one device only) and
``rank.fetch``; ``recall`` (``metrics_from_ranks``); ``train.step`` with
``train.forward`` (in it ``preprocess`` and the towers), ``train.backward``,
``train.optimizer``; ``draw`` (the crop origins or rotations, in training
and eval alike, and the dropout masks); ``convnext.mixer`` * and
``convnext.mlp`` * (each ConvNeXt block's, under ``tower.*``);
``serve.decode``, and ``serve.dispatch`` with ``serve.embed`` and ``serve.search``
(``tools.serve.GeolocateService``)."""

from __future__ import annotations

import contextlib
import functools
import statistics
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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


SPAN_CAPACITY = 1 << 19  # records kept between resets; past it spans are counted as dropped

_records: List["_Span"] = []  # the kept spans, in the order they opened
_dropped = 0
_lock = threading.Lock()
_local = threading.local()  # .stack: the thread's open spans
# A profiler range that costs a flag check unless the profiler records host
# activity (the benchmark's CUDA-only trace does not); torch.profiler's
# record_function costs a dispatcher call on every entry.
_Range = torch._C._profiler._RecordFunctionFast


class SpanRecord(NamedTuple):
    """One span: ``parent`` and ``root`` are indices into the same list
    (None for a root's parent, or where that span was not kept); the
    stamps are ``time.time_ns()``; ``device_s`` is the device stretch in
    seconds (None without CUDA events, or while the span is open)."""

    name: str
    parent: Optional[int]
    root: Optional[int]
    start_ns: int
    end_ns: Optional[int]
    device_s: Optional[float]


def _stack() -> List["_Span"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(s: "_Span") -> None:
    global _dropped
    with _lock:
        if len(_records) < SPAN_CAPACITY:
            _records.append(s)
        else:
            _dropped += 1


class _NoSpan:
    """What :func:`span` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _NoSpan()


class _Span:
    __slots__ = ("name", "parent", "root", "start_ns", "end_ns", "device_s", "_range",
                 "_stretch", "_events")

    def __init__(self, name: str, stretch: bool):
        self.name = name
        self._stretch = stretch
        self.end_ns = self.device_s = self._events = None

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.root = self if self.parent is None else self.parent.root
        _keep(self)
        stack.append(self)
        self.start_ns = time.time_ns()
        self._range = _Range(self.name)
        self._range.__enter__()
        if self._stretch and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start, None)
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events = (self._events[0], end)
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        _stack().pop()
        return False


def span(name: str, stretch: bool = False):
    """A context manager marking one layer's work as the span ``name``
    (module docstring); a shared no-op while no torch profiler records.
    ``stretch``: also time the span's device stretch (two timing events,
    some 25 us of host time a span beside an H100, so only where read)."""
    return _Span(name, stretch) if _autograd_profiler._is_profiler_enabled else _OFF


def spans() -> List[SpanRecord]:
    """The kept spans in the order they opened, their device stretches
    resolved (one synchronisation of each device they were recorded on)."""
    with _lock:
        kept = list(_records)
    pending = [s for s in kept if s._events is not None and s._events[1] is not None]
    for device in {s._events[1].device for s in pending}:
        torch.cuda.synchronize(device)
    for s in pending:
        start, end = s._events
        s.device_s = start.elapsed_time(end) * 1e-3
        s._events = None
    index = {id(s): i for i, s in enumerate(kept)}
    return [SpanRecord(s.name, None if s.parent is None else index.get(id(s.parent)),
                       index.get(id(s.root)), s.start_ns, s.end_ns, s.device_s) for s in kept]


def dropped() -> int:
    """Spans not kept since the last :func:`reset`: the buffer was full."""
    return _dropped


def reset() -> None:
    """Forget every kept span and the dropped count."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def spanned(name: str, stretch: bool = False) -> Callable[[Callable], Callable]:
    """A decorator: each call of the function runs in ``span(name, stretch)``."""

    def decorate(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name, stretch):
                return fn(*args, **kwargs)

        return wrapper

    return decorate
