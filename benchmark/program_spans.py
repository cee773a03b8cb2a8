"""The program's own spans (``witw_tpu_torch.utils.profiling.span``), as
the per-layer readers take them. The program records spans only while a
profiler records, and ``--trace 1`` runs the profiler around the window
alone, so the kept spans are the window's. A program without spans, a
window that kept none or dropped any, or spans with no device stretch (no
CUDA events) give nothing to read."""

from __future__ import annotations

from typing import List, Optional


def window() -> Optional[List]:
    """The window's span records, or None where there is nothing sound to
    read."""
    try:
        from witw_tpu_torch.utils import profiling

        read, dropped = profiling.spans, profiling.dropped
    except (ImportError, AttributeError):
        return None
    records = read()
    if not records or dropped() or all(r.device_s is None for r in records):
        return None
    return records


def closed(records: List, name: str) -> List:
    """The spans named ``name`` that ended and have a device stretch."""
    return [r for r in records
            if r.name == name and r.end_ns is not None and r.device_s is not None]


def device_seconds(records: List, name: str) -> float:
    """Summed device stretches of the spans named ``name``."""
    return sum(r.device_s for r in closed(records, name))

