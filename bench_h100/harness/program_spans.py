"""The program's own spans and counters (``cartnet_tpu_torch.tracing``),
as the traced stretch recorded them: the tracer records while a torch
profiler does, and the stretch is a run's last profiler session, so once
the window has closed its tables hold the stretch alone. A program
without the tracer, a run without a trace, or another driver gives
``None``, as does a span the stretch did not see."""

from __future__ import annotations

from typing import Optional


def session(r, kind: str) -> Optional[dict]:
    """The tracer's tables of the stretch of ``r`` (``readings.Readings``)
    if its driver is ``kind`` ("train" or "infer")."""
    if r.trace is None or r.window.kind != kind:
        return None
    try:
        from cartnet_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.table()


def span(r, kind: str, name: str) -> Optional[tuple]:
    """(count, total s, self s) of the span ``name``, or None."""
    t = session(r, kind)
    row = None if t is None else t["spans"].get(name)
    return row if row and row[0] else None


def mean_ms(r, kind: str, name: str) -> Optional[float]:
    """The span's mean duration in ms per occurrence."""
    row = span(r, kind, name)
    return None if row is None else 1e3 * row[1] / row[0]
