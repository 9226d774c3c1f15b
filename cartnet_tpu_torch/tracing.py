"""Spans and counters inside the port, recorded only while a torch
profiler records (``torch.profiler.profile``: the runner's ``--profile``
epoch, or a benchmark's traced stretch). There is no switch of its own.

``span(name)`` is a context manager around one piece of host work and
``count(name, n)`` adds to a counter. While no profiler records, ``span``
reads one attribute (torch's process-wide ``_is_profiler_enabled``) and
hands back one shared no-op, and ``count`` returns at once; a torch
without that attribute never records.

While one records, a span keeps its name, thread, parent (the span open
around it on the same thread) and its start and end, on the profiler's
clock: ``perf_counter_ns`` for the duration, put on the wall clock
(``time.time_ns()``, which the profiler's CPU events use) by an anchor
taken once a session. On a thread the profiler itself follows (one
started after the profiler) the span also opens a ``record_function`` of
its name, so it shows among the kernels in the profiler's timeline; on a
thread started earlier, such as a prefetch thread, only the tables below
see it.

The tables, one set a session (cleared when a profiler starts recording
again, kept after it stops): per span name its count, total and self
time (total less the spans nested in it on its thread); the counters;
and the latest ``RAW_SPANS`` spans themselves. ``table()`` returns them;
``format_table()`` is the operator's view of them.

The spans cover the host layers: the data layer (``data.batch`` and its
``data.fetch`` / ``data.augment`` / ``data.reorder`` / ``data.collate``
on the producer, ``data.wait`` where the consumer waits for it; collate
counts each batch's 64-edge tiles, ``batch.edge_tiles``, and those up to
its tail of pads, ``batch.edge_tiles_live``, the tiles the edge kernels
compute), the
hand-off (``batch.to_device`` with the counters
``batch.to_device.copies`` and ``batch.to_device.bytes``), the model's
host side (``model.forward`` and its ``model.encoder``, ``model.layer``,
``model.equivariant``, ``model.head``) and the fused chunk
(``chunk.run`` and its ``chunk.wait``, ``chunk.stack``, ``chunk.copy``,
``chunk.replay``, ``chunk.clone``).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List

import torch

RAW_SPANS = 100_000  # the raw spans kept a session, the latest


class _Off:
    _is_profiler_enabled = False


# torch's process-wide "a profiler records" flag and the hook that sets
# it at a profiler's start (torch.autograd.profiler); without both,
# nothing records
_profiler = torch.autograd.profiler
if not (hasattr(_profiler, "_is_profiler_enabled")
        and hasattr(_profiler, "_run_on_profiler_start")):
    _profiler = _Off
# whether the profiler follows the calling thread (false on threads
# started before it)
_thread_followed = getattr(torch._C._autograd, "_profiler_enabled",
                           lambda: False)


class _NoSpan:
    """The shared span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Tracer:
    """One session's tables; ``reset`` starts a new session."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.spans: Dict[str, List[int]] = {}  # name -> [n, total, self]
            self.counters: Dict[str, int] = collections.defaultdict(int)
            self.raw = collections.deque(maxlen=RAW_SPANS)
            self.anchor_ns = time.time_ns() - time.perf_counter_ns()

    def stack(self) -> list:
        """The calling thread's open spans, innermost last."""
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def record(self, name: str, parent, t0: int, t1: int,
               child_ns: int) -> None:
        with self.lock:
            row = self.spans.get(name)
            if row is None:
                row = self.spans[name] = [0, 0, 0]
            row[0] += 1
            row[1] += t1 - t0
            row[2] += t1 - t0 - child_ns
            self.raw.append((name, threading.get_ident(), parent,
                             self.anchor_ns + t0, self.anchor_ns + t1))

    def add(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] += n

    def table(self) -> dict:
        """``spans``: name -> (count, total s, self s); ``counters``:
        name -> total; ``raw``: (name, thread ident, parent name or None,
        start ns, end ns) on the wall clock, oldest first."""
        with self.lock:
            return {"spans": {k: (n, tot * 1e-9, own * 1e-9)
                              for k, (n, tot, own) in self.spans.items()},
                    "counters": dict(self.counters),
                    "raw": list(self.raw)}


class _Span:
    __slots__ = ("tracer", "name", "parent", "rf", "t0", "child_ns")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        stack = self.tracer.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self.rf = None
        self.t0 = time.perf_counter_ns()
        if _thread_followed():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        self.tracer.stack().pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += t1 - self.t0
        self.tracer.record(self.name,
                           None if parent is None else parent.name,
                           self.t0, t1, self.child_ns)
        return False


TRACER = Tracer()


def recording() -> bool:
    """Whether a profiler records (and spans and counters with it)."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A span of ``name`` around a ``with`` block (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(TRACER, name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        TRACER.add(name, n)


def table() -> dict:
    """The tables of the current or the last session (``Tracer.table``)."""
    return TRACER.table()


def format_table() -> str:
    """Per span its count, total ms and self ms, then the counters."""
    t = table()
    width = max([len(k) for k in list(t["spans"]) + list(t["counters"])]
                + [4])
    lines = [f"{'span':<{width}} {'count':>8} {'total ms':>12} "
             f"{'self ms':>12}"]
    for k, (n, tot, own) in sorted(t["spans"].items(),
                                    key=lambda kv: -kv[1][1]):
        lines.append(f"{k:<{width}} {n:>8} {tot * 1e3:>12.3f} "
                     f"{own * 1e3:>12.3f}")
    for k, v in sorted(t["counters"].items()):
        lines.append(f"{k:<{width}} {v:>8}")
    return "\n".join(lines)


def _hook_profiler_start() -> None:
    """A new session at each profiler start: torch calls
    ``_run_on_profiler_start`` from the module's globals as it sets the
    flag, and the wrapper starts the tables afresh after it."""
    start = _profiler._run_on_profiler_start

    def hooked():
        start()
        TRACER.reset()

    _profiler._run_on_profiler_start = hooked


if _profiler is not _Off:
    _hook_profiler_start()
