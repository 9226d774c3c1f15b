"""Host spans the benchmark records around its calls into the program:
total seconds and count per name, and in a traced run a profiler range
(``bench.<name>``) that labels the device's idle gaps."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.autograd.profiler import record_function
            rf = record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def add(self, name: str, seconds: float) -> None:
        """A span timed by the caller."""
        self.total[name] += seconds
        self.count[name] += 1

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()

    def table(self) -> dict:
        return {k: (self.total[k], self.count[k]) for k in self.total}
