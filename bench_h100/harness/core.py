"""One run of one cell: the drivers by the mix's ``driver``, the metrics
by name, the comparison, and the result line."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np

from bench_h100.harness import cells, compare
from bench_h100.harness.readings import log



@dataclasses.dataclass
class Run:
    bench: dict
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    started: float          # the process's start, time.time()
    cache_dir: Optional[str] = cells.CACHE
    setup_s: Optional[float] = None

    def __post_init__(self):
        self.workload = cells.workload(self.bench, self.cell)
        self.config = cells.config(self.bench, self.workload["config"])
        self.mix = cells.mix(self.workload["traffic"])
        self.limits = cells.limits(self.cell)
        words = np.random.SeedSequence(self.seed).generate_state(2)
        self.job_seed, self.weight_seed = int(words[0]), int(words[1])

    def window_opened(self) -> None:
        self.setup_s = time.time() - self.started


def driver_module(name: str):
    """``harness/drivers/<name>.py``, the driver a mix names."""
    import importlib
    return importlib.import_module(f"bench_h100.harness.drivers.{name}")


def execute(r: Run) -> dict:
    """Runs the cell -> the result line's object."""
    import torch
    driver = driver_module(r.mix["driver"])
    readings, numbers, attempted, failed, memory = driver.run(r)
    readings.setup_s = r.setup_s
    correct, compared = compare.judge(numbers, r.limits)
    entries = (cells.per_layer(r.bench, r.cell) if r.trace
               else cells.end_to_end(r.bench, r.cell))
    metrics = {}
    for m in entries:
        value = cells.metric_reader(m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = r.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": r.workload["chips"], "memory_peak_bytes": memory}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    t = readings.trace
    if r.trace and t is not None:
        device["busy_s"], device["window_s"] = t.busy_s, t.window_s
        out["breakdown"] = t.breakdown()
    w = readings.window
    log(f"window: {w.seconds!r} s, {w.steps} steps, {w.replays} replays, "
        f"{w.structures} structures, spans {w.spans}")
    log(f"memory_peak_bytes: {memory}")
    for k, v in numbers.items():
        if k not in compared:
            log(f"reading {k} {v!r} (not compared)")
    for k, c in compared.items():
        log(f"compared {k} {c['value']!r} limit {c['limit']!r}")
    out["compared"] = compared
    return out


def finite(obj):
    """NaN and infinities as strings, so the line stays JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj
