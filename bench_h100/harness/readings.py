"""What a run measured, as the metric readers (``metrics/*.py``) see it."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Optional, Tuple

from bench_h100.harness.trace import Trace


@dataclasses.dataclass
class Window:
    kind: str        # "train" or "infer": the driver that ran
    seconds: float   # the window's wall time
    steps: int       # micro-steps (train) or batches (infer) completed
    replays: int     # fused chunks, one CUDA-graph replay each (train)
    structures: int  # real crystals of those steps
    flops: float     # model FLOPs of those steps (flops.py)
    spans: Dict[str, Tuple[float, int]]  # host span -> (seconds, count)


@dataclasses.dataclass
class Readings:
    config: dict
    window: Window
    trace: Optional[Trace] = None
    setup_s: Optional[float] = None

    @property
    def peak_flops(self) -> float:
        return float(self.config["peak_flops"])


def batch_counts(batch) -> dict:
    """A host batch's real and padded sizes (numpy masks)."""
    return {"nodes": int(batch.node_mask.sum()),
            "edges": int(batch.edge_mask.sum()),
            "graphs": int(batch.graph_mask.sum()),
            "nodes_pad": int(batch.node_mask.shape[0]),
            "edges_pad": int(batch.edge_mask.shape[0])}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Clock:
    """Laps of the set-up, for its log line."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = round(now - self.t, 3)
        self.t = now
