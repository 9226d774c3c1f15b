"""Failure detection and recovery (port of cartnet_tpu/train/guard.py).

1. **Device-side step guard**: a micro-step whose loss or gradients are
   not finite contributes zero gradient, keeps the previous BN running
   stats, does not advance the accumulation count and adds one to
   ``bad_steps``. Everything stays on the device: no host sync per step.
   Selects use ``torch.where``, never a multiplication by a 0/1 mask (NaN
   * 0 is NaN).
2. **Host-side divergence policy** (``GuardMonitor``): once an epoch the
   runner reports the bad-step count and the val metric; a non-finite val
   metric or an epoch bad-step share above ``max_bad_fraction`` asks for a
   rollback to the last checkpoint, at most ``max_retries`` times a run,
   after which it raises.
3. **Heartbeat**: an atomic JSON file (write to a temporary name, then
   ``os.replace``) with the epoch loop's status, re-written every
   ``interval`` seconds by a background thread, so a supervisor tells a
   hung process from a slow epoch (``is_stale``) without touching it.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any, Dict, Optional, Sequence

import torch


def tree_all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Scalar bool tensor: every element of every float tensor is finite."""
    oks = [torch.isfinite(t).all() for t in tensors
           if t is not None and t.is_floating_point()]
    if not oks:
        return torch.tensor(True)
    return torch.stack(oks).all()


def step_finite(loss, grads) -> torch.Tensor:
    """Scalar bool tensor: the loss and every gradient are finite."""
    return torch.isfinite(loss) & tree_all_finite(grads)


def select_step(keep, grads, new_bn, old_bn):
    """-> (grads', bn'): the step's gradients and BN stats where the device
    bool ``keep`` holds, else zero gradients and the old BN stats."""
    grads = [torch.where(keep, g, 0.0) for g in grads]
    bn = [torch.where(keep, a, b) for a, b in zip(new_bn, old_bn)]
    return grads, bn


def guard_contribution(loss, grads, new_bn, old_bn):
    """-> (ok, grads', bn'): zero grads and the old BN stats where the step
    is not finite."""
    ok = step_finite(loss, grads)
    grads, bn = select_step(ok, grads, new_bn, old_bn)
    return ok, grads, bn


class Heartbeat:
    """Atomic heartbeat file writer with an optional background pulse.

    ``beat(**fields)`` merges the fields into the payload and writes it;
    ``start()`` re-writes the last payload every ``interval`` seconds (only
    ``time`` moves). Without a path every call does nothing."""

    def __init__(self, path: Optional[str], interval: float = 30.0):
        self.path = path
        self.interval = interval
        self._payload: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, **fields) -> None:
        if not self.path:
            return
        with self._lock:
            self._payload = {**self._payload, **fields}
        self._write()

    def _write(self) -> None:
        with self._lock:
            payload = {**self._payload, "time": time.time(),
                       "pid": os.getpid()}
        # one temporary name a thread: the pulse and ``beat`` may write at
        # once, and a shared name would let one replace the other's file
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    def start(self) -> None:
        if not self.path or self._thread is not None:
            return
        self._stop.clear()

        def pulse():
            while not self._stop.wait(self.interval):
                try:
                    self._write()
                except OSError:  # a dead pulse reads as a stale heartbeat
                    logging.exception("heartbeat pulse write failed")

        self._thread = threading.Thread(target=pulse, daemon=True)
        self._thread.start()

    def stop(self, status: str = "stopped") -> None:
        """Ends the pulse and writes ``status`` ("failed" when the run
        raised)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.beat(status=status)


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    """The heartbeat's payload, or None if it is missing or unreadable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_stale(path: str, timeout: float, now: Optional[float] = None) -> bool:
    """True if the heartbeat is missing or older than ``timeout`` seconds."""
    hb = read_heartbeat(path)
    if hb is None or "time" not in hb:
        return True
    return ((now if now is not None else time.time()) - hb["time"]) > timeout


class GuardMonitor:
    """Host-side divergence policy for the epoch loop.

    ``epoch_report`` once an epoch with the run's total bad-step count ->
    True when the runner should roll back; beyond ``max_retries``
    rollbacks it raises. ``initial_bad_steps`` is a resumed state's count,
    so the first epoch's delta holds that epoch's bad steps only."""

    def __init__(self, max_bad_fraction: float = 0.5, max_retries: int = 2,
                 initial_bad_steps: int = 0):
        self.max_bad_fraction = max_bad_fraction
        self.max_retries = max_retries
        self.retries = 0
        self._last_bad = int(initial_bad_steps)

    def epoch_report(self, bad_steps_total: int, micro_steps: int,
                     val_metric: float) -> bool:
        bad_delta = bad_steps_total - self._last_bad
        self._last_bad = bad_steps_total
        frac = bad_delta / max(micro_steps, 1)
        diverged = (not math.isfinite(val_metric)) or (
            frac > self.max_bad_fraction)
        if not diverged:
            return False
        if self.retries >= self.max_retries:
            raise RuntimeError(
                f"training diverged (bad-step fraction {frac:.2f}, val "
                f"{val_metric}) and retry budget ({self.max_retries}) is "
                "exhausted")
        self.retries += 1
        return True

    def note_rollback(self, bad_steps_total_after: int) -> None:
        """Re-base the bad-step delta after the state was restored."""
        self._last_bad = bad_steps_total_after
