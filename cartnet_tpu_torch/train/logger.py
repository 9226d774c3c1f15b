"""Epoch-stats logger: weighted per-epoch stats -> one ``stats.json`` per
split (port of cartnet_tpu/train/logger.py).

Each ``update`` adds one batch: its stats (device scalars, not read until
``write_epoch``, so a train epoch never waits on the card per batch), its
weight (non-H atoms for ADP targets, graphs for scalar targets), the lr,
the real edges and, for eval passes, the masked true/pred values that give
the epoch's r2 and Spearman correlation. ``write_epoch`` appends one JSON
line with the JAX package's keys and weighting: ``epoch``, ``time_epoch``,
``time_iter``, ``lr``, ``params``, the weighted means, ``edges_per_sec``,
``gpu_memory``, ``r2`` and ``spearmanr``. Two keys differ:

  * ``gpu_memory`` is ``torch.cuda.max_memory_allocated`` in GB on the
    card and absent on the CPU;
  * ``fused_fraction`` is omitted: it counts the batches that fell back
    from the JAX package's fused kernels to its XLA path, and the port has
    no such fallback (a wrapper runs its kernel or raises).

The wandb sink is not ported yet (ROADMAP P2b).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch


def eval_r2(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - np.mean(y_true)) ** 2))
    return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


def eval_spearman(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    def rank(a):
        order = np.argsort(a)
        r = np.empty_like(order, dtype=np.float64)
        r[order] = np.arange(len(a))
        # average ties
        _, inv, cnt = np.unique(a, return_inverse=True, return_counts=True)
        sums = np.zeros(len(cnt))
        np.add.at(sums, inv, r)
        return sums[inv] / cnt[inv]

    rt, rp = rank(y_true.ravel()), rank(y_pred.ravel())
    if rt.std() == 0 or rp.std() == 0:
        return 0.0
    return float(np.corrcoef(rt, rp)[0, 1])


def _host_floats(values) -> List[float]:
    """Python floats of a list of scalars (device tensors in one copy)."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    if not tensors:
        return [float(v) for v in values]
    host = iter(torch.stack([t.detach().float().reshape(())
                             for t in tensors]).cpu().tolist())
    return [next(host) if isinstance(v, torch.Tensor) else float(v)
            for v in values]


class EpochLogger:
    """One split's accumulator (train/val/test); ``device`` is where the
    run lives (``gpu_memory`` is read on the card only)."""

    def __init__(self, name: str, out_dir: Optional[str] = None,
                 device=None):
        self.name = name
        self.out_dir = out_dir
        self.device = torch.device(device) if device is not None else None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self.params = 0  # model parameter count
        self.reset()

    def reset(self):
        self._size = 0.0
        self._pending: List = []  # (stats, weight), stats maybe on device
        self._lr = 0.0
        self._time_used = 0.0
        self._iters = 0
        self._edges = 0.0
        self._true: List[np.ndarray] = []
        self._pred: List[np.ndarray] = []

    def update(self, stats: Dict, weight: float = 1.0, lr: float = 0.0,
               true=None, pred=None, edges: float = 0.0):
        self._size += weight
        self._pending.append((stats, weight))
        self._lr = lr
        self._iters += 1
        self._edges += edges
        if true is not None:
            self._true.append(np.asarray(true).ravel())
        if pred is not None:
            self._pred.append(np.asarray(pred).ravel())

    def note_time(self, seconds: float):
        """Add wall time measured around a whole pass (the train epoch is
        timed once, closed by a device synchronize)."""
        self._time_used += seconds

    def _memory_gb(self) -> Optional[float]:
        if self.device is None or self.device.type != "cuda":
            return None
        return round(torch.cuda.max_memory_allocated(self.device)
                     / (1024 ** 3), 4)

    def write_epoch(self, epoch: int) -> Dict:
        size = max(self._size, 1.0)
        keys = list(dict.fromkeys(k for s, _ in self._pending for k in s))
        sums: Dict[str, float] = {}
        for k in keys:  # one device copy per key, summed in batch order
            rows = [(s[k], w) for s, w in self._pending if k in s]
            for v, (_, w) in zip(_host_floats([v for v, _ in rows]), rows):
                sums[k] = sums.get(k, 0.0) + v * w
        stats = {"epoch": epoch,
                 "time_epoch": round(self._time_used, 5),
                 "time_iter": round(self._time_used / max(self._iters, 1), 6),
                 "lr": self._lr,
                 "params": self.params,
                 **{k: v / size for k, v in sums.items()}}
        if self._edges > 0 and self._time_used > 0:
            # real (unpadded) edges only
            stats["edges_per_sec"] = round(self._edges / self._time_used, 1)
        mem = self._memory_gb()
        if mem is not None:
            stats["gpu_memory"] = mem
        if self._true and self._pred:
            t = np.concatenate(self._true)
            p = np.concatenate(self._pred)
            stats["r2"] = eval_r2(t, p)
            stats["spearmanr"] = eval_spearman(t, p)
        logging.info("%s: %s", self.name, stats)
        if self.out_dir:
            with open(os.path.join(self.out_dir, "stats.json"), "a") as f:
                f.write(json.dumps(stats) + "\n")
        self.reset()
        return stats


def create_loggers(run_dir: Optional[str] = None, device=None):
    """Train/val/test loggers writing under ``run_dir/{train,val,test}``."""
    return [EpochLogger(n, os.path.join(run_dir, n) if run_dir else None,
                        device)
            for n in ("train", "val", "test")]
