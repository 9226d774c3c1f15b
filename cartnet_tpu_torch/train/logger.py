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

Under data parallelism (a process ``group``) each rank's logger holds its
own batches (each weighted by its own targets; a train step's stats are
already the union batch's): ``write_epoch`` sums the weighted stats, the
weights and the edges over the ranks in one all-reduce, gathers the
true/pred values on rank 0 for r2 and Spearman, and only rank 0 writes
``stats.json``. ``WandbLogger`` is the optional wandb sink: off unless
asked for, and a single warning, then nothing, when wandb is missing or
cannot start.
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
    run lives (``gpu_memory`` is read on the card only); ``group`` the
    data-parallel ranks whose batches it sums (the file is rank 0's)."""

    def __init__(self, name: str, out_dir: Optional[str] = None,
                 device=None, group=None):
        self.name = name
        self.group = group
        if group is not None and torch.distributed.get_rank(group) != 0:
            out_dir = None
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

    def _over_ranks(self, sums: Dict[str, float]) -> None:
        """Sums ``sums``, the weights and the edges over the group's ranks
        (in place), and gathers the true/pred values on rank 0."""
        dev = self.device or torch.device("cpu")
        keys = list(sums)
        flat = torch.tensor([self._size, self._edges]
                            + [sums[k] for k in keys], dtype=torch.float64,
                            device=dev)
        torch.distributed.all_reduce(flat, group=self.group)
        vals = flat.cpu().tolist()
        self._size, self._edges = vals[0], vals[1]
        sums.update(zip(keys, vals[2:]))
        mine = (np.concatenate(self._true) if self._true else None,
                np.concatenate(self._pred) if self._pred else None)
        main = torch.distributed.get_rank(self.group) == 0
        everyone = ([None] * torch.distributed.get_world_size(self.group)
                    if main else None)
        torch.distributed.gather_object(
            mine, everyone, dst=torch.distributed.get_global_rank(
                self.group, 0), group=self.group)
        parts = [p for p in everyone if p[0] is not None] if main else []
        self._true = [t for t, _ in parts]
        self._pred = [p for _, p in parts]

    def write_epoch(self, epoch: int) -> Dict:
        keys = list(dict.fromkeys(k for s, _ in self._pending for k in s))
        sums: Dict[str, float] = {}
        for k in keys:  # one device copy per key, summed in batch order
            rows = [(s[k], w) for s, w in self._pending if k in s]
            for v, (_, w) in zip(_host_floats([v for v, _ in rows]), rows):
                sums[k] = sums.get(k, 0.0) + v * w
        if self.group is not None:
            self._over_ranks(sums)
        size = max(self._size, 1.0)
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


def create_loggers(run_dir: Optional[str] = None, device=None, group=None):
    """Train/val/test loggers writing under ``run_dir/{train,val,test}``."""
    return [EpochLogger(n, os.path.join(run_dir, n) if run_dir else None,
                        device, group)
            for n in ("train", "val", "test")]


class WandbLogger:
    """The optional wandb sink (``--wandb``): one run, a ``log`` per epoch
    and a ``finish``. Off unless ``enabled``; wandb is imported only then,
    and when it is missing or cannot start, one warning is logged and every
    call does nothing."""

    def __init__(self, project: str = "", entity: str = "", name: str = "",
                 config=None, enabled: bool = False):
        self.run = None
        if not enabled:
            return
        try:
            import wandb
            self.run = wandb.init(project=project or None,
                                  entity=entity or None, name=name or None,
                                  config=config)
        except Exception as err:  # missing, offline or refused
            logging.warning("wandb disabled: %s", err)

    def log(self, data: Dict, step: Optional[int] = None):
        if self.run is not None:
            self.run.log(data, step=step)

    def finish(self):
        if self.run is not None:
            self.run.finish()
