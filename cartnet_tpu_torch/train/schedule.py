"""Adam + OneCycle with PyTorch OneCycleLR semantics (port of
cartnet_tpu/train/schedule.py).

The reference builds ``OneCycleLR(opt, max_lr=lr, total_steps=max_epoch *
len(loader) // accum + max_epoch, pct_start=warmup)``: two-phase cosine
anneal from max_lr / div_factor up to max_lr and down to initial_lr /
final_div_factor, with Adam's beta1 cycling max_momentum -> base_momentum ->
max_momentum. ``OneCycleAdam`` is ``torch.optim.Adam`` whose lr and beta1
are set from the schedules at the optimizer's update count before every
update, counting from 0 as optax's ``inject_hyperparams`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

import torch


def reference_total_steps(max_epoch: int, steps_per_epoch: int,
                          batch_accumulation: int) -> int:
    """total_steps exactly as the reference computes it."""
    return max_epoch * steps_per_epoch // batch_accumulation + max_epoch


def _cos_anneal(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))


def _phases(total_steps: int, pct_start: float):
    return float(pct_start * total_steps) - 1.0, float(total_steps) - 1.0


def _pcts(count, phase1_end: float, phase2_end: float):
    t = min(float(count), phase2_end)
    clip = lambda v: min(max(v, 0.0), 1.0)
    return (t, clip(t / max(phase1_end, 1e-8)),
            clip((t - phase1_end) / max(phase2_end - phase1_end, 1e-8)))


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.01,
                div_factor: float = 25.0, final_div_factor: float = 1e4
                ) -> Callable[[int], float]:
    """Update count -> learning rate."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    p1, p2 = _phases(total_steps, pct_start)

    def schedule(count) -> float:
        t, pct1, pct2 = _pcts(count, p1, p2)
        if t <= p1:
            return _cos_anneal(initial_lr, max_lr, pct1)
        return _cos_anneal(max_lr, min_lr, pct2)

    return schedule


def onecycle_beta1(total_steps: int, pct_start: float = 0.01,
                   base_momentum: float = 0.85, max_momentum: float = 0.95
                   ) -> Callable[[int], float]:
    """Update count -> Adam beta1 (cycle_momentum=True)."""
    p1, p2 = _phases(total_steps, pct_start)

    def schedule(count) -> float:
        t, pct1, pct2 = _pcts(count, p1, p2)
        if t <= p1:
            return _cos_anneal(max_momentum, base_momentum, pct1)
        return _cos_anneal(base_momentum, max_momentum, pct2)

    return schedule


class OneCycleAdam:
    """Adam driven by the OneCycle schedules; ``step(grads)`` applies one
    update from a list of gradients aligned with ``params``."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr_fn: Callable[[int], float],
                 b1_fn: Optional[Callable[[int], float]] = None,
                 grad_clip: Optional[float] = None):
        self.params = list(params)
        self.lr_fn, self.b1_fn, self.grad_clip = lr_fn, b1_fn, grad_clip
        self.count = 0  # updates applied
        self.adam = torch.optim.Adam(self.params, lr=lr_fn(0),
                                     betas=(self._b1(0), 0.999), eps=1e-8)

    def _b1(self, count: int) -> float:
        return self.b1_fn(count) if self.b1_fn is not None else 0.9

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, g in zip(self.params, grads):
            p.grad = g
        if self.grad_clip is not None:
            torch.nn.utils.clip_grad_norm_(self.params, self.grad_clip)
        for group in self.adam.param_groups:
            group["lr"] = self.lr_fn(self.count)
            group["betas"] = (self._b1(self.count), 0.999)
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.count += 1

    def state_dict(self) -> dict:
        """Adam's moments and step counts, and the update count that
        drives the schedules."""
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd["adam"])
        self.count = int(sd["count"])


def make_optimizer(params, max_lr: float, total_steps: int,
                   pct_start: float = 0.01, div_factor: float = 25.0,
                   final_div_factor: float = 1e4,
                   cycle_momentum: bool = True, base_momentum: float = 0.85,
                   max_momentum: float = 0.95,
                   grad_clip: Optional[float] = None) -> OneCycleAdam:
    """Adam + OneCycle over ``params``."""
    lr = onecycle_lr(max_lr, total_steps, pct_start, div_factor,
                     final_div_factor)
    b1 = (onecycle_beta1(total_steps, pct_start, base_momentum, max_momentum)
          if cycle_momentum else None)
    return OneCycleAdam(params, lr, b1, grad_clip)
