"""Adam + OneCycle with PyTorch OneCycleLR semantics (port of
cartnet_tpu/train/schedule.py).

The reference builds ``OneCycleLR(opt, max_lr=lr, total_steps=max_epoch *
len(loader) // accum + max_epoch, pct_start=warmup)``: two-phase cosine
anneal from max_lr / div_factor up to max_lr and down to initial_lr /
final_div_factor, with Adam's beta1 cycling max_momentum -> base_momentum ->
max_momentum. ``OneCycleAdam`` is ``torch.optim.Adam`` whose lr and beta1
are set from the schedules at the optimizer's update count before every
update, counting from 0 as optax's ``inject_hyperparams`` does.

``OneCycleAdam.step_where`` is the same update driven from the device, for
fused epochs (a CUDA graph bakes in every host number): the update count
is a device tensor, lr and beta1 are gathered from tables of the schedules
over ``total_steps + 1`` counts (both are constant past the cycle's end),
and the whole update (Adam's moments, the weights, the count) is applied
in place where a device bool holds and leaves every tensor as it was where
it does not, with no host sync. It keeps ``torch.optim.Adam``'s state
(``exp_avg``, ``exp_avg_sq``, ``step``), so one ``state_dict`` serves both
paths; ``sync_count`` brings the host count and Adam's step counts up to
the device count (one host read).
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


BETA2, EPS = 0.999, 1e-8


class OneCycleAdam:
    """Adam driven by the OneCycle schedules; ``step(grads)`` applies one
    update from a list of gradients aligned with ``params``;
    ``step_where(grads, pred)`` the same from the device (needs
    ``total_steps``, the schedules' length)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr_fn: Callable[[int], float],
                 b1_fn: Optional[Callable[[int], float]] = None,
                 grad_clip: Optional[float] = None,
                 total_steps: Optional[int] = None):
        self.params = list(params)
        self.lr_fn, self.b1_fn, self.grad_clip = lr_fn, b1_fn, grad_clip
        self.total_steps = total_steps
        self.count = 0  # updates applied
        self.adam = torch.optim.Adam(self.params, lr=lr_fn(0),
                                     betas=(self._b1(0), BETA2), eps=EPS)
        # the device count and the schedules' tables (step_where)
        self.count_t: Optional[torch.Tensor] = None
        self._tables: Optional[tuple] = None

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
        if self.count_t is not None:
            self.count_t.add_(1)

    def device_state(self) -> list:
        """The tensors ``step_where`` reads and writes in place: the device
        count, the schedules' tables, Adam's moments (created as
        ``torch.optim.Adam`` creates them, before its first update)."""
        dev = self.params[0].device
        if self.count_t is None:
            if self.total_steps is None:
                raise ValueError("step_where needs the schedules' "
                                 "total_steps")
            counts = range(self.total_steps + 1)
            f64 = dict(dtype=torch.float64, device=dev)
            self._tables = (torch.tensor([self.lr_fn(c) for c in counts],
                                         **f64),
                            torch.tensor([self._b1(c) for c in counts],
                                         **f64))
            self.count_t = torch.tensor(self.count, dtype=torch.int64,
                                        device=dev)
        for p in self.params:
            st = self.adam.state[p]
            if not st:
                st["step"] = torch.tensor(float(self.count))
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
        moments = [self.adam.state[p][k] for k in ("exp_avg", "exp_avg_sq")
                   for p in self.params]
        return [self.count_t, *self._tables, *moments]

    @torch.no_grad()
    def step_where(self, grads: Sequence[torch.Tensor],
                   pred: torch.Tensor) -> None:
        """``step(grads)`` where the device bool ``pred`` holds, read and
        applied on the device: lr and beta1 at the device count, Adam's
        bias corrections from it (f64, rounded to f32 where
        torch.optim.Adam rounds its host numbers: on the CPU the update is
        that of its single-tensor path to the bit), the gradients clipped
        by their global norm (``grad_clip``), then the count advances by
        ``pred``. Where ``pred`` is false the gradients enter scaled by 0
        and every step size is 0: the moments, the weights and the count
        keep their values exactly. ``grads`` are read, never written."""
        count, lr_t, b1_t, *_ = self.device_state()
        ms = [self.adam.state[p]["exp_avg"] for p in self.params]
        vs = [self.adam.state[p]["exp_avg_sq"] for p in self.params]
        on = pred.to(torch.float64)
        idx = torch.clamp(count, max=self.total_steps).reshape(1)
        lr, b1 = lr_t.index_select(0, idx)[0], b1_t.index_select(0, idx)[0]
        t = (count + 1).to(torch.float64)
        scale = on
        if self.grad_clip is not None:  # clip_grad_norm_'s arithmetic
            norms = torch._foreach_norm(list(grads), 2)
            total = torch.linalg.vector_norm(torch.stack(norms), 2)
            scale = on * torch.clamp(self.grad_clip / (total + 1e-6),
                                     max=1.0).to(torch.float64)
        f32 = lambda x: x.to(torch.float32)
        g = torch._foreach_mul(list(grads), f32(scale))
        w = f32(on * (1.0 - b1))
        for m, gi in zip(ms, g):
            m.lerp_(gi, w)
        torch._foreach_mul_(vs, f32(torch.where(pred, BETA2, 1.0)))
        torch._foreach_addcmul_(vs, g, g, value=1.0 - BETA2)
        den = torch._foreach_sqrt(vs)
        torch._foreach_div_(den, f32(torch.sqrt(1.0 - BETA2 ** t)))
        torch._foreach_add_(den, EPS)
        # addcdiv's order: p + (-step_size * m) / den
        upd = torch._foreach_mul(ms, f32(-on * lr / (1.0 - b1 ** t)))
        torch._foreach_div_(upd, den)
        torch._foreach_add_(self.params, upd)
        count.add_(pred.to(count.dtype))

    def sync_count(self) -> int:
        """The host count and Adam's per-parameter step counts from the
        device count (one host read) -> the count."""
        if self.count_t is not None:
            self.count = int(self.count_t)
            for p in self.params:
                if self.adam.state[p]:
                    self.adam.state[p]["step"].fill_(float(self.count))
        return self.count

    def state_dict(self) -> dict:
        """Adam's moments and step counts, and the update count that
        drives the schedules."""
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        """Adam's state (new tensors) and the count, the device count
        too."""
        self.adam.load_state_dict(sd["adam"])
        self.count = int(sd["count"])
        if self.count_t is not None:
            self.count_t.fill_(self.count)


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
    return OneCycleAdam(params, lr, b1, grad_clip, total_steps)
