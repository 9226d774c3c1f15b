"""Device-side non-finite step guard (port of the device side of
cartnet_tpu/train/guard.py).

A micro-step whose loss or gradients are not finite contributes zero
gradient, keeps the previous BN running stats, does not advance the
accumulation count and adds one to ``bad_steps``. Everything stays on the
device: no host sync per step. Selects use ``torch.where``, never a
multiplication by a 0/1 mask (NaN * 0 is NaN).
"""

from __future__ import annotations

from typing import Sequence

import torch


def tree_all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Scalar bool tensor: every element of every float tensor is finite."""
    oks = [torch.isfinite(t).all() for t in tensors
           if t is not None and t.is_floating_point()]
    if not oks:
        return torch.tensor(True)
    return torch.stack(oks).all()


def guard_contribution(loss, grads, new_bn, old_bn):
    """-> (ok, grads', bn'): zero grads and the old BN stats where the step
    is not finite."""
    ok = torch.isfinite(loss) & tree_all_finite(grads)
    grads = [torch.where(ok, g, torch.zeros_like(g)) for g in grads]
    bn = [torch.where(ok, a, b) for a, b in zip(new_bn, old_bn)]
    return ok, grads, bn
