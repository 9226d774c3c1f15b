"""Train state (port of cartnet_tpu/train/state.py).

PyTorch keeps parameters and BN running stats in the model and the Adam
moments in the optimizer, so the state holds those objects plus what the
JAX pytree carries besides: the summed gradient accumulator, the device
counters of the step guard, the host count of optimizer updates and a
generator for anything random in the loop.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

from cartnet_tpu_torch.train.schedule import OneCycleAdam


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: OneCycleAdam
    # summed micro-batch gradients, aligned with optimizer.params (the
    # reference sums per micro-batch and steps every N; never averages)
    grad_accum: List[torch.Tensor]
    accum_count: torch.Tensor  # [] int32 micro-batches accumulated
    step: int                  # optimizer updates applied
    bad_steps: torch.Tensor    # [] int32 non-finite micro-steps skipped
    generator: torch.Generator
