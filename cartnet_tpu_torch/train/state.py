"""Train state (port of cartnet_tpu/train/state.py).

PyTorch keeps parameters and BN running stats in the model and the Adam
moments in the optimizer, so the state holds those objects plus what the
JAX pytree carries besides: the summed gradient accumulator, the device
counters of the step guard, the host count of optimizer updates and a
generator for anything random in the loop. ``state_dict`` /
``load_state_dict`` carry all of it (a resumable checkpoint's body).
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

    def state_dict(self) -> dict:
        return {"model_state": self.model.state_dict(),
                "optimizer_state": self.optimizer.state_dict(),
                "grad_accum": list(self.grad_accum),
                "accum_count": self.accum_count, "step": self.step,
                "bad_steps": self.bad_steps,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        """In place: tensors are copied into the state's own (on its
        device)."""
        self.model.load_state_dict(sd["model_state"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer_state"])
        with torch.no_grad():
            for a, b in zip(self.grad_accum, sd["grad_accum"], strict=True):
                a.copy_(b)
            self.accum_count.copy_(sd["accum_count"])
            self.bad_steps.copy_(sd["bad_steps"])
        self.step = int(sd["step"])
        self.generator.set_state(sd["generator"])
