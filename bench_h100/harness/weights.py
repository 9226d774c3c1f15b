"""The weights a cell runs with, made on the device from the seed.

Every ``nn.Linear`` weight and bias of the reference model is drawn from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) and every embedding table from the
Xavier-uniform range, all in one draw of a device ``torch.Generator``; the
rest (BatchNorm's 1 and 0, its running statistics, the radial bases'
fixed means and widths) is what the reference model builds. The table
carries the program's state_dict names, so the program and the reference
load the same tensors."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn


def make_weights(ref: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    ref = ref.to(device)
    table = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    drawn = []
    for name, m in ref.named_modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            drawn += [(f"{name}.weight", bound)]
            if m.bias is not None:
                drawn += [(f"{name}.bias", bound)]
        elif isinstance(m, nn.Embedding):
            drawn += [(f"{name}.weight", math.sqrt(
                6.0 / (m.num_embeddings + m.embedding_dim)))]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(table[n].numel() for n, _ in drawn), generator=gen,
                   device=device)
    off = 0
    for n, bound in drawn:
        t = table[n]
        t.copy_(u[off:off + t.numel()].view_as(t) * (2 * bound) - bound)
        off += t.numel()
    return table
