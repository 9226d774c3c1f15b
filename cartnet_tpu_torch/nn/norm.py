"""Masked BatchNorm, eval branches (port of cartnet_tpu/nn/norm.py).

In eval mode BatchNorm normalizes by the running statistics, so the mask of
real rows plays no part; pad rows are normalized too and stay masked
downstream. The running stats stay in f32 while gamma/beta arrive in the
compute dtype, so a bf16 input is promoted to f32 here, as in the reference.
The train branches (masked batch moments, window-moment merge, running-stat
update) come with the training slice.
"""

from __future__ import annotations

import torch


def masked_bn_scale_shift(gamma, beta, running_mean, running_var,
                          eps: float = 1e-5):
    """Eval BN as an affine pair: y = x * scale + shift."""
    inv = torch.reciprocal(torch.sqrt(running_var + eps))
    scale = gamma * inv
    return scale, beta - running_mean * scale


def masked_batch_norm(x, gamma, beta, running_mean, running_var,
                      eps: float = 1e-5):
    """Eval BN: (x - mean) / sqrt(var + eps) * gamma + beta."""
    inv = torch.reciprocal(torch.sqrt(running_var + eps))
    return (x - running_mean) * inv * gamma + beta
