"""Radial basis and cutoff primitives (port of cartnet_tpu/ops/rbf.py).

  * ExpNormalSmearing (PhysNet-style), non-trainable in CartNet;
  * CosineCutoff (cutoff_lower = 0 path used by CartNet);
  * RBFExpansion (SchNet/Comformer-style, gamma = 1 / lengthscale).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def cosine_cutoff(dist, cutoff_upper: float, cutoff_lower: float = 0.0):
    """Smooth cosine envelope, zero beyond the cutoff radius."""
    if cutoff_lower > 0:
        c = 0.5 * (torch.cos(
            math.pi * (2.0 * (dist - cutoff_lower)
                       / (cutoff_upper - cutoff_lower) + 1.0)) + 1.0)
        return c * (dist < cutoff_upper) * (dist > cutoff_lower)
    c = 0.5 * (torch.cos(dist * math.pi / cutoff_upper) + 1.0)
    return c * (dist < cutoff_upper)


def exp_normal_params(cutoff_lower: float, cutoff_upper: float, num_rbf: int,
                      dtype=torch.float32, device=None):
    """PhysNet-default means/betas (non-trainable buffers in CartNet)."""
    start = math.exp(-cutoff_upper + cutoff_lower)
    means = torch.as_tensor(np.linspace(start, 1.0, num_rbf), dtype=dtype,
                            device=device)
    beta = (2.0 / num_rbf * (1.0 - start)) ** -2
    betas = torch.full((num_rbf,), beta, dtype=dtype, device=device)
    return means, betas


def exp_normal_smearing(dist, means, betas, cutoff_upper: float,
                        cutoff_lower: float = 0.0):
    """[..., num_rbf] expansion of distances, smoothly enveloped."""
    alpha = 5.0 / (cutoff_upper - cutoff_lower)
    d = dist[..., None]
    env = cosine_cutoff(d, cutoff_upper, cutoff_lower)
    return env * torch.exp(
        -betas * (torch.exp(alpha * (-d + cutoff_lower)) - means) ** 2)


def rbf_expansion_params(vmin: float, vmax: float, bins: int,
                         dtype=torch.float32):
    """Evenly spaced centers and the reference's default gamma =
    1 / lengthscale (not 1 / lengthscale**2) -> (centers [bins], gamma [])."""
    centers = torch.as_tensor(np.linspace(vmin, vmax, bins), dtype=dtype)
    gamma = torch.tensor(1.0 / ((vmax - vmin) / (bins - 1)), dtype=dtype)
    return centers, gamma


def rbf_expansion(x, centers, gamma):
    """Gaussian RBF expansion: [...] -> [..., bins]."""
    return torch.exp(-gamma * (x[..., None] - centers) ** 2)
