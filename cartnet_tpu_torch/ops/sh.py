"""Real spherical harmonics l <= 2 (port of cartnet_tpu/ops/sh.py).

Component normalization (each component has unit second moment over the
sphere). The l = 1 components are ordered (x, y, z), as in the JAX package;
e3nn's (y, z, x) order is a fixed basis permutation that the learned
tensor-product weights absorb (see models/equivariant.py).
"""

from __future__ import annotations

import math

import torch

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)
SQRT15 = math.sqrt(15.0)


def spherical_harmonics_l012(vec, normalize: bool = True, eps: float = 1e-12):
    """[..., 3] directions -> (y0 [..., 1], y1 [..., 3], y2 [..., 5])."""
    if normalize:
        n = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True))
        vec = vec / torch.clamp(n, min=eps)
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    y0 = torch.ones_like(x)[..., None]
    y1 = SQRT3 * vec
    y2 = torch.stack([
        SQRT15 * x * y,
        SQRT15 * y * z,
        (SQRT5 / 2.0) * (3.0 * z * z - 1.0),
        SQRT15 * x * z,
        (SQRT15 / 2.0) * (x * x - y * y),
    ], dim=-1)
    return y0, y1, y2
