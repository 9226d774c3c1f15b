"""Uniform SO(3) sampling and the ADP conjugation (port of
cartnet_tpu/ops/rotations.py).

Quaternion-based Haar-uniform rotations drawn from a ``torch.Generator``
(the JAX package draws from ``jax.random``, so the two give different
rotations for the same seed), and U -> Rᵀ U R.
"""

from __future__ import annotations

import torch


def quat_to_matrix(q):
    """Unit quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def random_rotation(generator: torch.Generator, shape=()):
    """Haar-uniform f32 rotation matrices of shape ``shape + (3, 3)`` on the
    generator's device."""
    q = torch.randn(tuple(shape) + (4,), generator=generator,
                    device=generator.device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return quat_to_matrix(q)


def rotate_adp_targets(y, R):
    """U -> Rᵀ U R over a stack [n, 3, 3] (the SO(3) equivariance
    contract)."""
    return torch.einsum("ji,njk,kl->nil", R, y, R)
