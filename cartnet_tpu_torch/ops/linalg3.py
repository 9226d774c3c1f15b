"""Closed-form batched 3x3 linear algebra (port of cartnet_tpu/ops/linalg3.py).

Determinant, adjugate inverse and Frobenius norm for the ADP metrics, and
the Cholesky head's U = L^T L assembly.
"""

from __future__ import annotations

import torch


def det3(a):
    """Determinant of [..., 3, 3]."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                            - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                              - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                              - a[..., 1, 1] * a[..., 2, 0]))


def inv3(a):
    """Inverse of [..., 3, 3] via the adjugate."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adj = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c10, c11, c12], dim=-1),
        torch.stack([c20, c21, c22], dim=-1),
    ], dim=-2)
    return adj / det3(a)[..., None, None]


def frobenius3(a):
    """Frobenius norm of [..., 3, 3]."""
    return torch.sqrt(torch.sum(a * a, dim=(-2, -1)))


def assemble_cholesky_upper(diag, offdiag):
    """U = L^T L for upper-triangular L (SPD by construction):
    L[0,0],L[1,1],L[2,2] = diag; L[0,1],L[0,2],L[1,2] = offdiag."""
    d0, d1, d2 = diag[:, 0], diag[:, 1], diag[:, 2]
    o01, o02, o12 = offdiag[:, 0], offdiag[:, 1], offdiag[:, 2]
    u00 = d0 * d0
    u01 = d0 * o01
    u02 = d0 * o02
    u11 = o01 * o01 + d1 * d1
    u12 = o01 * o02 + d1 * o12
    u22 = o02 * o02 + o12 * o12 + d2 * d2
    return torch.stack([
        torch.stack([u00, u01, u02], dim=-1),
        torch.stack([u01, u11, u12], dim=-1),
        torch.stack([u02, u12, u22], dim=-1),
    ], dim=-2)
