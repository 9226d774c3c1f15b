"""Loss and ADP evaluation metrics (port of cartnet_tpu/train/metrics.py).

  * masked MAE/MSE over real elements;
  * S12 similarity index in its inverse-free, scale-normalized form;
  * voxelized 3D IoU of two ellipsoids on a deterministic 64^3 linspace grid.

All 3x3 algebra is closed form (ops/linalg3); tensors stay on their device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cartnet_tpu_torch.ops.linalg3 import det3, frobenius3, inv3

SMOOTH = 1e-8


def masked_mae_mse(pred, true, mask):
    """Masked elementwise MAE/MSE means; mask [M] aligns with pred's lead."""
    m = mask.float()
    m = m.reshape(m.shape + (1,) * (pred.dim() - m.dim()))
    diff = (pred.float() - true.float()) * m
    count = torch.clamp(torch.sum(m) * math.prod(pred.shape[mask.dim():]),
                        min=1.0)
    return torch.sum(torch.abs(diff)) / count, torch.sum(diff * diff) / count


def get_similarity_index(pred, true):
    """S12 in percent: 100 (1 - 2^{3/2} (det T det P)^{1/4} / det(T+P)^{1/2})
    after normalizing both by the true matrix's mean diagonal (S12 is
    scale-invariant; the normalization keeps f32 finite)."""
    scale = 3.0 / torch.clamp(
        torch.diagonal(true, dim1=-2, dim2=-1).sum(-1), min=1e-12)
    pred = pred * scale[..., None, None]
    true = true * scale[..., None, None]
    dt = torch.clamp(det3(true), min=1e-30)
    dp = torch.clamp(det3(pred), min=1e-30)
    dsum = torch.maximum(det3(true + pred), dt + dp)
    num = 2.0 ** 1.5 * (dt * dp) ** 0.25
    return 100.0 * (1.0 - num / dsum ** 0.5)


def _grid(num_points: int, device) -> torch.Tensor:
    g = torch.as_tensor(np.linspace(-1.0, 1.0, num_points), dtype=torch.float32,
                        device=device)
    return torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def _ellipsoid_masks(u, pts):
    """[n, P^3] bool: Mahalanobis x^T U^-1 x < 1 over the grid points."""
    inv = inv3(u)
    d2 = torch.einsum("pi,nij,pj->np", pts, inv, pts)
    return d2 < 1.0


def compute_3d_iou(pred, true, num_points: int = 64):
    """Voxelized ellipsoid IoU in [0, 1], per matrix pair."""
    pts = _grid(num_points, pred.device)
    np_, nt = frobenius3(pred), frobenius3(true)
    norm = torch.where(np_ > nt, np_, nt)[..., None, None]
    mp = _ellipsoid_masks(pred / norm, pts)
    mt = _ellipsoid_masks(true / norm, pts)
    inter = (mp & mt).sum(dim=1).float()
    union = (mp | mt).sum(dim=1).float()
    return (inter + SMOOTH) / (union + SMOOTH)
