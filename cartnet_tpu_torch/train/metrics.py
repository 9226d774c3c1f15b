"""Loss and ADP evaluation metrics (port of cartnet_tpu/train/metrics.py).

  * masked MAE/MSE over real elements;
  * ellipsoid volume and its relative error, summed with S12 per epoch
    (``adp_stat_sums``);
  * S12 similarity index in its inverse-free, scale-normalized form;
  * the KL divergence of two zero-mean Gaussians with ADP covariances;
  * voxelized 3D IoU of two ellipsoids on a deterministic 64^3 linspace grid.

All 3x3 algebra is closed form (ops/linalg3); tensors stay on their device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cartnet_tpu_torch.ops.linalg3 import det3, frobenius3, inv3

SMOOTH = 1e-8


def masked_sums(pred, true, mask):
    """f32 (sum |diff|, sum diff², element count) over the real elements;
    mask [M] aligns with pred's lead."""
    m = mask.float()
    m = m.reshape(m.shape + (1,) * (pred.dim() - m.dim()))
    diff = (pred.float() - true.float()) * m
    return (torch.sum(torch.abs(diff)), torch.sum(diff * diff),
            torch.sum(m) * math.prod(pred.shape[mask.dim():]))


def masked_mae_mse(pred, true, mask):
    """Masked elementwise MAE/MSE means."""
    sa, sq, count = masked_sums(pred, true, mask)
    count = torch.clamp(count, min=1.0)
    return sa / count, sq / count


def get_volume(u):
    """Ellipsoid volume 4/3 pi sqrt(det U), det clamped at 0 (an f32
    cofactor det of a near-singular SPD U can land just below 0)."""
    return (4.0 / 3.0) * math.pi * torch.sqrt(torch.clamp(det3(u), min=0.0))


def get_error_volume(pred, true):
    """|V(pred) - V(true)| / (V(pred) + eps), the reference's argument
    order included."""
    vp = get_volume(pred)
    return torch.abs(vp - get_volume(true)) / (vp + SMOOTH)


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


def get_kl(pred, true):
    """KL(N(0, true) || N(0, pred)) for batched 3x3 SPD matrices."""
    tr = torch.diagonal(torch.matmul(inv3(pred), true), dim1=-2,
                        dim2=-1).sum(-1)
    return 0.5 * (tr - 3.0 + torch.log(det3(pred) / det3(true)))


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


def _safe33(u, mask):
    """Pad rows of a [N, 3, 3] stack replaced by I, so det/inv stay finite
    (NaN * 0 would poison the masked sums)."""
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    return torch.where(mask[:, None, None], u, eye)


def adp_stat_sums(pred, true, mask):
    """Masked sums (volume error, S12, count) of the per-epoch ADP stats."""
    p = _safe33(pred.float(), mask)
    t = _safe33(true.float(), mask)
    mf = mask.float()
    return ((get_error_volume(p, t) * mf).sum(),
            (get_similarity_index(p, t) * mf).sum(), mf.sum())
