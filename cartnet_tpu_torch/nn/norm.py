"""Masked BatchNorm with PyTorch semantics (port of cartnet_tpu/nn/norm.py).

Padded batches carry a mask of real rows; in training the batch moments are
taken over those rows only:
  * normalize by the biased batch variance (divide by n);
  * running stats: ``running = (1 - momentum) * running + momentum * batch``
    with the unbiased variance n / (n - 1), and ``num_batches_tracked += 1``;
  * eval normalizes by the running stats, so the mask plays no part there
    (pad rows are normalized too and stay masked downstream).
Moments are always f32. Running stats are f32 buffers of ``nn.BatchNorm1d``,
updated in place under ``no_grad`` by ``bn_state_update``. In eval the f32
running stats promote a bf16 input to f32; in training the output keeps the
input's dtype.

Sync BN: the train-mode functions take an optional process group
(``torch.distributed``). With one, the masked count and the first moment
are summed over its ranks, then the centered second moment around the
global mean, in the order the JAX package psums them, through the
autograd-aware all-reduce, whose backward sums the cotangents over the
ranks; every rank then normalizes with the moments of the union batch.
Without a group the code is that of a single process.
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


def _sum_over(group, *ts):
    """``ts`` summed over the ranks of ``group`` in one all-reduce (the
    autograd-aware one), or ``ts`` as they are without a group."""
    if group is None:
        return ts
    from torch.distributed.nn.functional import all_reduce
    flat = all_reduce(torch.cat([t.reshape(-1) for t in ts]), group=group)
    return tuple(flat.split([t.numel() for t in ts]))


def _masked_moments(x, mask, group=None):
    """f32 (x, mean, biased var, n) over the rows under ``mask`` (of every
    rank of ``group``)."""
    xf = x.float()
    m = mask.float()[:, None]
    n, s1 = m.sum(), (xf * m).sum(dim=0)
    if group is not None:
        n, s1 = _sum_over(group, n, s1)
        n = n.reshape(())
    n = torch.clamp(n, min=1.0)
    mean = s1 / n
    diff = (xf - mean) * m
    (m2,) = _sum_over(group, (diff * diff).sum(dim=0))
    return xf, mean, m2 / n, n


def masked_batch_norm_train(x, gamma, beta, mask, eps: float = 1e-5,
                            group=None):
    """Train BN over the masked rows -> (y in x.dtype, (mean, var, n)):
    y = ((x - mean) * inv).to(x.dtype) * gamma + beta, as the reference
    rounds it."""
    xf, mean, var, n = _masked_moments(x, mask, group)
    inv = torch.reciprocal(torch.sqrt(var + eps))
    y = ((xf - mean) * inv).to(x.dtype) * gamma + beta
    return y, (mean, var, n)


def masked_bn_scale_shift_train(x, gamma, beta, mask, eps: float = 1e-5,
                                group=None):
    """Train BN as an affine pair -> ((scale, shift), (mean, var, n)); the
    moments are differentiable functions of x."""
    _, mean, var, n = _masked_moments(x, mask, group)
    inv = torch.reciprocal(torch.sqrt(var + eps))
    scale = gamma * inv
    return (scale, beta - mean * scale), (mean, var, n)


def combine_window_moments(gamma, beta, s1w, m2w, n_w, eps: float = 1e-5,
                           group=None):
    """Per-window masked Welford partials s1_w/M2_w [nt, d] and real-row
    counts n_w [nt, 1] -> ((scale, shift), (mean, var, n)), with the exact
    group merge M2 = sum_w M2_w + sum_w n_w (mean_w - mean)^2.
    Differentiable in s1_w, M2_w, gamma and beta. With ``group`` the merged
    n, s1 and M2 are summed over its ranks (each rank's own windows merge
    around the global mean), never the per-window arrays, whose counts may
    differ between ranks."""
    n, s1 = n_w.sum(), s1w.sum(dim=0)
    if group is not None:
        n, s1 = _sum_over(group, n, s1)
        n = n.reshape(())
    n = torch.clamp(n, min=1.0)
    mean = s1 / n
    mean_w = s1w / torch.clamp(n_w, min=1.0)
    (m2,) = _sum_over(group,
                      (m2w + n_w * torch.square(mean_w - mean)).sum(dim=0))
    var = m2 / n
    inv = torch.reciprocal(torch.sqrt(var + eps))
    scale = gamma * inv
    return (scale, beta - mean * scale), (mean, var, n)


@torch.no_grad()
def bn_state_update(bn: torch.nn.BatchNorm1d, mean, var, n,
                    momentum: float = 0.1):
    """Advance ``bn``'s running stats in place from batch moments (PyTorch
    momentum, unbiased variance n / max(n - 1, 1))."""
    unbiased = var.detach() * (n / torch.clamp(n - 1.0, min=1.0))
    bn.running_mean.copy_((1.0 - momentum) * bn.running_mean
                          + momentum * mean.detach())
    bn.running_var.copy_((1.0 - momentum) * bn.running_var
                         + momentum * unbiased)
    bn.num_batches_tracked.add_(1)


def bn_scale_shift_from_window_moments(bn: torch.nn.BatchNorm1d, gamma, beta,
                                       s1w, m2w, mask, tile: int,
                                       momentum: float = 0.1,
                                       eps: float = 1e-5, group=None):
    """Train BN (scale, shift) from the edge kernel's per-``tile`` window
    partials; advances ``bn``'s running stats."""
    nt = s1w.shape[0]
    n_w = mask.reshape(nt, tile).sum(dim=1, dtype=torch.float32)[:, None]
    (scale, shift), (mean, var, n) = combine_window_moments(
        gamma, beta, s1w, m2w, n_w, eps, group)
    bn_state_update(bn, mean, var, n, momentum)
    return scale, shift
