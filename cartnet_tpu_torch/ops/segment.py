"""Segment sums (port of cartnet_tpu/ops/segment.py).

``segment_sum`` / ``masked_segment_sum`` are plain ``index_add_`` sums, used
by the sigma kernel's plain version and the scalar head. ``index_add_`` on
CUDA adds with atomics, so these are references and small per-graph
reductions, not the main path's aggregation. ``segment_sum_presorted`` is
the eComformer's scatter onto edge sources through the deterministic CSR
kernel (ops/kernels/segsum_kernels.py, K3); its backward is a gather.
``gather_sorted`` is a node-to-edge gather over ascending ids (edge_dst)
whose backward runs K3 over ``dst_rowptr`` and the edge mask in the
``perm=None`` form: f32 sums in ascending edge order, no atomics
(``index_select``'s backward on CUDA adds with atomics).
"""

from __future__ import annotations

import torch

from cartnet_tpu_torch.ops.kernels.segsum_kernels import segment_sum_csr


def segment_sum(values, segment_ids, num_segments: int):
    """values [E, ...] summed per segment -> [num_segments, ...]."""
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids, values)


def masked_segment_sum(values, segment_ids, mask, num_segments: int):
    """segment_sum over the rows where ``mask`` is True."""
    m = mask.to(values.dtype).reshape(
        mask.shape + (1,) * (values.dim() - mask.dim()))
    return segment_sum(values * m, segment_ids, num_segments)


class _SegmentSumPresorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, perm, rowptr, mask_sorted, ids, mask):
        ctx.save_for_backward(ids, mask)
        return segment_sum_csr(values.contiguous(), rowptr, mask_sorted, perm)

    @staticmethod
    def backward(ctx, ct):
        ids, mask = ctx.saved_tensors
        dvalues = ct.index_select(0, ids) * mask.to(ct.dtype)[:, None]
        return dvalues, None, None, None, None, None


def segment_sum_presorted(values, perm, rowptr, mask_sorted, ids, mask):
    """Masked segment sum of values [E, D] by ``ids`` (unsorted, e.g.
    edge_src), with collate's sort metadata: ``perm`` sorts ids, ``rowptr``
    [N+1] holds the CSR offsets of the sorted ids and ``mask_sorted`` the
    edge ``mask`` in sorted order -> [N, D] in values.dtype (f32 sums). The
    JAX package permutes values first; the kernel reads them through
    ``perm``. Backward (the JAX package's ``_ssp_bwd``): d values =
    ct[ids] * mask."""
    return _SegmentSumPresorted.apply(values, perm, rowptr, mask_sorted, ids,
                                      mask)


class _GatherSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx, rowptr, mask):
        ctx.save_for_backward(rowptr, mask)
        return values.index_select(0, idx)

    @staticmethod
    def backward(ctx, ct):
        rowptr, mask = ctx.saved_tensors
        return segment_sum_csr(ct.contiguous(), rowptr, mask), None, None, \
            None


def gather_sorted(values, idx, rowptr, mask):
    """values[idx] for ascending ``idx`` [E] whose CSR offsets are ``rowptr``
    [N+1] (edge_dst and dst_rowptr). Backward (the JAX package's
    ``gather_sorted_vjp`` with ``perm=None``): the cotangent rows summed per
    id by K3 over the edges under ``mask`` (edge_mask). The JAX package sums
    every edge; the model's pad-edge cotangents are exactly zero
    (tests/test_torch_port_comformer_train.py checks every gather), so
    leaving them out changes nothing and spares K3 the long pad runs at the
    end of each graph's last row."""
    return _GatherSorted.apply(values, idx, rowptr, mask)
