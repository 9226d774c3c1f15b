"""Segment sums (port of cartnet_tpu/ops/segment.py).

``segment_sum`` / ``masked_segment_sum`` are plain ``index_add_`` sums, used
by the sigma kernel's plain version and the scalar head. ``index_add_`` on
CUDA adds with atomics, so these are references and small per-graph
reductions, not the main path's aggregation. ``segment_sum_presorted`` is
the eComformer's scatter onto edge sources through the deterministic CSR
kernel (ops/kernels/segsum_kernels.py).
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


def segment_sum_presorted(values, perm, rowptr, mask_sorted):
    """Masked segment sum of values [E, D] by ids that ``perm`` sorts, with
    collate's sort metadata: ``rowptr`` [N+1] the CSR offsets of the sorted
    ids and ``mask_sorted`` the edge mask in sorted order -> [N, D] in
    values.dtype (f32 sums). The JAX package permutes values first; the
    kernel reads them through ``perm``."""
    return segment_sum_csr(values.contiguous(), rowptr, mask_sorted, perm)
