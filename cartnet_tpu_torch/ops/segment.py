"""Plain segment sums (port of cartnet_tpu/ops/segment.py:20-37).

Used by the sigma kernel's plain version and the scalar head. ``index_add_``
on CUDA adds with atomics, so these are references and small per-graph
reductions, not the main path's aggregation (that is the deterministic CSR
kernel in ops/kernels/segment_kernels.py).
"""

from __future__ import annotations

import torch


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
