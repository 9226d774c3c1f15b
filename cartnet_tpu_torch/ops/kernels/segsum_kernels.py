"""Masked CSR segment sum: CUDA kernel wrapper and plain version.

Port of the Pallas kernel cartnet_tpu/ops/pallas/segment_kernels.py
(``segment_sum_sorted_window`` -> ``_seg_kernel``) as its call site
cartnet_tpu/ops/segment.py::segment_sum_presorted uses it:

    out[n] = sum of values[perm[k]] over k in [rowptr[n], rowptr[n+1])
             with mask[k]                          # f32 sum, values' dtype

``perm=None`` reads values[k] (rows already sorted). The Pallas kernel's
one-hot windows round each 512-edge window's partial into a bf16 table;
this kernel sums every row in f32 in ascending k and rounds once. On a CUDA
tensor ``segment_sum_csr`` launches ``csrc/segment_sum_csr.cu`` or raises;
on a CPU tensor it runs ``segment_sum_csr_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cartnet_tpu_torch.ops.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 512  # the kernel's features per row (4 per thread, 128 threads)

# launch counters: one a wrapper call that launches its kernel, also
# while a CUDA graph captures it (train/graphs.py); a replay calls no
# wrapper and counts nothing
launches = 0  # kernel launches (CUDA path only)


def segment_sum_csr_plain(values, rowptr, mask,
                          perm: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch: masked positions go to a
    spill row N of an [N + 1, D] f32 table, summed by ``index_add_``."""
    n = rowptr.shape[0] - 1
    pos = torch.arange(mask.shape[0], dtype=rowptr.dtype,
                       device=values.device)
    ids = torch.searchsorted(rowptr, pos, right=True).long() - 1
    keep = mask & (ids >= 0) & (ids < n)
    ids = torch.where(keep, ids, torch.full_like(ids, n))
    vs = values if perm is None else values.index_select(0, perm)
    table = torch.zeros((n + 1, values.shape[1]), dtype=torch.float32,
                        device=values.device)
    table.index_add_(0, ids, vs.float())
    return table[:n].to(values.dtype)


def _check(values, rowptr, mask, perm):
    if values.dim() != 2:
        raise ValueError(f"values must be [E, D], got {tuple(values.shape)}")
    E = values.shape[0]
    shapes = {"mask": (mask, (E,)), "rowptr": (rowptr, (rowptr.shape[0],))}
    if perm is not None:
        shapes["perm"] = (perm, (E,))
    for name, (t, shape) in shapes.items():
        if t.dim() != 1 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != values.device:
            raise ValueError(f"{name} on {t.device}, values on "
                             f"{values.device}")
    if rowptr.shape[0] < 1:
        raise ValueError("rowptr needs N + 1 >= 1 entries")
    if values.dtype not in _DTYPES:
        raise TypeError(f"values must be f32/bf16, got {values.dtype}")
    if rowptr.dtype != torch.int32 or (perm is not None
                                       and perm.dtype != torch.int32):
        raise TypeError("rowptr/perm must be int32")
    if mask.dtype != torch.bool:
        raise TypeError("mask must be bool")


def _lib():
    lib = _build.load("segment_sum_csr")
    fn = lib.segment_sum_csr
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def segment_sum_csr(values, rowptr, mask,
                    perm: Optional[torch.Tensor] = None):
    """-> [N, D] in values.dtype, N = len(rowptr) - 1; see the module
    docstring."""
    _check(values, rowptr, mask, perm)
    if values.device.type == "cpu":
        return segment_sum_csr_plain(values, rowptr, mask, perm)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    args = (values, rowptr, mask) + (() if perm is None else (perm,))
    if not all(t.is_contiguous() for t in args):
        raise ValueError("segment_sum_csr needs contiguous tensors")
    E, D = values.shape
    if D > MAX_D or D == 0:
        raise ValueError(f"segment_sum_csr kernel needs 0 < D <= {MAX_D} "
                         f"(D={D})")
    n = rowptr.shape[0] - 1
    out = torch.empty((n, D), dtype=values.dtype, device=values.device)
    err = _lib()(values.data_ptr(), None if perm is None else perm.data_ptr(),
                 rowptr.data_ptr(), mask.data_ptr(), out.data_ptr(), E, n, D,
                 int(values.dtype == torch.bfloat16),
                 torch.cuda.current_stream(values.device).cuda_stream)
    _build.check(err, "segment_sum_csr")
    global launches
    launches += 1
    return out
