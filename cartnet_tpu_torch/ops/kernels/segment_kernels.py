"""Fused sigma chain + segment sum: CUDA kernel wrapper and plain version.

Port of the Pallas forward kernel cartnet_tpu/ops/pallas/segment_kernels.py
(``_sigma_fwd_call`` -> ``_sigma_seg_kernel``):

    sig   = sigmoid(gate * scale + shift) * env         # f32
    e_out = e_in + sig                                  # in e_in.dtype
    aggr  = segsum_dst(sig.astype(sender.dtype) * sender)   # f32 sum,
                                                        # returned in gate.dtype

``e_out`` is written for every edge, pads included; only edges under
``emask`` enter ``aggr``. The CUDA kernel reduces each destination row over
the masked-in edges of its CSR range [dst_rowptr[n], dst_rowptr[n+1]) in
edge order, while separate blocks write e_out of the pad edges: no atomics,
bitwise repeatable. On a CUDA tensor ``sigma_segsum`` launches
``csrc/sigma_segsum_fwd.cu`` or raises; on a CPU tensor it runs
``sigma_segsum_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from cartnet_tpu_torch.ops.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)

launches = 0  # kernel launches (CUDA path only)


def sigma_segsum_plain(gate, scale, shift, env, sender, e_in, edge_dst,
                       emask, num_nodes: int):
    """The kernel's function in plain PyTorch (same casts and rounding)."""
    a = gate.float() * scale.float() + shift.float()
    sig = torch.sigmoid(a) * env.float()
    e_out = e_in + sig.to(e_in.dtype)
    vals = (sig.to(sender.dtype) * sender).float()
    vals = torch.where(emask[:, None], vals, torch.zeros_like(vals))
    aggr = torch.zeros((num_nodes, gate.shape[1]), dtype=torch.float32,
                       device=gate.device)
    aggr.index_add_(0, edge_dst, vals)
    return e_out, aggr.to(gate.dtype)


def _check(gate, scale, shift, env, sender, e_in, edge_dst, emask,
           dst_rowptr, num_nodes):
    E, d = gate.shape
    shapes = {"scale": (scale, (d,)), "shift": (shift, (d,)),
              "env": (env, (E, 1)), "sender": (sender, (E, d)),
              "e_in": (e_in, (E, d)), "edge_dst": (edge_dst, (E,)),
              "emask": (emask, (E,)),
              "dst_rowptr": (dst_rowptr, (num_nodes + 1,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != gate.device:
            raise ValueError(f"{name} on {t.device}, gate on {gate.device}")
    if gate.dtype not in _DTYPES or sender.dtype != gate.dtype \
            or env.dtype != gate.dtype:
        raise TypeError(f"gate/sender/env must share f32/bf16, got "
                        f"{gate.dtype}/{sender.dtype}/{env.dtype}")
    if e_in.dtype not in _DTYPES:
        raise TypeError(f"e_in must be f32/bf16, got {e_in.dtype}")
    if scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError("scale/shift must be f32")
    if edge_dst.dtype != torch.int32 or dst_rowptr.dtype != torch.int32:
        raise TypeError("edge_dst/dst_rowptr must be int32")
    if emask.dtype != torch.bool:
        raise TypeError("emask must be bool")


def _lib():
    lib = _build.load("sigma_segsum_fwd")
    fn = lib.sigma_segsum_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sigma_segsum(gate, scale, shift, env, sender, e_in, edge_dst, emask,
                 dst_rowptr, num_nodes: int):
    """-> (e_out [E, d] in e_in.dtype, aggr [num_nodes, d] in gate.dtype)."""
    _check(gate, scale, shift, env, sender, e_in, edge_dst, emask,
           dst_rowptr, num_nodes)
    if gate.device.type == "cpu":
        return sigma_segsum_plain(gate, scale, shift, env, sender, e_in,
                                  edge_dst, emask, num_nodes)
    if gate.device.type != "cuda":
        raise ValueError(f"unsupported device {gate.device}")
    args = (gate, scale, shift, env, sender, e_in, emask, dst_rowptr)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("sigma_segsum needs contiguous tensors")
    E, d = gate.shape
    if d % 32 or d > 1024:
        raise ValueError(f"sigma_segsum kernel needs d % 32 == 0 and "
                         f"d <= 1024 (d={d})")
    dev = gate.device
    e_out = torch.empty_like(e_in)
    aggr = torch.empty((num_nodes, d), dtype=gate.dtype, device=dev)
    err = _lib()(*(t.data_ptr() for t in args), e_out.data_ptr(),
                 aggr.data_ptr(), E, num_nodes, d,
                 int(gate.dtype == torch.bfloat16),
                 int(e_in.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "sigma_segsum_fwd")
    global launches
    launches += 1
    return e_out, aggr
