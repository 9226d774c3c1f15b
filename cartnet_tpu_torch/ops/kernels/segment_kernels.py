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
edge order, one warp per row and slice of its features, while separate pad
warps write e_out of the pad edges: no atomics, bitwise repeatable. On a
CUDA tensor ``sigma_segsum`` launches ``csrc/sigma_segsum_fwd.cu`` or
raises; on a CPU tensor it runs ``sigma_segsum_plain``. Both kernels take
every width natively (K2 0 < d <= 1024, K4 0 < d <= 512): lanes own
features, a lane past d owns none, and each kernel picks its vector or its
scalar accesses from d and the operands' alignment; nothing is padded.

The backward (port of ``_sigma_bwd`` -> ``_sigma_seg_bwd_kernel``) is
``sigma_segsum_bwd``: on a CUDA tensor it launches ``csrc/sigma_segsum_bwd.cu``
(two launches per call: a row pass at memory speed, ``BWD_BLOCKS_PER_SM``
blocks an SM each walking a contiguous range of edges in 16-byte accesses
and writing one partial row of dscale/dshift, then a fixed-order column
pass over those rows; no float atomics) or raises; on a CPU tensor it runs
``sigma_segsum_bwd_plain``. ``SigmaSegsum`` is the autograd Function whose
forward is ``sigma_segsum`` and whose backward is ``sigma_segsum_bwd``.
"""

from __future__ import annotations

import ctypes

import torch

from cartnet_tpu_torch.ops.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)

# launch counters: one a wrapper call that launches its kernel, also
# while a CUDA graph captures it (train/graphs.py); a replay calls no
# wrapper and counts nothing
launches = 0  # forward kernel launches (CUDA path only)
bwd_launches = 0  # backward kernel launches (CUDA path only)


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
              "emask": (emask, (E,))}
    if dst_rowptr is not None:
        shapes["dst_rowptr"] = (dst_rowptr, (num_nodes + 1,))
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
    if edge_dst.dtype != torch.int32 or (dst_rowptr is not None and
                                         dst_rowptr.dtype != torch.int32):
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
    if d == 0 or d > 1024:
        raise ValueError(f"sigma_segsum kernel needs 0 < d <= 1024 (d={d})")
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


# ------------------------------------------------------------ backward (K4)

def sigma_segsum_bwd_plain(gate, scale, shift, env, sender, deout, daggr,
                           edge_dst, emask):
    """The backward kernel's function in plain PyTorch -> (dgate, dscale,
    dshift, denv, dsender); dscale/dshift sum over every edge, pads
    included, and pad edges gather no daggr row."""
    g = gate.float()
    a = g * scale.float() + shift.float()
    sig0 = torch.sigmoid(a)
    env32 = env.float()
    sig = sig0 * env32
    dvals = daggr.index_select(0, edge_dst).float()
    dvals = torch.where(emask[:, None], dvals, torch.zeros_like(dvals))
    dsender = (dvals * sig).to(sender.dtype)
    dsig = deout.float() + dvals * sender.float()
    denv = (dsig * sig0).sum(dim=1, keepdim=True).to(env.dtype)
    da = dsig * env32 * sig0 * (1.0 - sig0)
    dgate = (da * scale.float()).to(gate.dtype)
    return dgate, (da * g).sum(dim=0), da.sum(dim=0), denv, dsender


def _lib_bwd():
    lib = _build.load("sigma_segsum_bwd")
    fn = lib.sigma_segsum_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.sigma_segsum_bwd_parts.argtypes = [ctypes.c_int]
        lib.sigma_segsum_bwd_parts.restype = ctypes.c_int
    return lib


# the row pass's warps a block and blocks an SM, as sigma_segsum_bwd.cu
# states them (``WARPS``, ``BLOCKS_PER_SM``)
BWD_WARPS, BWD_BLOCKS_PER_SM = 8, 2


def bwd_parts(E: int, n_sm: int) -> int:
    """K4's partial rows of dscale/dshift, one per row-pass block (mirrors
    ``sigma_segsum_bwd_parts``, which the wrapper asks on the card):
    ``BWD_BLOCKS_PER_SM`` blocks an SM, at most one per ``BWD_WARPS`` edges
    (every warp has a row), at least one."""
    return max(1, min(n_sm * BWD_BLOCKS_PER_SM, -(-E // BWD_WARPS)))


def sigma_segsum_bwd(gate, scale, shift, env, sender, deout, daggr, edge_dst,
                     emask):
    """-> (dgate [E, d] gate.dtype, dscale [d] f32, dshift [d] f32,
    denv [E, 1] env.dtype, dsender [E, d] sender.dtype)."""
    E, d = gate.shape
    num_nodes = daggr.shape[0]
    _check(gate, scale, shift, env, sender, deout, edge_dst, emask, None,
           num_nodes)
    if daggr.dim() != 2 or daggr.shape[1] != d or daggr.dtype != gate.dtype \
            or daggr.device != gate.device:
        raise ValueError(f"daggr must be [N, {d}] {gate.dtype} on "
                         f"{gate.device}, got {tuple(daggr.shape)} "
                         f"{daggr.dtype} on {daggr.device}")
    if gate.device.type == "cpu":
        return sigma_segsum_bwd_plain(gate, scale, shift, env, sender, deout,
                                      daggr, edge_dst, emask)
    if gate.device.type != "cuda":
        raise ValueError(f"unsupported device {gate.device}")
    args = (gate, scale, shift, env, sender, deout, daggr, edge_dst, emask)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("sigma_segsum_bwd needs contiguous tensors")
    if d == 0 or d > 512 or E == 0:
        raise ValueError(f"sigma_segsum_bwd kernel needs 0 < d <= 512 and "
                         f"E > 0 (E={E}, d={d})")
    dev = gate.device
    lib = _lib_bwd()
    dgate = torch.empty_like(gate)
    dsender = torch.empty_like(sender)
    denv = torch.empty_like(env)
    dscale_shift = torch.empty(2 * d, dtype=torch.float32, device=dev)
    part = torch.empty((lib.sigma_segsum_bwd_parts(E), 2 * d),
                       dtype=torch.float32, device=dev)
    err = lib.sigma_segsum_bwd(
        *(t.data_ptr() for t in args), dgate.data_ptr(),
        dscale_shift.data_ptr(), denv.data_ptr(), dsender.data_ptr(),
        part.data_ptr(), E, d, int(gate.dtype == torch.bfloat16),
        int(deout.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "sigma_segsum_bwd")
    global bwd_launches
    bwd_launches += 1
    return dgate, dscale_shift[:d], dscale_shift[d:], denv, dsender


class SigmaSegsum(torch.autograd.Function):
    """(gate, scale, shift, env, sender, e_in) -> (e_out, aggr) through
    ``sigma_segsum``; the backward is ``sigma_segsum_bwd``, and e_in's
    cotangent is deout (e_out = e_in + sigma). Cotangents come back in the
    primal dtypes."""

    @staticmethod
    def forward(ctx, gate, scale, shift, env, sender, e_in, edge_dst, emask,
                dst_rowptr, num_nodes: int):
        e_out, aggr = sigma_segsum(gate, scale, shift, env, sender, e_in,
                                   edge_dst, emask, dst_rowptr, num_nodes)
        ctx.save_for_backward(gate, scale, shift, env, sender, edge_dst,
                              emask)
        return e_out, aggr

    @staticmethod
    def backward(ctx, deout, daggr):
        gate, scale, shift, env, sender, edge_dst, emask = ctx.saved_tensors
        dgate, dscale, dshift, denv, dsender = sigma_segsum_bwd(
            gate, scale, shift, env, sender, deout.contiguous(),
            daggr.to(gate.dtype).contiguous(), edge_dst, emask)
        return (dgate, dscale.to(scale.dtype), dshift.to(shift.dtype), denv,
                dsender, deout, None, None, None, None)
