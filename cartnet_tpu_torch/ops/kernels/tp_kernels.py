"""eComformer tensor-product contraction: CUDA kernel wrapper and plain
version.

Port of the Pallas forward kernel cartnet_tpu/ops/pallas/tp_kernels.py
(``_fwd_call`` -> ``_tp_fwd_kernel``, entries ``tp_contract_l1`` and
``tp_contract_l2``). Per edge, the fc's second layer generates the TP
weights and contracts them with the gathered irreps:

    w_all = h @ W + b                          # [E, 5120], rounded to h.dtype
    c_p[e, v] = sum_u round(w_all[e, off + u*V + v] * round(a_p[e, u]))

over the paths (U, V, off) of ``PATHS_L1`` (one input a, three outputs) or
``PATHS_L2`` (inputs a0, a1, a2, one output: the three paths summed in f32
before the single rounding). Rounding is to h's dtype at the Pallas
kernel's points; in f32 nothing is rounded. W is passed as ``wt`` [5120, d],
the nn.Linear layout of the fc's second layer. ``a`` may be f32 beside bf16
``h`` (the eComformer's bf16 forward feeds it so).

On a CUDA tensor the entries launch ``csrc/tp_contract_fwd.cu`` (one launch
per call; nothing of size [E, 5120] reaches device memory; bf16 tiles sized
to fill the card's SMs in one wave) or raise; on a CPU tensor they run
``tp_contract_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from cartnet_tpu_torch.ops.kernels import _build

NUMEL = 5120
# (U, V, column offset) per TP path; 64*64 + 64*8 + 64*8 = 5120
PATHS_L1 = ((64, 64, 0), (64, 8, 4096), (64, 8, 4608))
PATHS_L2 = ((64, 64, 0), (8, 64, 4096), (8, 64, 4608))
TILE_EDGES = 128  # E must be a multiple of it (the f32 kernel's tile)
WARPS = (4, 12)  # the bf16 kernel's tile: 16 edges per warp, in this range
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0  # kernel launches (CUDA path only)


def tp_contract_plain(paths, h, a_list, wt, b):
    """The kernel's function in plain PyTorch (same casts and rounding):
    one output per path, or, for ``PATHS_L2``, their f32 sum."""
    cdt = h.dtype
    w_all = (torch.matmul(h.float(), wt.float().t()) + b.float()).to(cdt)
    outs = []
    for (U, V, off), a in zip(paths, a_list * (len(paths) // len(a_list))):
        wp = w_all[:, off:off + U * V].reshape(-1, U, V)
        outs.append((wp * a.to(cdt)[:, :, None]).float().sum(dim=1))
    if paths == PATHS_L2:
        return (outs[0] + outs[1] + outs[2]).to(cdt)
    return tuple(c.to(cdt) for c in outs)


def _check(h, a_list, widths, wt, b):
    if h.dim() != 2:
        raise ValueError(f"h must be [E, d], got {tuple(h.shape)}")
    E, d = h.shape
    shapes = {"wt": (wt, (NUMEL, d)), "b": (b, (NUMEL,))}
    shapes.update({f"a{i}": (a, (E, w))
                   for i, (a, w) in enumerate(zip(a_list, widths))})
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != h.device:
            raise ValueError(f"{name} on {t.device}, h on {h.device}")
    if h.dtype not in _DTYPES:
        raise TypeError(f"h must be f32/bf16, got {h.dtype}")
    if wt.dtype != h.dtype or b.dtype != h.dtype:
        raise TypeError(f"wt/b must share h's dtype {h.dtype}, got "
                        f"{wt.dtype}/{b.dtype}")
    a_dt = {a.dtype for a in a_list}
    if len(a_dt) != 1 or a_dt.pop() not in (torch.float32, h.dtype):
        raise TypeError(f"the a inputs must share one dtype, f32 or h's "
                        f"({h.dtype}), got {[a.dtype for a in a_list]}")


def _lib():
    lib = _build.load("tp_contract_fwd")
    fn = lib.tp_contract_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tp_contract_fwd_smem.argtypes = [ctypes.c_int] * 4
        lib.tp_contract_fwd_smem.restype = ctypes.c_longlong
    return lib


def _launch(h, a_list, wt, b, outs, l2: bool):
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    args = (h, *a_list, wt, b)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("tp_contract needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (h, wt)):
        raise ValueError("tp_contract needs 16-byte aligned h and wt")
    E, d = h.shape
    lib = _lib()
    is_bf16 = int(h.dtype == torch.bfloat16)
    # bf16: the fewest warps per block whose tiles fill the SMs in one wave
    n_sm = torch.cuda.get_device_properties(h.device).multi_processor_count
    warps = min(max(-(-E // (16 * n_sm)), WARPS[0]), WARPS[1])
    if E % TILE_EDGES or d % 16 or d == 0 or lib.tp_contract_fwd_smem(
            d, is_bf16, int(l2), warps) > _SMEM_LIMIT:
        raise ValueError(f"tp_contract kernel needs E % {TILE_EDGES} == 0 "
                         f"and d % 16 == 0 with d <= 256 (E={E}, d={d})")
    ptrs = [a.data_ptr() for a in a_list] + [None] * (3 - len(a_list))
    optrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    err = lib.tp_contract_fwd(h.data_ptr(), *ptrs, wt.data_ptr(),
                              b.data_ptr(), *optrs, E, d, is_bf16,
                              int(a_list[0].dtype == torch.float32), int(l2),
                              warps,
                              torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "tp_contract_fwd")
    global launches
    launches += 1


def tp_contract_l1(h, a, wt, b):
    """h [E, d] fc hidden, a [E, 64] gathered scalars, wt [5120, d], b
    [5120] -> (c0 [E, 64], c1 [E, 8], c2 [E, 8]) in h.dtype."""
    _check(h, [a], (64,), wt, b)
    if h.device.type == "cpu":
        return tp_contract_plain(PATHS_L1, h, [a], wt, b)
    E = h.shape[0]
    outs = [torch.empty((E, w), dtype=h.dtype, device=h.device)
            for w in (64, 8, 8)]
    _launch(h, [a], wt, b, outs, False)
    return tuple(outs)


def tp_contract_l2(h, a0, a1, a2, wt, b):
    """h [E, d], a0 [E, 64], a1/a2 [E, 8], wt [5120, d], b [5120] ->
    [E, 64] in h.dtype: the three paths summed."""
    _check(h, [a0, a1, a2], (64, 8, 8), wt, b)
    if h.device.type == "cpu":
        return tp_contract_plain(PATHS_L2, h, [a0, a1, a2], wt, b)
    out = torch.empty((h.shape[0], 64), dtype=h.dtype, device=h.device)
    _launch(h, [a0, a1, a2], wt, b, [out], True)
    return out
