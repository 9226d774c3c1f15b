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

On a CUDA tensor the entries launch ``csrc/tp_contract_fwd.cu`` or raise;
on a CPU tensor they run ``tp_contract_plain``. Nothing of size [E, 5120]
reaches device memory. bf16: one CUDA launch a call, wgmma + TMA on a
persistent grid, up to ``TC_WGS`` 64-edge tiles a block sharing one ring of
wt slabs (``fwd_smem_plan``). f32: two CUDA launches a call, a tile pass of
SIMT GEMM tiles on the CUDA cores with the contraction as their epilogue
(a block takes one 64-edge tile and a group of column tiles, and writes a
partial [E, 64] table of the V = 64 paths) and a reduce that adds the
partial tables in group order; the scratch is allocated here
(``tp_contract_fwd_workspace``). The kernel takes d % 16 == 0
(``GRANULE``) natively, in bf16 from ``TC_MIN_WIDTH`` up (its TMA box);
other widths 1 <= d <= 512 (``MAX_WIDTH``) are zero-padded inside the
wrapper (h's and wt's padded columns are zero, so every product over d
gains only zero terms and w_all is unchanged).

The backward (port of ``_bwd_call`` -> ``_tp_bwd_kernel``, driven by
``_l1_bwd`` / ``_l2_bwd``) is ``tp_contract_bwd``: from the cotangents dc of
the outputs it recomputes w_all and returns

    da_p[e, u]  = sum_v round(dc[e, v] * w_p[e, u, v])   # f32 sum, in h.dtype
    dwall[e, off + u*V + v] = round(dc_p[e, v] * round(a_p[e, u]))
    dh = round(dwall @ W^T),  dwt = dwall^T h  [5120, d] f32,  db = sum_e dwall

(L1: the one a sums its three paths in f32 and rounds once; L2: one dc
[E, 64] feeds all three paths). On a CUDA tensor it launches
``csrc/tp_contract_bwd.cu`` or raises; on a CPU tensor it runs
``tp_contract_bwd_plain``. One call is three CUDA launches: in bf16 a
persistent wgmma + TMA edge-tile pass for dh and da, an output-tiled wgmma
pass for dwt and db over KSPLIT edge ranges, a fixed-order reduce of the
ranges; in f32 the same three passes as SIMT GEMM tiles on the CUDA cores
(the tile pass's dh and w_all tiles in one grid, the reduce also adding
L1's three path terms of da in path order); ``bwd_launches`` counts calls.
No float atomics, nothing of size [E, 5120] in device memory. The kernel takes
d % 128 == 0 (``BWD_GRANULE``: two warpgroups each own d/2 columns of dh
in 64-column slabs); other widths up to 512 are zero-padded inside the
wrapper (h's and wt's padded columns are zero, so w_all, da and the real
columns of dh and dwt are unchanged; the padded ones are cut away).
``TPContractL1`` / ``TPContractL2`` are the autograd Functions: K7
forward, K8 backward.
"""

from __future__ import annotations

import ctypes

import torch

from cartnet_tpu_torch.ops.kernels import _build, _pad

NUMEL = 5120
# (U, V, column offset) per TP path; 64*64 + 64*8 + 64*8 = 5120
PATHS_L1 = ((64, 64, 0), (64, 8, 4096), (64, 8, 4608))
PATHS_L2 = ((64, 64, 0), (8, 64, 4096), (8, 64, 4608))
TILE_EDGES = 64  # E must be a multiple of it (both paths' edge tile)
GRANULE = 16  # K7's width granule (the k16 step): other widths are padded
TC_MIN_WIDTH = 64  # bf16: narrower h and wt are padded to the TMA box
MAX_WIDTH = 512  # the widest d the TP kernels take
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_DTYPES = (torch.float32, torch.bfloat16)

# launch counters: one a wrapper call that launches its kernel, also
# while a CUDA graph captures it (train/graphs.py); a replay calls no
# wrapper and counts nothing
launches = 0  # forward kernel launches (CUDA path only)
bwd_launches = 0  # backward kernel launches (CUDA path only)


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
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tp_contract_fwd_smem.argtypes = [ctypes.c_int] * 3
        lib.tp_contract_fwd_workspace.argtypes = [ctypes.c_int] * 3
        for name in ("tp_contract_fwd_smem", "tp_contract_fwd_workspace"):
            getattr(lib, name).restype = ctypes.c_longlong
    return lib


# the f32 tile pass's blocks an SM (``__launch_bounds__``) and its output
# sums a thread (8 rows x 4 columns), as tp_contract_fwd.cu states them
F32_BLOCKS, F32_OUT_SUMS = 4, 32
# the bf16 block, as tp_contract_fwd.cu states it: consumer warpgroups (a
# 64-edge tile each) at most, and the ring stages they must leave (else
# two warpgroups), chunks a wgmma (n = 64 TC_NB), the ring's most stages
TC_WGS, TC_MIN_STAGES, TC_NB, TC_MAX_STAGES = 3, 4, 2, 16
_SLAB = 8192  # a 64 x 64 bf16 slab, 128-byte swizzled


def _tc_layout(d: int, l2: bool, wgs: int) -> dict:
    ks = -(-d // 64)
    bias = wgs * ks * _SLAB + wgs * 64 * ((80 if l2 else 64) + 2) * 2
    ring = -(-(bias + NUMEL * 2) // 1024) * 1024
    stages = min(TC_MAX_STAGES, max(0, (_SMEM_LIMIT - 1024 - ring
                                        - 16 * TC_MAX_STAGES - 16 * wgs)
                                    // (TC_NB * _SLAB)))
    total = 1024 + ring + stages * TC_NB * _SLAB + 16 * stages + 16 * wgs
    ok = total <= _SMEM_LIMIT and stages >= 2
    return {"total": total if ok else 0, "wgs": wgs, "stages": stages,
            "slabs": ks}


def fwd_smem_plan(d: int, l2: bool) -> dict:
    """K7's bf16 block (mirrors ``tc_plan`` and ``TcLayout`` in
    tp_contract_fwd.cu, whose ``tp_contract_fwd_smem`` the wrapper asks on
    the card): ``TC_WGS`` warpgroups while their ring keeps
    ``TC_MIN_STAGES`` stages, else two; per warpgroup an h tile of d/64
    slabs and an a table [64][a + 2] bf16 (a staged in bf16 for f32 and
    bf16 a alike), the bias [5120] bf16, then as many ring stages of
    ``TC_NB`` slabs as fit up to ``TC_MAX_STAGES``, the barriers and 1 KB
    of alignment slack; ``total`` is 0 where no plan holds (fewer than two
    stages)."""
    most = _tc_layout(d, l2, TC_WGS)
    if most["total"] and most["stages"] >= TC_MIN_STAGES:
        return most
    return _tc_layout(d, l2, 2)


def fwd_smem_bytes(d: int, is_bf16: bool, l2: bool) -> int:
    """K7's dynamic shared memory per block (mirrors tp_contract_fwd.cu,
    whose ``tp_contract_fwd_smem`` gives it on the card): bf16, the plan of
    ``fwd_smem_plan``; f32, at every width, the SIMT tile's two k-slabs of
    8 rows of the 64-row A tile and the 128-column B tile (rows padded by 4
    floats, csrc/simt_gemm.cuh) and the threads' output sums
    (``F32_OUT_SUMS`` floats for each of the tile's 128 threads)."""
    if is_bf16:
        return fwd_smem_plan(d, l2)["total"]
    return 4 * 2 * 8 * ((64 + 4) + (128 + 4)) + 4 * F32_OUT_SUMS * 128


def padded_width(d: int, is_bf16: bool) -> int:
    """The width K7 runs at: d rounded up to ``GRANULE``, in bf16 at least
    ``TC_MIN_WIDTH``."""
    dp = _pad.round_up(d, GRANULE)
    return max(dp, TC_MIN_WIDTH) if is_bf16 else dp


def _launch(h, a_list, wt, b, outs, l2: bool):
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    args = (h, *a_list, wt, b)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("tp_contract needs contiguous tensors")
    E, d0 = h.shape
    if E % TILE_EDGES or not 0 < d0 <= MAX_WIDTH:
        raise ValueError(f"tp_contract kernel needs E % {TILE_EDGES} == 0 "
                         f"and 0 < d <= {MAX_WIDTH} (E={E}, d={d0})")
    is_bf16 = h.dtype == torch.bfloat16
    d = padded_width(d0, is_bf16)
    h, wt = _pad.pad(h, (False, 1), d0, d), _pad.pad(wt, (False, 1), d0, d)
    # the bf16 kernel also copies the bias in 16-byte words
    if any(t.data_ptr() % 16 for t in ((h, wt, b) if is_bf16 else (h, wt))):
        raise ValueError("tp_contract needs 16-byte aligned h and wt (and b "
                         "in bf16)")
    lib = _lib()
    if not 0 < lib.tp_contract_fwd_smem(d, int(is_bf16),
                                        int(l2)) <= _SMEM_LIMIT:
        raise ValueError(f"tp_contract kernel: no shared-memory plan for "
                         f"d={d}")
    ptrs = [a.data_ptr() for a in a_list] + [None] * (3 - len(a_list))
    optrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    n_work = lib.tp_contract_fwd_workspace(E, int(is_bf16), int(l2))
    work = torch.empty(n_work, dtype=torch.float32, device=h.device) \
        if n_work else None
    err = lib.tp_contract_fwd(h.data_ptr(), *ptrs, wt.data_ptr(),
                              b.data_ptr(), *optrs,
                              None if work is None else work.data_ptr(), E,
                              d, int(is_bf16),
                              int(a_list[0].dtype == torch.float32), int(l2),
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


# ------------------------------------------------------------ backward (K8)

BWD_TILE_EDGES = 64  # the backward kernel's edge tile: E must be a multiple


def tp_contract_bwd_plain(paths, h, a_list, wt, b, dc_list):
    """The backward kernel's function in plain PyTorch (same casts and
    rounding) -> (dh in h.dtype, [da_i in h.dtype], dwt [5120, d] f32,
    db [5120] f32)."""
    cdt = h.dtype
    E = h.shape[0]
    w_all = (torch.matmul(h.float(), wt.float().t()) + b.float()).to(cdt)
    dcs = [dc.to(cdt) for dc in dc_list]
    das, parts = [None] * len(a_list), []
    for i, (U, V, off) in enumerate(paths):
        dc = dcs[0 if len(dcs) == 1 else i]
        ai = i if len(a_list) > 1 else 0
        wp = w_all[:, off:off + U * V].reshape(E, U, V)
        da = (dc[:, None, :] * wp).float().sum(dim=2)
        das[ai] = da if das[ai] is None else das[ai] + da
        parts.append((a_list[ai].to(cdt)[:, :, None]
                      * dc[:, None, :]).reshape(E, U * V))
    dwall = torch.cat(parts, dim=1).float()
    dh = torch.matmul(dwall, wt.float()).to(cdt)
    return (dh, [da.to(cdt) for da in das], torch.matmul(dwall.t(), h.float()),
            dwall.sum(dim=0))


def _check_bwd(paths, h, a_list, wt, b, dc_list):
    l2 = paths == PATHS_L2
    if not l2 and paths != PATHS_L1:
        raise ValueError("paths must be PATHS_L1 or PATHS_L2")
    widths = (64, 8, 8) if l2 else (64,)
    if len(a_list) != len(widths) or len(dc_list) != (1 if l2 else 3):
        raise ValueError(f"{'L2' if l2 else 'L1'} takes {len(widths)} a and "
                         f"{1 if l2 else 3} dc tensors")
    _check(h, a_list, widths, wt, b)
    E = h.shape[0]
    for i, (dc, w) in enumerate(zip(dc_list, (64,) if l2 else (64, 8, 8))):
        if tuple(dc.shape) != (E, w):
            raise ValueError(f"dc{i}: shape {tuple(dc.shape)} != {(E, w)}")
        if dc.device != h.device:
            raise ValueError(f"dc{i} on {dc.device}, h on {h.device}")
        if dc.dtype not in (torch.float32, h.dtype):
            raise TypeError(f"dc{i} must be f32 or h's dtype {h.dtype}, got "
                            f"{dc.dtype}")


BWD_GRANULE = 128  # K8's width granule: other widths are zero-padded


def _lib_bwd():
    lib = _build.load("tp_contract_bwd")
    fn = lib.tp_contract_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.tp_contract_bwd_smem.argtypes = [ctypes.c_int] * 3
        lib.tp_contract_bwd_workspace.argtypes = [ctypes.c_int] * 3
        for name in ("tp_contract_bwd_smem", "tp_contract_bwd_workspace"):
            getattr(lib, name).restype = ctypes.c_longlong
    return lib


def bwd_smem_plan(d: int, l2: bool) -> dict:
    """K8's dynamic shared memory per pass, for the CPU tests (mirrors
    tp_contract_bwd.cu, whose ``tp_contract_bwd_smem`` the wrapper asks on
    the card; ``chip_smoke.py`` holds the two equal). The bf16 tile
    pass: the h tile (d x 128 bytes) and the a/dc tables [64][80] bf16,
    then for d <= 256 two da tables [64][80] f32 (one a warpgroup) and the
    bias [5120] bf16, for d > 256 one 8 KB dwall slab per warpgroup and one
    da table; then as many 8 KB wt ring slabs as fit up to 16 (``chunks``
    chunks of d/64 must), barriers and 1 KB of alignment slack. The bf16
    weight pass: 4 stages of two h slabs, two A slabs per warpgroup
    (double-buffered) and the db sums. The f32 passes (csrc/simt_gemm.cuh):
    two k-slabs of 8 rows of the 64-row A tile and of the 128-column B
    tile, rows padded by 4 floats, at every width."""
    tables = 2 * 64 * 80 * 2 + 64 * 80 * 4
    split = d <= 256
    head = d * 128 + tables + (64 * 80 * 4 + 5120 * 2 if split
                               else 2 * 8192)
    ring = -(-head // 1024) * 1024
    stages = min(16, max(0, (_SMEM_LIMIT - 1024 - ring - 16 * 16 - 16)
                         // 8192))
    simt = 4 * 2 * 8 * ((64 + 4) + (128 + 4))
    return {"tile": 1024 + ring + stages * 8192 + 16 * stages + 16,
            "stages": stages, "chunks": 2 if split else 1,
            "weights": 1024 + 4 * 2 * 8192 + 4 * 8192 + 2 * 16 * 64 * 4
            + 16 * 4,
            "tile_f32": simt, "weights_f32": simt}


def tp_contract_bwd(paths, h, a_list, wt, b, dc_list):
    """K7's VJP -> (dh, [da_i], dwt, db) as ``tp_contract_bwd_plain``; the a
    and dc inputs come in f32 or h's dtype (the kernel rounds both to h's
    dtype first, as the plain version does)."""
    _check_bwd(paths, h, a_list, wt, b, dc_list)
    if h.device.type == "cpu":
        return tp_contract_bwd_plain(paths, h, a_list, wt, b, dc_list)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    cdt = h.dtype
    a_list = [a.to(cdt) for a in a_list]
    dc_list = [dc.to(cdt) for dc in dc_list]
    args = (h, *a_list, wt, b, *dc_list)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("tp_contract_bwd needs contiguous tensors")
    E, d0 = h.shape
    if E % BWD_TILE_EDGES or not 0 < d0 <= MAX_WIDTH:
        raise ValueError(f"tp_contract_bwd kernel needs E % "
                         f"{BWD_TILE_EDGES} == 0 and 0 < d <= {MAX_WIDTH} "
                         f"(E={E}, d={d0})")
    d = _pad.round_up(d0, BWD_GRANULE)
    h, wt = _pad.pad(h, (False, 1), d0, d), _pad.pad(wt, (False, 1), d0, d)
    args = (h, *a_list, wt, b, *dc_list)
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError("tp_contract_bwd needs 16-byte aligned tensors")
    l2 = paths == PATHS_L2
    lib = _lib_bwd()
    is_bf16 = int(cdt == torch.bfloat16)
    # each pass's block (kinds 0, 1 in bf16; 2, 3 in f32); the tile pass's
    # ring depth is checked at launch
    if not all(0 < lib.tp_contract_bwd_smem(d, kind, int(l2)) <= _SMEM_LIMIT
               for kind in ((0, 1) if is_bf16 else (2, 3))):
        raise ValueError(f"tp_contract_bwd kernel: no shared-memory plan "
                         f"for d={d}")
    dev = h.device
    dh = torch.empty_like(h)
    das = [torch.empty_like(a) for a in a_list]
    dwt = torch.empty((NUMEL, d), dtype=torch.float32, device=dev)
    db = torch.empty(NUMEL, dtype=torch.float32, device=dev)
    work = torch.empty(max(lib.tp_contract_bwd_workspace(E, d, is_bf16), 1),
                       dtype=torch.float32, device=dev)
    pad3 = lambda ts: [t.data_ptr() for t in ts] + [None] * (3 - len(ts))
    err = lib.tp_contract_bwd(h.data_ptr(), *pad3(a_list), wt.data_ptr(),
                              b.data_ptr(), *pad3(dc_list), dh.data_ptr(),
                              *pad3(das), dwt.data_ptr(), db.data_ptr(),
                              work.data_ptr(), E, d, is_bf16, int(l2),
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tp_contract_bwd")
    global bwd_launches
    bwd_launches += 1
    return (_pad.cut(dh, (False, 1), d0, d), das,
            _pad.cut(dwt, (False, 1), d0, d), db)


def _bwd_grads(ctx, dc_list):
    """Shared backward of the two Functions: K8, gradients in the primal
    dtypes (the f32 dwt/db cast to the cast parameters' dtype)."""
    h, wt, b, *a_list = ctx.saved_tensors
    dc_list = [dc.contiguous() for dc in dc_list]
    dh, das, dwt, db = tp_contract_bwd(ctx.paths, h, a_list, wt, b, dc_list)
    return (dh.to(h.dtype), *(da.to(a.dtype) for da, a in zip(das, a_list)),
            dwt.to(wt.dtype), db.to(b.dtype))


class TPContractL1(torch.autograd.Function):
    """(h, a, wt, b) -> (c0, c1, c2) through ``tp_contract_l1`` (K7); the
    backward is ``tp_contract_bwd`` (K8)."""

    @staticmethod
    def forward(ctx, h, a, wt, b):
        ctx.save_for_backward(h, wt, b, a)
        ctx.paths = PATHS_L1
        return tp_contract_l1(h, a, wt, b)

    @staticmethod
    def backward(ctx, dc0, dc1, dc2):
        return _bwd_grads(ctx, [dc0, dc1, dc2])


class TPContractL2(torch.autograd.Function):
    """(h, a0, a1, a2, wt, b) -> out through ``tp_contract_l2`` (K7); the
    backward is ``tp_contract_bwd`` (K8)."""

    @staticmethod
    def forward(ctx, h, a0, a1, a2, wt, b):
        ctx.save_for_backward(h, wt, b, a0, a1, a2)
        ctx.paths = PATHS_L2
        return tp_contract_l2(h, a0, a1, a2, wt, b)

    @staticmethod
    def backward(ctx, dc):
        return _bwd_grads(ctx, [dc])
