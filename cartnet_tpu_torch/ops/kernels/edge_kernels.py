"""CartNet edge phase: CUDA kernel wrapper and its plain PyTorch version.

Port of the Pallas forward kernel cartnet_tpu/ops/pallas/edge_kernels.py
(``edge_phase_fwd`` -> ``_fwd_kernel``). Per edge, with f32 accumulation:

    pre    = xi[dst] + xj[src] + e @ We + b            # [E, 2d]
    h      = silu(pre), rounded to e.dtype
    gate   = h[:, :d] @ W1g + b1g                      # [E, d], xi.dtype
    sender = h[:, d:] @ W1a + b1a                      # [E, d], xi.dtype

Optional outputs (off on the inference path): the backward's saved residual
in xi.dtype, ``[pre ‖ sigmoid(pre)]`` [E, 4d] or, with ``pre_only``, the
rounded ``pre`` alone [E, 2d] (the JAX package's ``saved=False``, which the
merged backward takes), and per-tile masked Welford partials
``s1_w``/``M2_w`` [E/tile, d] (f32) of the rounded gate over ``tile``-edge
windows; any tile size merges exactly in the training slice.

Node tables (xi, xj) come in bf16 or f32; e and the weights share the compute
dtype. Every edge is computed, pads included (pads point at real rows).
On a CUDA tensor ``edge_phase_fwd`` launches ``csrc/edge_phase_fwd.cu`` or
raises; on a CPU tensor it runs ``edge_phase_fwd_plain``. bf16 edges: one
CUDA launch a call (wgmma fed by TMA). f32 edges: two, SIMT GEMM tiles on
the CUDA cores, one output tile a block: the pre tiles write h in f32 to a
[E, 2d] scratch allocated here (``edge_phase_fwd_workspace``), the output
tiles read it for gate and sender and the window moments.

The live edge counts (``live_edges``): the f32-edge passes of K1 and of
K5/K6 take the batch's live counts, an int32 tensor on the device derived
from the masks once a forward, and spend no arithmetic on the 64-edge tiles
of the batch's tail of pads past them (the grids stay static, so a CUDA
graph replays any batch of its shape). K1 writes zero gate, sender and
moment rows there and leaves h and the saved residual unwritten (the
backward skips the same tiles); K5/K6 write de = deres there, cut their
weight-gradient edge ranges over the live tiles alone and stop their node
row walks at the counts. Every live row, de, dxi, dxj and the bias
gradients are bitwise those of a call without the counts; the weight
gradients agree with them to f32 rounding (another split of the same
sums). ``live=None`` is every edge; the bf16-edge routes and the plain
versions compute every edge whatever the counts say. The backward's
precondition: the cotangents of the edge rows at or past the first count
are zero (K5's dgate and dsender, K6's deout), so that the plain
versions' sums over every edge add only zeros there; the models'
cotangents are (``tests/test_torch_port_live_edges.py`` holds CartNet,
the eComformer and the iComformer to it). A caller whose pads carry
cotangents passes ``live=None``.

Widths: the wrappers of K1, K5 and K6 take every 1 <= d <= 512
(``MAX_WIDTH``). The kernels tile d in 64-column wgmma/TMA slabs shared by
two warpgroups, 128 columns a pair (and the f32 paths in 128-column
chunks), so a width that is not a multiple of 128 (``GRANULE``) is
zero-padded inside the wrapper to the next one (``_pad``; the ``*_PAD``
specs below say, by operand and output name, which axes carry d) and the
outputs are cut back. The padding is exact: padded rows and columns of We, W1g, W1a and of
b, b1g, b1a are zero, and so are the padded columns of xi, xj, e, so the
padded columns of pre are 0 and h = silu(0) = 0, and the padded gate and
sender columns are 0; no pad term enters a sum over a real column (every
product over d meets a zero factor there). In the backward the padded
cotangents (dgate, dsender, deres; deout, daggr) and window moments are
zero, so the padded dg, ds, dh and dpre are 0 and add nothing to de, the
node sums or the weight gradients; padded moments, residual columns and
gradients are cut away. The padded copies cost time at narrow widths only
(below 128). Above 512 the wrappers raise: K1's e and h tiles and K5/K6's
tile-pass tiles would not leave the TMA ring room in shared memory.

The backward (port of ``edge_phase_bwd_call`` -> ``_bwd_kernel``, driven by
``_ep_bwd``) is ``edge_phase_bwd``: on a CUDA tensor it launches
``csrc/edge_phase_bwd.cu`` (three launches per call: a tile pass, a
weight-gradient pass, a fixed-order reduce pass; no atomics; in bf16 the
first two run on wgmma fed by TMA, in f32 as SIMT GEMM tiles on the CUDA
cores) or raises; on a
CPU tensor it runs ``edge_phase_bwd_plain``. It needs node tables and edges
in one dtype, as training has them. ``EdgePhase`` is the autograd Function:
forward K1 with the saved residual and the moments, backward K5.

The merged sigma + edge backward (port of ``_merged_bwd_call`` ->
``_bwd_merged_kernel``, driven by ``_fes_bwd``) is ``merged_bwd``: on a CUDA
tensor it launches the second entry point of ``csrc/edge_phase_bwd.cu``
(K5's three passes with the sigma backward as the tile pass's prologue) or
raises; on a CPU tensor it runs ``merged_bwd_plain``. ``FusedEdgeSigma`` is
the JAX package's ``fused_edge_sigma`` under ``CARTNET_MERGED=1`` as one
autograd Function: forward K1 (pre-only residual, moments) -> the window-
moment BN merge -> K2; backward the BN's global sums in plain PyTorch, the
merge's VJP, then K6.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cartnet_tpu_torch.nn.norm import combine_window_moments
from cartnet_tpu_torch.ops.kernels import _build, _pad
from cartnet_tpu_torch.ops.kernels import segment_kernels as sk

# the CUDA kernel's edge tile: E must be a multiple of it, and it is the
# window of the optional s1_w/M2_w partials
TILE_EDGES = 64
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_DTYPES = (torch.float32, torch.bfloat16)

# launch counters: one a wrapper call that launches its kernel, also
# while a CUDA graph captures it (train/graphs.py); a replay calls no
# wrapper and counts nothing
launches = 0  # forward kernel launches (CUDA path only)
bwd_launches = 0  # backward kernel launches (CUDA path only)
merged_launches = 0  # merged backward (K6) launches (CUDA path only)


def live_edges(edge_mask, src_sorted_mask=None):
    """The batch's live edge counts, an int32 tensor [2] on the masks'
    device (no host sync, no copy): [0] one past the last masked-in edge
    and [1] one past the last masked-in position of the src-sorted order
    (``edge_mask_src_sorted``; E without it), each rounded up to the
    ``TILE_EDGES``-edge tile. Every edge and position at or past them is a
    masked-out pad, wherever the others lie (the per-graph ``EDGE_ALIGN``
    pads, an ep member's slice, a halo member's table), so the edge
    kernels may skip them; a batch with no tail gives E, an all-masked one
    0."""
    E = edge_mask.shape[0]
    if not E:
        return torch.zeros(2, dtype=torch.int32, device=edge_mask.device)
    idx = torch.arange(1, E + 1, dtype=torch.int32, device=edge_mask.device)
    masks = torch.stack((edge_mask, torch.ones_like(edge_mask)
                         if src_sorted_mask is None else src_sorted_mask))
    last = torch.where(masks, idx, 0).amax(dim=1)
    return torch.bitwise_and(last + (TILE_EDGES - 1), -TILE_EDGES)


def window_moments(gate, emask, tile: int):
    """Per-window masked Welford partials of the (rounded) gate, f32:
    s1_w = sum(m*g), M2_w = sum((m*(g - s1_w/n_w))^2) per ``tile`` edges."""
    nt = gate.shape[0] // tile
    g = gate.float().reshape(nt, tile, -1)
    mf = emask.reshape(nt, tile, 1).float()
    n_w = mf.sum(dim=1)
    s1 = (g * mf).sum(dim=1)
    mean_w = s1 / torch.clamp(n_w, min=1.0)
    diff = (g - mean_w[:, None, :]) * mf
    return s1, (diff * diff).sum(dim=1)


def edge_phase_fwd_plain(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src,
                         emask, *, saved: bool = False, pre_only: bool = False,
                         moments: bool = False, tile: int = TILE_EDGES,
                         live=None):
    """The kernel's function in plain PyTorch (same casts and rounding).
    Returns (gate, sender, saved | None, s1_w | None, M2_w | None).
    ``live`` is taken and ignored: the plain version computes every edge,
    so it stands in for the wrapper wherever a caller passes the counts."""
    cdt = xi.dtype
    d = w1g.shape[0]
    gi = xi.index_select(0, dst).float()
    gj = xj.index_select(0, src).float()
    ew = torch.matmul(e.float(), we.float())
    pre = gi + gj + ew + b.float()
    sig = torch.sigmoid(pre)
    h = (pre * sig).to(e.dtype)
    gate = torch.matmul(h[:, :d].float(), w1g.float()) + b1g.float()
    sender = torch.matmul(h[:, d:].float(), w1a.float()) + b1a.float()
    gate = gate.to(cdt)
    res = None
    if saved:
        res = pre.to(cdt) if pre_only else torch.cat([pre.to(cdt),
                                                      sig.to(cdt)], dim=1)
    s1w = m2w = None
    if moments:
        s1w, m2w = window_moments(gate, emask, tile)
    return gate, sender.to(cdt), res, s1w, m2w


def _check(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask):
    E, d = e.shape
    shapes = {"xi": (xi, (xi.shape[0], 2 * d)), "xj": (xj, (xj.shape[0], 2 * d)),
              "we": (we, (d, 2 * d)), "b": (b, (2 * d,)),
              "w1g": (w1g, (d, d)), "b1g": (b1g, (d,)),
              "w1a": (w1a, (d, d)), "b1a": (b1a, (d,)),
              "dst": (dst, (E,)), "src": (src, (E,)), "emask": (emask, (E,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != e.device:
            raise ValueError(f"{name} on {t.device}, e on {e.device}")
    if xi.dtype not in _DTYPES or xj.dtype != xi.dtype:
        raise TypeError(f"node tables must share f32/bf16, got "
                        f"{xi.dtype}/{xj.dtype}")
    if e.dtype not in _DTYPES:
        raise TypeError(f"e must be f32/bf16, got {e.dtype}")
    for name, t in (("we", we), ("b", b), ("w1g", w1g), ("b1g", b1g),
                    ("w1a", w1a), ("b1a", b1a)):
        if t.dtype != e.dtype:
            raise TypeError(f"{name} is {t.dtype}; weights share e's "
                            f"compute dtype {e.dtype}")
    if dst.dtype != torch.int32 or src.dtype != torch.int32:
        raise TypeError("dst/src must be int32")
    if emask.dtype != torch.bool:
        raise TypeError("emask must be bool")


def _check_live(live, e) -> None:
    """``live`` is None or the int32 [2] counts of ``live_edges`` on e's
    device."""
    if live is None:
        return
    if live.dtype != torch.int32 or tuple(live.shape) != (2,):
        raise ValueError(f"live must be int32 [2] (live_edges), got "
                         f"{live.dtype} {tuple(live.shape)}")
    if live.device != e.device or not live.is_contiguous():
        raise ValueError(f"live must be contiguous on {e.device}")


MAX_WIDTH = 512  # the widest d the edge kernels take
GRANULE = 128  # the kernels' width granule: other widths are zero-padded
# pad specs (``_pad``) by name: K1's operands and outputs (the saved
# residual [pre | sig], or pre alone), the backwards' outputs, and the
# operands of K5 and K6 (those they share, then each one's own)
_INDEX_PAD = dict(dst=None, src=None, emask=None, dst_rowptr=None,
                  src_perm=None, src_rowptr=None)
FWD_PAD = dict(xi=(False, 2), xj=(False, 2), e=(False, 1), we=(True, 2),
               b=(False, 2), w1g=(True, 1), b1g=(False, 1), w1a=(True, 1),
               b1a=(False, 1), dst=None, src=None, emask=None)
FWD_OUT_PAD = dict(gate=(False, 1), sender=(False, 1), saved=(False, 4),
                   s1_w=(False, 1), M2_w=(False, 1))
FWD_OUT_PAD_PRE = dict(FWD_OUT_PAD, saved=(False, 2))
BWD_OUT_PAD = dict(de=(False, 1), dxi=(False, 2), dxj=(False, 2),
                   dwe=(True, 2), db=(False, 2), dw1g=(True, 1),
                   db1g=(False, 1), dw1a=(True, 1), db1a=(False, 1))
_SHARED_PAD = dict(e=(False, 1), we=(True, 2), w1g=(True, 1), w1a=(True, 1),
                   gate=(False, 1), meanw=(False, 1), ds1w=(False, 1),
                   dm2w=(False, 1), **_INDEX_PAD)
BWD_PAD = dict(_SHARED_PAD, saved=(False, 4), dgate=(False, 1),
               dsender=(False, 1), deres=(False, 1))
MERGED_PAD = dict(_SHARED_PAD, pre=(False, 2), sender=(False, 1), env=None,
                  scale=(False, 1), shift=(False, 1), deout=(False, 1),
                  daggr=(False, 1))


def padded_width(d: int) -> int:
    """The width the edge kernels run at for a real width d."""
    if not 0 < d <= MAX_WIDTH:
        raise ValueError(f"the edge kernels take 0 < d <= {MAX_WIDTH}, "
                         f"got d={d}")
    return _pad.round_up(d, GRANULE)


# blocks an SM the f32-edge passes are compiled for (edge_phase_fwd.cu's
# ``__launch_bounds__``)
F32_BLOCKS = 4


def fwd_smem_plan(d: int, edge_bf16: bool) -> dict:
    """K1's dynamic shared memory per block, for the CPU tests (mirrors
    edge_phase_fwd.cu, whose ``edge_phase_fwd_smem`` the wrapper asks on
    the card; ``chip_smoke.py`` holds the two equal): bf16 edges, the
    wgmma kernel's e and h tiles (d x 128 bytes each), 8 KB of moment sums,
    the tile's ids, then as many 8 KB TMA ring stages as fit up to 16,
    barriers and 1 KB of alignment slack; f32 edges, both passes' SIMT
    tile at every width: two k-slabs of 8 rows of the 64-row A tile and the
    128-column B tile, rows padded by 4 floats (csrc/simt_gemm.cuh)."""
    if edge_bf16:
        ring = _a1024(2 * d * 128 + 8192 + 4 * 3 * TILE_EDGES + 16)
        stages = min(16, max(0, (_SMEM_LIMIT - 1024 - ring - 16 * 16 - 16)
                             // 8192))
        return {"total": 1024 + ring + stages * 8192 + 16 * stages + 16,
                "stages": stages}
    return {"total": 4 * 2 * 8 * ((64 + 4) + (128 + 4)), "stages": 0}


def _smem_bytes(d: int, edge_bf16: bool) -> int:
    """Dynamic shared memory of one K1 block (``fwd_smem_plan``)."""
    return fwd_smem_plan(d, edge_bf16)["total"]


def _a1024(n: int) -> int:
    return -(-n // 1024) * 1024


def bwd_smem_plan(d: int, bf16: bool) -> dict:
    """K5/K6's shared memory per pass, for the CPU tests (mirrors
    edge_phase_bwd.cu, whose ``edge_phase_bwd_smem`` gives the tile pass's
    on the card; ``chip_smoke.py`` holds the two equal): bf16,
    the tile pass's TMA ring (8 KB stages, as many as fit up to 16), dg/ds
    [64, d] and dpre_c [64, 2d] tiles, 4 KB of sums, barriers and 1 KB of
    alignment slack, and the weight pass's 4 stages of 32 KB; f32, both
    passes' two k-slabs of 8 rows of the 64-row A tile and the 128-column
    B tile, rows padded by 4 floats (csrc/simt_gemm.cuh), at every
    width."""
    if bf16:
        fixed = 1024 + 384 * d + 4096 + 16 * 16
        stages = min(16, max(0, (_SMEM_LIMIT - fixed) // 8192))
        return {"tile": 1024 + stages * 8192 + 384 * d + 4096 + 16 * stages,
                "weights": 1024 + 4 * 4 * 8192 + 16 * 4, "stages": stages}
    simt = 4 * 2 * 8 * ((64 + 4) + (128 + 4))
    return {"tile": simt, "weights": simt, "stages": 0}


def _lib():
    lib = _build.load("edge_phase_fwd")
    fn = lib.edge_phase_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.edge_phase_fwd_smem.argtypes = [ctypes.c_int] * 2
        lib.edge_phase_fwd_workspace.argtypes = [ctypes.c_int] * 3
        for name in ("edge_phase_fwd_smem", "edge_phase_fwd_workspace"):
            getattr(lib, name).restype = ctypes.c_longlong
    return lib


def edge_phase_fwd(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask, *,
                   saved: bool = False, pre_only: bool = False,
                   moments: bool = False, live=None):
    """Fused gather + edge MLPs -> (gate, sender, saved | None,
    s1_w | None, M2_w | None); see the module docstring (``live``: the
    batch's ``live_edges``, or None for every edge)."""
    _check(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask)
    _check_live(live, e)
    if e.device.type == "cpu":
        return edge_phase_fwd_plain(xi, xj, e, we, b, w1g, b1g, w1a, b1a,
                                    dst, src, emask, saved=saved,
                                    pre_only=pre_only, moments=moments)
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    ops = dict(xi=xi, xj=xj, e=e, we=we, b=b, w1g=w1g, b1g=b1g, w1a=w1a,
               b1a=b1a, dst=dst, src=src, emask=emask)
    if not all(t.is_contiguous() for t in ops.values()):
        raise ValueError("edge_phase_fwd needs contiguous tensors")
    E, d = e.shape
    if E % TILE_EDGES:
        raise ValueError(f"edge_phase_fwd kernel needs E % {TILE_EDGES} == 0"
                         f" (E={E})")
    dp = padded_width(d)
    outs = _launch_fwd(**_pad.pad_named(ops, FWD_PAD, d, dp), saved=saved,
                       pre_only=pre_only, moments=moments, live=live)
    return tuple(_pad.cut_named(outs, FWD_OUT_PAD_PRE if pre_only
                                else FWD_OUT_PAD, d, dp).values())


def _launch_fwd(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask, *,
                saved: bool, pre_only: bool, moments: bool, live) -> dict:
    """One call of csrc/edge_phase_fwd.cu at the padded width -> the
    outputs by name (``FWD_OUT_PAD``)."""
    # TMA and the f32 tiles' float4 loads read e and the weights (16-byte
    # aligned); both paths read the node tables as pairs of elements
    # (float2 at most: 8 bytes)
    if any(t.data_ptr() % 16 for t in (e, we, w1g, w1a)) or any(
            t.data_ptr() % 8 for t in (xi, xj)):
        raise ValueError("edge_phase_fwd needs e and the weights 16-byte "
                         "aligned and the node tables 8-byte aligned")
    E, d = e.shape
    edge_bf16 = e.dtype == torch.bfloat16
    lib = _lib()
    if d % GRANULE or lib.edge_phase_fwd_smem(d, int(edge_bf16)) \
            > _SMEM_LIMIT:
        raise ValueError(f"edge_phase_fwd kernel: no shared-memory plan for "
                         f"d={d}")
    dev, cdt = e.device, xi.dtype
    gate = torch.empty((E, d), dtype=cdt, device=dev)
    sender = torch.empty((E, d), dtype=cdt, device=dev)
    res = (torch.empty((E, (2 if pre_only else 4) * d), dtype=cdt,
                       device=dev) if saved else None)
    nt = E // TILE_EDGES
    s1w = torch.empty((nt, d), dtype=torch.float32, device=dev) \
        if moments else None
    m2w = torch.empty_like(s1w) if moments else None
    n_work = lib.edge_phase_fwd_workspace(E, d, int(edge_bf16))
    work = torch.empty(n_work, dtype=torch.float32, device=dev) \
        if n_work else None
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask)
    err = lib.edge_phase_fwd(
        *(ptr(t) for t in args), ptr(gate), ptr(sender), ptr(res), ptr(s1w),
        ptr(m2w), ptr(work), ptr(live), E, d, int(cdt == torch.bfloat16),
        int(edge_bf16), int(not pre_only),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "edge_phase_fwd")
    global launches
    launches += 1
    return dict(gate=gate, sender=sender, saved=res, s1_w=s1w, M2_w=m2w)


# ------------------------------------------------------------ backward (K5)

def _bwd_tail(e, we, w1g, w1a, pre, sig, dg, ds, deres, dst, src, emask,
              num_nodes: int, num_src: int):
    """K5's body from the rounded dg/ds on (shared with K6's plain
    version): f32 pre and sig of the residual -> (de, dxi [num_nodes, 2d],
    dxj [num_src, 2d], dwe, db, dw1g, db1g, dw1a, db1a)."""
    cdt = e.dtype
    d = w1g.shape[0]
    f = lambda t: t.float()
    h32 = pre * sig
    h = h32.to(cdt)
    dh = torch.cat([torch.matmul(f(dg), f(w1g).t()),
                    torch.matmul(f(ds), f(w1a).t())], dim=1)
    dpre = dh * (sig + h32 * (1.0 - sig))
    dpre_c = f(dpre.to(cdt))
    de = (f(deres) + torch.matmul(dpre_c, f(we).t())).to(e.dtype)
    node = torch.where(emask[:, None], dpre_c, torch.zeros_like(dpre_c))
    dxi = torch.zeros((num_nodes, 2 * d), dtype=torch.float32,
                      device=e.device).index_add_(0, dst, node)
    dxj = torch.zeros((num_src, 2 * d), dtype=torch.float32,
                      device=e.device).index_add_(0, src, node)
    return (de, dxi, dxj, torch.matmul(f(e).t(), dpre_c), dpre.sum(dim=0),
            torch.matmul(f(h[:, :d]).t(), f(dg)), f(dg).sum(dim=0),
            torch.matmul(f(h[:, d:]).t(), f(ds)), f(ds).sum(dim=0))


def _moment_fold(gate, meanw, ds1w, dm2w, emask, tile: int):
    """m * (ds1_w + 2 dM2_w (gate - mean_w)) [E, d] f32: the BN-moment
    cotangents of each ``tile``-edge window, folded into dgate."""
    E, d = gate.shape
    nt = E // tile
    f = lambda t: t.float()
    mf = emask.reshape(nt, tile, 1).float()
    corr = (f(ds1w)[:, None, :] + 2.0 * f(dm2w)[:, None, :]
            * (f(gate).reshape(nt, tile, d) - f(meanw)[:, None, :]))
    return (mf * corr).reshape(E, d)


def edge_phase_bwd_plain(e, we, w1g, w1a, saved, gate, meanw, ds1w, dm2w,
                         dgate, dsender, deres, dst, src, emask,
                         num_nodes: int, num_src: Optional[int] = None, *,
                         tile: int = TILE_EDGES):
    """The backward kernel's function in plain PyTorch (same casts and
    rounding) -> (de, dxi, dxj, dwe, db, dw1g, db1g, dw1a, db1a); dxi
    [num_nodes, 2d], dxj [num_src, 2d] (num_src: num_nodes unless the src
    table is longer, as under halo partitioning) and the weight/bias
    gradients are f32, de in e.dtype. ``meanw``/``ds1w``/``dm2w`` are
    per-``tile``-edge window rows."""
    cdt = e.dtype
    d = gate.shape[1]
    pre, sig = saved[:, :2 * d].float(), saved[:, 2 * d:].float()
    dg = (dgate.float() + _moment_fold(gate, meanw, ds1w, dm2w, emask,
                                       tile)).to(cdt)
    return _bwd_tail(e, we, w1g, w1a, pre, sig, dg, dsender.to(cdt), deres,
                     dst, src, emask, num_nodes,
                     num_nodes if num_src is None else num_src)


_INDEX_NAMES = ("dst", "src", "dst_rowptr", "src_perm", "src_rowptr")


def _check_bwd(e, tensors, f32_names=("meanw", "ds1w", "dm2w")):
    """Shapes, devices and dtypes of a backward's operands: ``tensors`` maps
    name -> (tensor, shape); the index tensors are int32, emask bool, the
    ``f32_names`` f32 and every other tensor in e's dtype."""
    E = e.shape[0]
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.device != e.device:
            raise ValueError(f"{name} on {t.device}, e on {e.device}")
    if E % TILE_EDGES:
        raise ValueError(f"E={E} must be a multiple of {TILE_EDGES}")
    if e.dtype not in _DTYPES:
        raise TypeError(f"e must be f32/bf16, got {e.dtype}")
    for name, (t, _) in tensors.items():
        want = (torch.int32 if name in _INDEX_NAMES else torch.bool
                if name == "emask" else torch.float32 if name in f32_names
                else e.dtype)
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, must be {want} (the "
                            f"backward takes node tables, edges and weights "
                            f"in one dtype)")


def _shared_shapes(e, we, w1g, w1a, gate, meanw, ds1w, dm2w, dst, src, emask,
                   dst_rowptr, src_perm, src_rowptr):
    """The operands K5 and K6 share, name -> (tensor, shape). The dst
    and src row counts N and Ns are the two rowptrs' lengths less one; the
    src table holds the dst one and more (Ns >= N: equal without halo
    partitioning, the received rows more with it)."""
    E, d = e.shape
    nt = E // TILE_EDGES
    N = dst_rowptr.shape[0] - 1
    Ns = max(src_rowptr.shape[0] - 1, N) if src_rowptr.dim() == 1 else N
    return {"we": (we, (d, 2 * d)), "w1g": (w1g, (d, d)),
            "w1a": (w1a, (d, d)), "gate": (gate, (E, d)),
            "meanw": (meanw, (nt, d)), "ds1w": (ds1w, (nt, d)),
            "dm2w": (dm2w, (nt, d)), "dst": (dst, (E,)), "src": (src, (E,)),
            "emask": (emask, (E,)), "src_perm": (src_perm, (E,)),
            "dst_rowptr": (dst_rowptr, (N + 1,)),
            "src_rowptr": (src_rowptr, (Ns + 1,))}


def _lib_bwd():
    lib = _build.load("edge_phase_bwd")
    fn = lib.edge_phase_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 26 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.edge_phase_merged_bwd.argtypes = [ctypes.c_void_p] * 31 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.edge_phase_merged_bwd.restype = ctypes.c_int
        lib.edge_phase_bwd_workspace.argtypes = [ctypes.c_int] * 3
        lib.edge_phase_bwd_smem.argtypes = [ctypes.c_int] * 2
        for name in ("edge_phase_bwd_workspace", "edge_phase_bwd_smem"):
            getattr(lib, name).restype = ctypes.c_longlong
    return lib


def _launch_bwd(entry: str, ops: dict, specs: dict, N: int, Ns: int, live):
    """Launch ``entry`` of csrc/edge_phase_bwd.cu (dxi over the ``N`` dst
    rows, dxj over the ``Ns`` src rows; ``live`` the live counts or None)
    on the operands ``ops``
    (name -> tensor in the entry point's order; contiguous; zero-padded to
    the kernels' granule by their ``specs``; an operand that is not
    16-byte aligned, as the kernel's vector and TMA loads need, is copied
    first) with fresh outputs and scratch -> (de, dxi, dxj, dwe, db, dw1g,
    db1g, dw1a, db1a) at the real width."""
    if not all(t.is_contiguous() for t in ops.values()):
        raise ValueError(f"{entry} needs contiguous tensors")
    E, d0 = ops["e"].shape
    if E == 0:
        raise ValueError(f"{entry} kernel needs E > 0")
    d = padded_width(d0)
    args = [t.clone() if t.data_ptr() % 16 else t
            for t in _pad.pad_named(ops, specs, d0, d).values()]
    e = args[0]
    lib = _lib_bwd()
    is_bf16 = int(e.dtype == torch.bfloat16)
    dev, f32 = e.device, torch.float32
    de = torch.empty_like(e)
    scratch = [torch.empty((E, d), dtype=e.dtype, device=dev)]  # dg
    if entry == "edge_phase_merged_bwd":
        scratch.append(torch.empty((E, d), dtype=e.dtype, device=dev))  # ds
    scratch.append(torch.empty((E, 2 * d), dtype=e.dtype, device=dev))
    # h_c = round(pre sig), written by the bf16 tile pass for the weight pass
    h = torch.empty((E, 2 * d), dtype=e.dtype, device=dev) if is_bf16 \
        else None
    dxi = torch.empty((N, 2 * d), dtype=f32, device=dev)
    dxj = torch.empty((Ns, 2 * d), dtype=f32, device=dev)
    dw = torch.empty(4 * d * d, dtype=f32, device=dev)
    dbias = torch.empty(4 * d, dtype=f32, device=dev)
    work = torch.empty(lib.edge_phase_bwd_workspace(E, d, is_bf16),
                       dtype=f32, device=dev)
    outs = (de, *scratch, h, dxi, dxj, dw, dbias, work, live)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = getattr(lib, entry)(*(ptr(t) for t in tuple(args) + outs),
                              E, N, Ns, d, is_bf16,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    d2 = 2 * d * d
    grads = dict(de=de, dxi=dxi, dxj=dxj, dwe=dw[:d2].view(d, 2 * d),
                 db=dbias[:2 * d], dw1g=dw[d2:d2 + d * d].view(d, d),
                 db1g=dbias[2 * d:3 * d], dw1a=dw[d2 + d * d:].view(d, d),
                 db1a=dbias[3 * d:])
    return tuple(_pad.cut_named(grads, BWD_OUT_PAD, d0, d).values())


def edge_phase_bwd(e, we, w1g, w1a, saved, gate, meanw, ds1w, dm2w, dgate,
                   dsender, deres, dst, src, emask, dst_rowptr, src_perm,
                   src_rowptr, *, live=None):
    """The edge-phase backward -> (de, dxi, dxj, dwe, db, dw1g, db1g, dw1a,
    db1a), as ``edge_phase_bwd_plain``; see the module docstring (``live``:
    the counts the forward took; dgate and dsender must be zero on the
    edge rows at or past its first count, or the result is not the plain
    version's)."""
    E, d = e.shape
    tensors = _shared_shapes(e, we, w1g, w1a, gate, meanw, ds1w, dm2w, dst,
                             src, emask, dst_rowptr, src_perm, src_rowptr)
    tensors.update(saved=(saved, (E, 4 * d)), dgate=(dgate, (E, d)),
                   dsender=(dsender, (E, d)), deres=(deres, (E, d)))
    _check_bwd(e, tensors)
    _check_live(live, e)
    N, Ns = dst_rowptr.shape[0] - 1, src_rowptr.shape[0] - 1
    if e.device.type == "cpu":
        return edge_phase_bwd_plain(e, we, w1g, w1a, saved, gate, meanw,
                                    ds1w, dm2w, dgate, dsender, deres, dst,
                                    src, emask, N, Ns)
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    grads = _launch_bwd("edge_phase_bwd", dict(
        e=e, we=we, w1g=w1g, w1a=w1a, saved=saved, gate=gate, meanw=meanw,
        ds1w=ds1w, dm2w=dm2w, dgate=dgate, dsender=dsender, deres=deres,
        emask=emask, dst_rowptr=dst_rowptr, src_perm=src_perm,
        src_rowptr=src_rowptr), BWD_PAD, N, Ns, live)
    global bwd_launches
    bwd_launches += 1
    return grads


# ------------------------------------------------- merged backward (K6)

def merged_bwd_plain(e, we, w1g, w1a, pre, gate, sender, env, scale, shift,
                     meanw, ds1w, dm2w, deout, daggr, dst, src, emask,
                     num_src: Optional[int] = None, *,
                     tile: int = TILE_EDGES):
    """The merged backward kernel's function in plain PyTorch, in the order
    of ``_bwd_merged_kernel`` (same casts and rounding): the sigma backward
    (dvals = daggr[dst] on masked-in edges), ds = dvals sig0 env and
    dg = da scale + the moment fold, each rounded once, sig = sigmoid(pre)
    in f32, then K5's body with deout as the residual's cotangent. -> (de,
    dxi, dxj, dwe, db, dw1g, db1g, dw1a, db1a), as K5's: dxi over daggr's
    rows, dxj over ``num_src`` (daggr's rows by default)."""
    cdt = e.dtype
    f = lambda t: t.float()
    dvals = daggr.index_select(0, dst).float()
    dvals = torch.where(emask[:, None], dvals, torch.zeros_like(dvals))
    sig0 = torch.sigmoid(f(gate) * f(scale) + f(shift))
    env32 = f(env)
    dsig = f(deout) + dvals * f(sender)
    da = dsig * env32 * sig0 * (1.0 - sig0)
    ds = (dvals * sig0 * env32).to(cdt)
    dg = (da * f(scale) + _moment_fold(gate, meanw, ds1w, dm2w, emask,
                                       tile)).to(cdt)
    pre32 = f(pre)
    return _bwd_tail(e, we, w1g, w1a, pre32, torch.sigmoid(pre32), dg, ds,
                     deout, dst, src, emask, daggr.shape[0],
                     daggr.shape[0] if num_src is None else num_src)


def merged_bwd(e, we, w1g, w1a, pre, gate, sender, env, scale, shift, meanw,
               ds1w, dm2w, deout, daggr, dst, src, emask, dst_rowptr,
               src_perm, src_rowptr, *, live=None):
    """The merged sigma + edge backward -> (de, dxi, dxj, dwe, db, dw1g,
    db1g, dw1a, db1a), as ``merged_bwd_plain``; see the module docstring.
    pre [E, 2d], gate, sender, deout [E, d], env [E, 1] and daggr [N, d]
    share e's dtype; scale/shift [d] and the window rows are f32; ``live``
    the counts the forward took (deout must be zero on the edge rows at or
    past its first count, or the result is not the plain version's)."""
    E, d = e.shape
    N, Ns = dst_rowptr.shape[0] - 1, src_rowptr.shape[0] - 1
    tensors = _shared_shapes(e, we, w1g, w1a, gate, meanw, ds1w, dm2w, dst,
                             src, emask, dst_rowptr, src_perm, src_rowptr)
    tensors.update(pre=(pre, (E, 2 * d)), sender=(sender, (E, d)),
                   env=(env, (E, 1)), scale=(scale, (d,)),
                   shift=(shift, (d,)), deout=(deout, (E, d)),
                   daggr=(daggr, (N, d)))
    _check_bwd(e, tensors, ("meanw", "ds1w", "dm2w", "scale", "shift"))
    _check_live(live, e)
    if e.device.type == "cpu":
        return merged_bwd_plain(e, we, w1g, w1a, pre, gate, sender, env,
                                scale, shift, meanw, ds1w, dm2w, deout,
                                daggr, dst, src, emask, Ns)
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    grads = _launch_bwd("edge_phase_merged_bwd", dict(
        e=e, we=we, w1g=w1g, w1a=w1a, pre=pre, gate=gate, sender=sender,
        env=env, scale=scale, shift=shift, meanw=meanw, ds1w=ds1w,
        dm2w=dm2w, deout=deout, daggr=daggr, dst=dst, emask=emask,
        dst_rowptr=dst_rowptr, src_perm=src_perm, src_rowptr=src_rowptr),
        MERGED_PAD, N, Ns, live)
    global merged_launches
    merged_launches += 1
    return grads


class EdgePhase(torch.autograd.Function):
    """(xi, xj, e, we, b, w1g, b1g, w1a, b1a) -> (gate, sender, e_res, s1_w,
    M2_w) through K1 with the saved residual and the per-tile moments.
    e_res is e passed through, so the layer's residual cotangent arrives
    here as ``deres`` and leaves folded into de (once). The backward forms
    mean_w = s1_w / max(n_w, 1) and runs K5; gradients come back in the
    primal dtypes. With ``moments=False`` (the Comformer conv, whose BN
    normalizes another tensor) K1 skips the moments, s1_w/M2_w are None, and
    K5 gets zero moment cotangents, so its correction term vanishes. xi and
    xj may have different row counts (halo partitioning: xj spans the src
    table [local ‖ received rows]); ``dst_rowptr`` and ``src_rowptr`` are
    over xi's and xj's rows, and dxi/dxj come back with them. ``live`` (the
    batch's ``live_edges``, or None) bounds K1 and K5 alike."""

    @staticmethod
    def forward(ctx, xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask,
                dst_rowptr, src_perm, src_rowptr, moments=True, live=None):
        gate, sender, saved, s1w, m2w = edge_phase_fwd(
            xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask,
            saved=True, moments=moments, live=live)
        ctx.save_for_backward(e, we, w1g, w1a, dst, src, emask, dst_rowptr,
                              src_perm, src_rowptr, saved, gate, s1w, live)
        ctx.dtypes = [t.dtype for t in (xi, xj, e, we, b, w1g, b1g, w1a,
                                        b1a)]
        return gate, sender, e, s1w, m2w

    @staticmethod
    def backward(ctx, dgate, dsender, deres, ds1w, dm2w):
        (e, we, w1g, w1a, dst, src, emask, dst_rowptr, src_perm, src_rowptr,
         saved, gate, s1w, live) = ctx.saved_tensors
        c = lambda t, dt: t.to(dt).contiguous()
        if s1w is None:
            meanw = torch.zeros((e.shape[0] // TILE_EDGES, e.shape[1]),
                                dtype=torch.float32, device=e.device)
            ds1w = dm2w = meanw
        else:
            nt = s1w.shape[0]
            n_w = emask.reshape(nt, -1).sum(dim=1,
                                            dtype=torch.float32)[:, None]
            meanw = s1w / torch.clamp(n_w, min=1.0)
        grads = edge_phase_bwd(
            e, we, w1g, w1a, saved, gate, meanw, c(ds1w, torch.float32),
            c(dm2w, torch.float32), c(dgate, gate.dtype),
            c(dsender, gate.dtype), c(deres, e.dtype), dst, src, emask,
            dst_rowptr, src_perm, src_rowptr, live=live)
        de, dxi, dxj, dwe, db, dw1g, db1g, dw1a, db1a = grads
        # in the primal order: xi, xj, e, we, b, w1g, b1g, w1a, b1a
        primal = (dxi, dxj, de, dwe, db, dw1g, db1g, dw1a, db1a)
        return tuple(g.to(dt) for g, dt in zip(primal, ctx.dtypes)) \
            + (None,) * 8


class FusedEdgeSigma(torch.autograd.Function):
    """The JAX package's ``fused_edge_sigma`` under ``CARTNET_MERGED=1``
    (``_fes_op``): (xi, xj, e, we, b, w1g, b1g, w1a, b1a, gamma, beta, env)
    -> (e_out, aggr, mean, var, n). Forward: K1 with the pre-only residual
    and the per-tile moments -> ``combine_window_moments`` (train BN
    scale/shift) -> K2, e_out = e + sigma. mean/var/n feed the running-stat
    update outside and carry no gradient. Backward (``_fes_bwd``): phase A'
    (the BN backward's global sums dscale/dshift and the env cotangent, over
    every edge, pads included, in plain PyTorch), the VJP of the
    window-moment merge through autograd on the same
    ``combine_window_moments`` the forward ran, then K6; gradients come back
    in the primal dtypes, denv only when autograd asks for it (the model's
    env has no gradient). env [E, 1] is in gate's dtype. With a process
    ``group`` the merge is sync BN (nn/norm.py), and the backward runs it
    again, its all-reduces included, on every rank of the group. ``live``
    (the batch's ``live_edges``, or None) bounds K1 and K6 alike."""

    @staticmethod
    def forward(ctx, xi, xj, e, we, b, w1g, b1g, w1a, b1a, gamma, beta, env,
                dst, src, emask, dst_rowptr, src_perm, src_rowptr,
                eps: float, group=None, live=None):
        gate, sender, pre, s1w, m2w = edge_phase_fwd(
            xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask,
            saved=True, pre_only=True, moments=True, live=live)
        nt = s1w.shape[0]
        n_w = emask.reshape(nt, -1).sum(dim=1, dtype=torch.float32)[:, None]
        (scale, shift), (mean, var, n) = combine_window_moments(
            gamma, beta, s1w, m2w, n_w, eps, group)
        scale, shift = scale.float().contiguous(), shift.float().contiguous()
        e_out, aggr = sk.sigma_segsum(gate, scale, shift, env, sender, e, dst,
                                      emask, dst_rowptr,
                                      dst_rowptr.shape[0] - 1)
        ctx.save_for_backward(e, we, w1g, w1a, gamma, beta, env, dst, src,
                              emask, dst_rowptr, src_perm, src_rowptr, pre,
                              gate, sender, s1w, m2w, scale, shift, live)
        ctx.eps, ctx.group = eps, group
        ctx.dtypes = [t.dtype for t in (xi, xj, e, we, b, w1g, b1g, w1a,
                                        b1a)]
        ctx.mark_non_differentiable(mean, var, n)
        return e_out, aggr, mean, var, n

    @staticmethod
    def backward(ctx, deout, daggr, _dmean, _dvar, _dn):
        (e, we, w1g, w1a, gamma, beta, env, dst, src, emask, dst_rowptr,
         src_perm, src_rowptr, pre, gate, sender, s1w, m2w, scale,
         shift, live) = ctx.saved_tensors
        deout = deout.to(e.dtype).contiguous()
        daggr = daggr.to(gate.dtype).contiguous()
        # phase A'
        g32 = gate.float()
        sig0 = torch.sigmoid(g32 * scale + shift)
        dvals = daggr.index_select(0, dst).float()
        dvals = torch.where(emask[:, None], dvals, torch.zeros_like(dvals))
        dsig = deout.float() + dvals * sender.float()
        denv = ((dsig * sig0).sum(dim=1, keepdim=True).to(env.dtype)
                if ctx.needs_input_grad[11] else None)
        da = dsig * env.float() * sig0 * (1.0 - sig0)
        dscale, dshift = (da * g32).sum(dim=0), da.sum(dim=0)
        # the merge's VJP -> dgamma, dbeta and the window cotangents
        nt = s1w.shape[0]
        n_w = emask.reshape(nt, -1).sum(dim=1, dtype=torch.float32)[:, None]
        with torch.enable_grad():
            prim = [t.detach().requires_grad_()
                    for t in (gamma, beta, s1w, m2w)]
            (sc, sh), _ = combine_window_moments(*prim, n_w, ctx.eps,
                                                 ctx.group)
            dgamma, dbeta, ds1w, dm2w = torch.autograd.grad(
                (sc, sh), prim, (dscale.to(sc.dtype), dshift.to(sh.dtype)))
        meanw = s1w / torch.clamp(n_w, min=1.0)
        de, dxi, dxj, dwe, db, dw1g, db1g, dw1a, db1a = merged_bwd(
            e, we, w1g, w1a, pre, gate, sender, env, scale, shift, meanw,
            ds1w.float().contiguous(), dm2w.float().contiguous(), deout,
            daggr, dst, src, emask, dst_rowptr, src_perm, src_rowptr,
            live=live)
        # in the primal order: xi, xj, e, we, b, w1g, b1g, w1a, b1a
        primal = (dxi, dxj, de, dwe, db, dw1g, db1g, dw1a, db1a)
        return tuple(g.to(dt) for g, dt in zip(primal, ctx.dtypes)) \
            + (dgamma, dbeta, denv) + (None,) * 9
