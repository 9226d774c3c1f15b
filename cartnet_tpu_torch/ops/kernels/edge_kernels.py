"""CartNet edge phase: CUDA kernel wrapper and its plain PyTorch version.

Port of the Pallas forward kernel cartnet_tpu/ops/pallas/edge_kernels.py
(``edge_phase_fwd`` -> ``_fwd_kernel``). Per edge, with f32 accumulation:

    pre    = xi[dst] + xj[src] + e @ We + b            # [E, 2d]
    h      = silu(pre), rounded to e.dtype
    gate   = h[:, :d] @ W1g + b1g                      # [E, d], xi.dtype
    sender = h[:, d:] @ W1a + b1a                      # [E, d], xi.dtype

Optional outputs (off on the inference path): the backward's saved residual
``[pre ‖ sigmoid(pre)]`` [E, 4d] in xi.dtype, and per-tile masked Welford
partials ``s1_w``/``M2_w`` [E/tile, d] (f32) of the rounded gate over
``tile``-edge windows; any tile size merges exactly in the training slice.

Node tables (xi, xj) come in bf16 or f32; e and the weights share the compute
dtype. Every edge is computed, pads included (pads point at real rows).
On a CUDA tensor ``edge_phase_fwd`` launches ``csrc/edge_phase_fwd.cu`` or
raises; on a CPU tensor it runs ``edge_phase_fwd_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from cartnet_tpu_torch.ops.kernels import _build

# the CUDA kernel's edge tile: E must be a multiple of it, and it is the
# window of the optional s1_w/M2_w partials
TILE_EDGES = 64
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0  # kernel launches (CUDA path only)


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
                         emask, *, saved: bool = False, moments: bool = False,
                         tile: int = TILE_EDGES):
    """The kernel's function in plain PyTorch (same casts and rounding).
    Returns (gate, sender, saved | None, s1_w | None, M2_w | None)."""
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
    res = torch.cat([pre.to(cdt), sig.to(cdt)], dim=1) if saved else None
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


def _smem_bytes(d: int, edge_bf16: bool) -> int:
    """Dynamic shared memory of one block (mirrors the CUDA source)."""
    t = TILE_EDGES
    if edge_bf16:  # WMMA path: bf16 e/h tiles, bf16 weight chunk, f32 acc
        a128 = lambda n: -(-n // 128) * 128
        return (a128(2 * t * (d + 8)) + a128(2 * t * (2 * d + 8))
                + a128(2 * 64 * 136) + a128(4 * t * 132) + 4 * 3 * t)
    # FMA path: f32 e/h tiles (rows padded by 4), weight chunk, ids/mask
    return 4 * (t * (d + 4) + t * (2 * d + 4) + 16 * 128 + 3 * t)


def _lib():
    lib = _build.load("edge_phase_fwd")
    fn = lib.edge_phase_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def edge_phase_fwd(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask, *,
                   saved: bool = False, moments: bool = False):
    """Fused gather + edge MLPs -> (gate, sender, saved | None,
    s1_w | None, M2_w | None); see the module docstring."""
    _check(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask)
    if e.device.type == "cpu":
        return edge_phase_fwd_plain(xi, xj, e, we, b, w1g, b1g, w1a, b1a,
                                    dst, src, emask, saved=saved,
                                    moments=moments)
    if e.device.type != "cuda":
        raise ValueError(f"unsupported device {e.device}")
    args = (xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("edge_phase_fwd needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (e, we, w1g, w1a)):
        raise ValueError("edge_phase_fwd needs 16-byte aligned e/weights")
    E, d = e.shape
    edge_bf16 = e.dtype == torch.bfloat16
    if E % TILE_EDGES or d % 128 or _smem_bytes(d, edge_bf16) > _SMEM_LIMIT:
        raise ValueError(f"edge_phase_fwd kernel needs E % {TILE_EDGES} == 0"
                         f" and d % 128 == 0 with d <= 256 (E={E}, d={d})")
    dev, cdt = e.device, xi.dtype
    gate = torch.empty((E, d), dtype=cdt, device=dev)
    sender = torch.empty((E, d), dtype=cdt, device=dev)
    res = torch.empty((E, 4 * d), dtype=cdt, device=dev) if saved else None
    nt = E // TILE_EDGES
    s1w = torch.empty((nt, d), dtype=torch.float32, device=dev) \
        if moments else None
    m2w = torch.empty_like(s1w) if moments else None
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib()(*(ptr(t) for t in args), ptr(gate), ptr(sender), ptr(res),
                 ptr(s1w), ptr(m2w), E, d, int(cdt == torch.bfloat16),
                 int(edge_bf16),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "edge_phase_fwd")
    global launches
    launches += 1
    return gate, sender, res, s1w, m2w
