"""Zero-padding of the feature width up to a kernel's granule.

A kernel whose tiling wants the width d to be a multiple of some granule g
runs on operands padded to dp = round_up(d, g) with zeros, and its outputs
are cut back to d. A spec says how one tensor's width enters its shape:

    None           no feature axis (indices, masks, a per-edge scalar)
    (False, k)     the last axis holds k blocks of width d ([E, k d])
    (True, k)      also the first axis is d (a weight [d, k d])

Each block is padded at its own end, so block j of the padded tensor starts
at column j dp. Why the padding is exact is the caller's to say (each
wrapper's docstring does): in short, padded weight rows and columns, biases,
activations and cotangents are zero, so no pad term enters a sum over a
real column, and padded outputs are cut away.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Spec = Optional[Tuple[bool, int]]


def round_up(d: int, g: int) -> int:
    return -(-d // g) * g


def pad(t: Optional[torch.Tensor], spec: Spec, d: int,
        dp: int) -> Optional[torch.Tensor]:
    """``t`` with each width-d block (and, for a weight, the first axis)
    zero-padded to dp; ``t`` itself when nothing changes."""
    if t is None or spec is None or d == dp:
        return t
    rows, k = spec
    lead = t.shape[1:-1] if rows else t.shape[:-1]
    out = t.new_zeros(((dp,) if rows else ()) + tuple(lead) + (k, dp))
    src = t.reshape(tuple(t.shape[:-1]) + (k, d))
    if rows:
        out[:d, ..., :d] = src
    else:
        out[..., :d] = src
    return out.reshape(out.shape[:-2] + (k * dp,))


def cut(t: Optional[torch.Tensor], spec: Spec, d: int,
        dp: int) -> Optional[torch.Tensor]:
    """The inverse of ``pad``: the real rows and columns, contiguous."""
    if t is None or spec is None or d == dp:
        return t
    rows, k = spec
    v = t.reshape(tuple(t.shape[:-1]) + (k, dp))[..., :d]
    if rows:
        v = v[:d]
    return v.reshape(v.shape[:-2] + (k * d,)).contiguous()


def pad_named(ts: dict, specs: dict, d: int, dp: int) -> dict:
    """``pad`` of each named tensor of ``ts`` by its spec in ``specs``,
    keeping the order of ``ts``; a name without a spec raises KeyError."""
    return {k: pad(t, specs[k], d, dp) for k, t in ts.items()}


def cut_named(ts: dict, specs: dict, d: int, dp: int) -> dict:
    """``cut`` of each named tensor of ``ts`` by its spec in ``specs``."""
    return {k: cut(t, specs[k], d, dp) for k, t in ts.items()}
