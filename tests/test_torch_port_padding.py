"""Widths below the CartNet edge kernels' granule, and the build's
staleness rule.

* K1, K5 and K6 run at the next multiple of 128 (``edge_kernels.GRANULE``)
  on operands zero-padded by the wrappers' specs (``FWD_PAD``, ``BWD_PAD``,
  ``MERGED_PAD``; ``_pad``). At d in {32, 64, 96}, in f32 and bf16: the
  plain versions on padded operands, cut back by the output specs, equal
  the plain versions at the real width, and the padded output columns hold
  what the design says (0 for gate, sender, pre, the moments and every
  gradient; sigmoid(0) = 0.5 for the saved sig, which is cut away).
* K1's shared-memory plan mirror fits a Hopper block at every width the
  kernel runs (``chip_smoke.py`` holds it to the CUDA plan).
* ``_build._stale``: a library is rebuilt when its source or any shared
  header ``csrc/*.cuh`` is newer; K1, K5/K6 and K8 include the one header.

Tolerances, as max |padded - native| / max |native| per output: f32 1e-5,
1e-4 for f32 sums over edges or nodes (the node and weight gradients);
1e-2 where bf16 rounds. Padding adds only exact zero terms, so the
differences are those of another summation blocking on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from cartnet_tpu_torch.ops.kernels import _build, _pad
from cartnet_tpu_torch.ops.kernels import edge_kernels as ek

E, N = 256, 40
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 1e-5, "sum": 1e-4, "bf16": 1e-2}
SUMS = ("dxi", "dxj", "dwe", "db", "dw1g", "db1g", "dw1a", "db1a", "s1_w",
        "M2_w")
FWD_IN = ("xi", "xj", "e", "we", "b", "w1g", "b1g", "w1a", "b1a")
FWD_OUT = ("gate", "sender", "saved", "s1_w", "M2_w")
BWD_OUT = ("de", "dxi", "dxj", "dwe", "db", "dw1g", "db1g", "dw1a", "db1a")
SMEM_LIMIT = 232448


def _err(a, b):
    a, b = a.float(), b.float()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _tol(dt, name):
    return TOL["bf16"] if dt == "bf16" else TOL["sum" if name in SUMS
                                                 else "f32"]


def _fwd_args(d, dt, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.tensor(
        rng.normal(size=s).astype(np.float32) * sc).to(TDT[dt])
    u = lambda fan, *s: torch.tensor(
        (rng.uniform(-1, 1, size=s) / np.sqrt(fan)).astype(np.float32)
    ).to(TDT[dt])
    args = (t(N, 2 * d, sc=0.3), t(N, 2 * d, sc=0.3), t(E, d, sc=0.3),
            u(3 * d, d, 2 * d), u(3 * d, 2 * d), u(d, d, d), u(d, d),
            u(d, d, d), u(d, d))
    dst = torch.tensor(np.sort(rng.integers(0, N, E)), dtype=torch.int32)
    src = torch.tensor(rng.integers(0, N, E), dtype=torch.int32)
    emask = torch.tensor(rng.random(E) < 0.85)
    return args, (dst, src, emask), rng


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 96])
@pytest.mark.parametrize("pre_only", [False, True], ids=["pre_sig", "pre"])
def test_k1_padding_is_exact(d, dt, pre_only):
    args, idx, _ = _fwd_args(d, dt, d)
    dp = ek.padded_width(d)
    assert dp == ek.GRANULE
    padded = _pad.pad_named(dict(zip(FWD_IN, args)), ek.FWD_PAD, d, dp)
    kw = dict(saved=True, pre_only=pre_only, moments=True)
    want = ek.edge_phase_fwd_plain(*args, *idx, **kw)
    got = ek.edge_phase_fwd_plain(*padded.values(), *idx, **kw)
    gate, sender, saved, s1w, m2w = got
    for name, t in (("gate", gate), ("sender", sender), ("s1_w", s1w),
                    ("M2_w", m2w)):
        assert not t[:, d:].any(), name
    blocks = saved.reshape(E, 2 if pre_only else 4, dp)
    assert not blocks[:, :2, d:].any()  # pre = 0 on the padded columns
    if not pre_only:  # sig = sigmoid(0)
        assert bool((blocks[:, 2:, d:].float() == 0.5).all())
    specs = ek.FWD_OUT_PAD_PRE if pre_only else ek.FWD_OUT_PAD
    cut = _pad.cut_named(dict(zip(FWD_OUT, got)), specs, d, dp)
    for (name, g), w in zip(cut.items(), want):
        assert g.dtype == w.dtype and _err(g, w) <= _tol(dt, name), name


def _bwd_operands(d, dt, merged):
    """K5's (or K6's) operands before the index tensors, by the plain
    version's parameter names, from a K1 plain run and random cotangents
    zero on pad rows, plus the plain version's index arguments."""
    args, (dst, src, emask), rng = _fwd_args(d, dt, 100 + d)
    gate, sender, saved, s1w, _ = ek.edge_phase_fwd_plain(
        *args, dst, src, emask, saved=True, pre_only=merged, moments=True)
    nt = E // ek.TILE_EDGES
    n_w = emask.reshape(nt, -1).sum(dim=1, dtype=torch.float32)[:, None]
    f = lambda *s, sc=1.0: torch.tensor(
        rng.normal(size=s).astype(np.float32) * sc)
    cot = lambda: (f(E, d) * emask[:, None]).to(TDT[dt])
    win = (s1w / torch.clamp(n_w, min=1.0), 0.01 * f(nt, d),
           0.01 * f(nt, d))
    e, we, w1g, w1a = args[2], args[3], args[5], args[7]
    if merged:
        env = torch.tensor(rng.random((E, 1)).astype(np.float32)).to(TDT[dt])
        ops = dict(e=e, we=we, w1g=w1g, w1a=w1a, pre=saved, gate=gate,
                   sender=sender, env=env, scale=1.0 + 0.1 * f(d),
                   shift=0.5 * f(d), meanw=win[0], ds1w=win[1], dm2w=win[2],
                   deout=cot(), daggr=f(N, d).to(TDT[dt]))
        return ops, dict(dst=dst, src=src, emask=emask)
    ops = dict(e=e, we=we, w1g=w1g, w1a=w1a, saved=saved, gate=gate,
               meanw=win[0], ds1w=win[1], dm2w=win[2], dgate=cot(),
               dsender=cot(), deres=cot())
    return ops, dict(dst=dst, src=src, emask=emask, num_nodes=N)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 96])
@pytest.mark.parametrize("merged", [False, True], ids=["k5", "k6"])
def test_k5_k6_padding_is_exact(d, dt, merged):
    ops, idx = _bwd_operands(d, dt, merged)
    dp = ek.padded_width(d)
    specs = ek.MERGED_PAD if merged else ek.BWD_PAD
    padded = _pad.pad_named(ops, specs, d, dp)
    plain = ek.merged_bwd_plain if merged else ek.edge_phase_bwd_plain
    want = plain(**ops, **idx)
    got = plain(**padded, **idx)
    de, dxi, dxj, dwe, db, dw1g, db1g, dw1a, db1a = got
    assert not de[:, d:].any()
    for t in (dxi, dxj, db):  # two blocks of width dp
        assert not t.reshape(*t.shape[:-1], 2, dp)[..., d:].any()
    assert not dwe[d:].any()
    assert not dwe.reshape(dp, 2, dp)[..., d:].any()
    for t in (dw1g, dw1a):
        assert not t[d:].any() and not t[:, d:].any()
    assert not db1g[d:].any() and not db1a[d:].any()
    cut = _pad.cut_named(dict(zip(BWD_OUT, got)), ek.BWD_OUT_PAD, d, dp)
    for (name, g), w in zip(cut.items(), want):
        assert g.dtype == w.dtype and _err(g, w) <= _tol(dt, name), name


@pytest.mark.parametrize("wrapper, specs", [
    ("edge_phase_fwd", "FWD_PAD"), ("edge_phase_bwd", "BWD_PAD"),
    ("merged_bwd", "MERGED_PAD")])
def test_pad_specs_name_every_operand(wrapper, specs):
    """Each wrapper's pad specs are keyed by its parameter names and cover
    every tensor operand, so an operand added or moved without a spec
    raises instead of padding the wrong axis."""
    import inspect
    params = [n for n, p in inspect.signature(
        getattr(ek, wrapper)).parameters.items()
        if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert sorted(params) == sorted(getattr(ek, specs)), wrapper
    with pytest.raises(KeyError):
        _pad.pad_named({"not_an_operand": torch.zeros(2, 32)},
                       getattr(ek, specs), 32, 128)


def test_padded_width_bounds():
    assert [ek.padded_width(d) for d in (1, 32, 128, 129, 384, 512)] == \
        [128, 128, 128, 256, 384, 512]
    for d in (0, ek.MAX_WIDTH + 1):
        with pytest.raises(ValueError):
            ek.padded_width(d)


@pytest.mark.parametrize("edge_bf16", [True, False], ids=["bf16", "f32"])
def test_k1_plan_fits_a_hopper_block(edge_bf16):
    for d in range(ek.GRANULE, ek.MAX_WIDTH + 1, ek.GRANULE):
        plan = ek.fwd_smem_plan(d, edge_bf16)
        assert plan["total"] <= SMEM_LIMIT, (d, plan)
        if edge_bf16:  # the weight ring keeps several slabs in flight
            assert plan["stages"] >= 8, (d, plan)


# ------------------------------------------------------------- build rule

def test_stale_sees_sources_and_shared_headers(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    src, hdr, lib = csrc / "k.cu", csrc / "common.cuh", build / "libk.so"
    src.write_text("// k")
    hdr.write_text("// shared")
    assert _build._stale("k")  # no library yet
    lib.write_text("built")
    stamp = lambda p, t: os.utime(p, (t, t))
    stamp(src, 1000)
    stamp(hdr, 1000)
    stamp(lib, 2000)
    assert not _build._stale("k")
    stamp(hdr, 3000)  # the shared header changed
    assert _build._stale("k")
    stamp(lib, 4000)
    stamp(src, 5000)  # the source changed
    assert _build._stale("k")


def test_wgmma_kernels_share_one_hopper_header():
    for name in ("edge_phase_fwd", "edge_phase_bwd", "tp_contract_fwd",
                 "tp_contract_bwd"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper_common.cuh"' in text, name
        assert "mbarrier.init" not in text, name  # not a copy of the helpers
    assert (_build.CSRC / "hopper_common.cuh").exists()


def test_wrappers_bind_their_libraries():
    """Every wrapper's ctypes binder exists (the CPU path never calls
    them, so a missing one would show first on the card)."""
    from cartnet_tpu_torch.ops.kernels import segment_kernels as sk
    from cartnet_tpu_torch.ops.kernels import segsum_kernels as k3
    from cartnet_tpu_torch.ops.kernels import tp_kernels as k7
    for mod, names in ((ek, ("_lib", "_lib_bwd")), (sk, ("_lib", "_lib_bwd")),
                       (k3, ("_lib",)), (k7, ("_lib", "_lib_bwd"))):
        for name in names:
            assert callable(getattr(mod, name, None)), (mod.__name__, name)
