"""The eComformer TP kernels (K7 forward, K8 backward) at the widths the
card now takes.

* K7's and K8's plain versions against the Pallas kernels in interpret
  mode at d = 384 (E = T_TP = 128), layer 1 and layer 2, f32 and bf16.
* The wrappers' zero-padding (``_pad``, K7 to a multiple of 16, K8 to a
  multiple of 128) at d in {32, 64, 96}: the plain versions on padded
  operands, cut back, equal the plain versions at the real width, and the
  padded columns of dh and dwt are zero.
* The Python mirrors of the kernels' shared-memory plans (K7's warp choice
  and its f32 K loop, K8's passes) fit a Hopper block at every width and
  dtype the kernels take; ``chip_smoke.py`` holds them to the CUDA plans.

Tolerances, as max |ours - ref| / max |ref| per output: f32 1e-5, and 1e-4
for f32 sums over edges or over 5120 columns (dh, dW, db); 1e-2 where bf16
rounds (one bf16 step is 2^-8 of the value rounded).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu.ops.pallas import tp_kernels as jtp
from cartnet_tpu_torch.ops.kernels import _pad
from cartnet_tpu_torch.ops.kernels import tp_kernels as k7

E, D = jtp.T_TP, 384
TOL = {"f32": 1e-5, "sum": 1e-4, "bf16": 1e-2}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
SUMS = ("dh", "dW", "db")
SMEM_LIMIT = 232448


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(ours, ref):
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _vals(d, seed=5, n=E):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(h=np.log1p(np.exp(mk(n, d))), a0=mk(n, 64), a1=mk(n, 8),
                a2=mk(n, 8), W=mk(d, 5120) / np.sqrt(d), b=mk(5120) * 0.05,
                dc0=mk(n, 64), dc1=mk(n, 8), dc2=mk(n, 8))


def _inputs(vals, dt):
    """(JAX arrays in dt, port tensors in dt: wt [5120, d])."""
    j = {k: jnp.asarray(v, JDT[dt]) for k, v in vals.items()}
    t = {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(TDT[dt])
         for k, v in j.items()}
    t["W"] = t["W"].t().contiguous()
    return j, t


@pytest.fixture(scope="module")
def vals384():
    return _vals(D)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
def test_tp_fwd_plain_matches_pallas_at_384(vals384, l2, dt):
    j, t = _inputs(vals384, dt)
    if l2:
        ref = [jtp.tp_contract_l2(j["h"], j["a0"], j["a1"], j["a2"], j["W"],
                                  j["b"], True)]
        ours = [k7.tp_contract_l2(t["h"], t["a0"], t["a1"], t["a2"], t["W"],
                                  t["b"])]
    else:
        ref = jtp.tp_contract_l1(j["h"], j["a0"], j["W"], j["b"], True)
        ours = k7.tp_contract_l1(t["h"], t["a0"], t["W"], t["b"])
    for o, r in zip(ours, ref):
        assert str(o.dtype).split(".")[-1] == str(r.dtype)
        # f32: each output sums 64 products of 384-deep dot products
        assert _err(o, r) <= TOL["bf16" if dt == "bf16" else "sum"], \
            _err(o, r)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
def test_tp_bwd_plain_matches_pallas_at_384(vals384, l2, dt):
    j, t = _inputs(vals384, dt)
    paths = jtp.PATHS_L2 if l2 else jtp.PATHS_L1
    a_names = ["a0", "a1", "a2"] if l2 else ["a0"]
    dc_names = ["dc0"] if l2 else ["dc0", "dc1", "dc2"]
    outs = jtp._bwd_call(paths, len(a_names), l2, j["h"],
                         [j[k] for k in a_names], j["W"], j["b"],
                         [j[k] for k in dc_names], True)
    want = dict(dh=outs[0], **{f"d{k}": v for k, v in
                               zip(a_names, outs[1:-2])},
                dW=outs[-2], db=outs[-1][0])
    dh, das, dwt, db = k7.tp_contract_bwd(
        k7.PATHS_L2 if l2 else k7.PATHS_L1, t["h"], [t[k] for k in a_names],
        t["W"], t["b"], [t[k] for k in dc_names])
    got = dict(dh=dh, **{f"d{k}": v for k, v in zip(a_names, das)},
               dW=dwt.t(), db=db)
    for name in want:
        tol = TOL["bf16"] if dt == "bf16" else TOL[
            "sum" if name in SUMS else "f32"]
        assert _err(got[name], want[name]) <= tol, (name, _err(got[name],
                                                                want[name]))


# ------------------------------------------------------------ padding

H = (False, 1)  # h [E, d] and wt [5120, d]: d is the last axis


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 96])
def test_k7_padding_is_exact(d, dt):
    _, t = _inputs(_vals(d, seed=d), dt)
    dp = _pad.round_up(d, k7.GRANULE)
    h, wt = _pad.pad(t["h"], H, d, dp), _pad.pad(t["W"], H, d, dp)
    assert h.shape == (E, dp) and not h[:, d:].any() and not wt[:, d:].any()
    for l2 in (False, True):
        paths = k7.PATHS_L2 if l2 else k7.PATHS_L1
        a = [t["a0"], t["a1"], t["a2"]] if l2 else [t["a0"]]
        want = k7.tp_contract_plain(paths, t["h"], a, t["W"], t["b"])
        got = k7.tp_contract_plain(paths, h, a, wt, t["b"])
        for g, w in zip(got if not l2 else [got], want if not l2 else [want]):
            assert g.dtype == w.dtype
            assert _err(g, w) <= TOL["bf16" if dt == "bf16" else "sum"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 96])
def test_k8_padding_is_exact(d, dt):
    _, t = _inputs(_vals(d, seed=d + 1), dt)
    dp = _pad.round_up(d, k7.BWD_GRANULE)
    assert dp == 128
    h, wt = _pad.pad(t["h"], H, d, dp), _pad.pad(t["W"], H, d, dp)
    for l2 in (False, True):
        paths = k7.PATHS_L2 if l2 else k7.PATHS_L1
        a = [t["a0"], t["a1"], t["a2"]] if l2 else [t["a0"]]
        dc = [t["dc0"]] if l2 else [t["dc0"], t["dc1"], t["dc2"]]
        want = k7.tp_contract_bwd_plain(paths, t["h"], a, t["W"], t["b"], dc)
        dh, das, dwt, db = k7.tp_contract_bwd_plain(paths, h, a, wt, t["b"],
                                                    dc)
        # the padded columns of dh and dwt are zero (wt's and h's are)
        assert not dh[:, d:].any() and not dwt[:, d:].any()
        got = (_pad.cut(dh, H, d, dp), das, _pad.cut(dwt, H, d, dp), db)
        tol = lambda name: TOL["bf16"] if dt == "bf16" else TOL[
            "sum" if name in SUMS else "f32"]
        assert _err(got[0], want[0]) <= tol("dh")
        for g, w in zip(got[1], want[1]):
            assert g.dtype == w.dtype and _err(g, w) <= tol("da")
        assert _err(got[2], want[2]) <= tol("dW")
        assert _err(got[3], want[3]) <= tol("db")


# --------------------------------------------------- shared-memory plans

WIDTHS = [16 * k for k in range(1, 33)]  # K7's granule up to 512


@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_k7_plans_fit_a_hopper_block(bf16, l2):
    for d in WIDTHS:
        if bf16:  # the main path's E on 132 SMs
            warps = k7.fwd_warps(20992, d, l2, 132)
            assert 1 <= warps <= k7.WARPS[1], d
            assert k7.fwd_smem_bytes(d, True, l2, warps) <= SMEM_LIMIT, d
        else:
            assert k7.fwd_smem_bytes(d, False, l2, 0) <= SMEM_LIMIT, d
    # the wide bf16 block gives way in warps; the f32 one keeps its SIMT
    # tile at every width (d only lengthens its k loop)
    assert k7.fwd_warps(20992, 512, l2, 132) == 5
    assert k7.fwd_warps(20992, 256, l2, 132) == 10
    assert k7.fwd_smem_bytes(512, False, l2, 0) == k7.fwd_smem_bytes(
        16, False, l2, 0)


@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_k8_plans_fit_a_hopper_block(d, l2):
    plan = k7.bwd_smem_plan(d, l2)
    for key in ("tile", "weights", "tile_f32", "weights_f32"):
        assert plan[key] <= SMEM_LIMIT, (key, plan[key])
    # the chunks of d/64 wt slabs the tile pass holds at once fit the ring
    assert plan["stages"] >= plan["chunks"] * (d // 64)
