"""The eComformer TP kernels (K7 forward, K8 backward) at the widths the
card now takes.

* K7's and K8's plain versions against the Pallas kernels in interpret
  mode at d = 384 (E = T_TP = 128), layer 1 and layer 2, f32 and bf16.
* The wrappers' zero-padding (``_pad``, K7 to a multiple of 16 and in
  bf16 to at least 64, K8 to a multiple of 128) at d in {32, 64, 96}: the
  plain versions on padded operands, cut back, equal the plain versions at
  the real width, and the padded columns of dh and dwt are zero.
* The Python mirrors of the kernels' shared-memory plans (K7's bf16 block
  of warpgroup tiles and wt ring, and its f32 K loop; K8's passes) fit a
  Hopper block at every width and dtype the kernels take, K7's bf16 plan
  as tp_contract_fwd.cu's constants lay it out; ``chip_smoke.py`` holds
  them to the CUDA plans.

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
    dp = k7.padded_width(d, dt == "bf16")
    assert dp == (max(_pad.round_up(d, k7.GRANULE), k7.TC_MIN_WIDTH)
                  if dt == "bf16" else _pad.round_up(d, k7.GRANULE))
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
        dp = k7.padded_width(d, bf16)
        assert 0 < k7.fwd_smem_bytes(dp, bf16, l2) <= SMEM_LIMIT, d
        if bf16:  # three warpgroups while their ring keeps its stages
            plan = k7.fwd_smem_plan(dp, l2)
            assert plan["stages"] >= (k7.TC_MIN_STAGES
                                      if plan["wgs"] == k7.TC_WGS else 2), d
    # the wide bf16 block gives way in warpgroups (two past d = 256), then
    # in ring stages (d = 512: half a chunk group); the f32 one keeps its
    # SIMT tile at every width (d only lengthens its k loop)
    assert (k7.fwd_smem_plan(256, l2)["wgs"],
            k7.fwd_smem_plan(256, l2)["stages"]) == (3, 5)
    assert (k7.fwd_smem_plan(384, l2)["wgs"],
            k7.fwd_smem_plan(512, l2)["wgs"]) == (2, 2)
    assert k7.fwd_smem_plan(512, l2)["stages"] == 4
    assert k7.fwd_smem_bytes(512, False, l2) == k7.fwd_smem_bytes(
        16, False, l2)


def _source_constant(name: str) -> str:
    """``constexpr <type> name = value;`` of tp_contract_fwd.cu."""
    import re
    from cartnet_tpu_torch.ops.kernels import _build
    text = (_build.CSRC / "tp_contract_fwd.cu").read_text()
    m = re.search(rf"constexpr \w+(?: \w+)? {name} = ([^;]+);", text)
    return m.group(1)


@pytest.mark.parametrize("a_dt", ["f32", "bf16"])
@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
def test_k7_bf16_plan_is_the_source_layout(l2, a_dt):
    """``fwd_smem_plan`` against a plan laid out from tp_contract_fwd.cu's
    own constants (warpgroups, chunks a wgmma, ring depth, the block's
    limit, the a table's width), at every width the wrapper
    runs (16..48 padded to 64). The a table is bf16 for f32 and bf16 a
    alike (``stage_a`` rounds into it), so both plans are one."""
    from cartnet_tpu_torch.ops.kernels import _build
    text = (_build.CSRC / "tp_contract_fwd.cu").read_text()
    most = int(_source_constant("TC_WGS"))
    min_stages = int(_source_constant("TC_MIN_STAGES"))
    nb = int(_source_constant("TC_NB"))
    max_stages = int(_source_constant("TC_MAX_STAGES"))
    limit = int(_source_constant("SMEM_LIMIT"))
    assert (most, min_stages, nb, max_stages) == (
        k7.TC_WGS, k7.TC_MIN_STAGES, k7.TC_NB, k7.TC_MAX_STAGES)
    assert limit == SMEM_LIMIT
    assert "a_s[r * AS + c] = __float2bfloat16_rn(v);" in text
    assert "return a_width(l2) + 2;" in text
    assert "return most.ok() && most.stages >= TC_MIN_STAGES ? most" in text

    def layout(dp, wgs):
        ks = -(-dp // 64)
        head = wgs * ks * 8192 + wgs * 64 * ((80 if l2 else 64) + 2) * 2 \
            + 5120 * 2
        ring = -(-head // 1024) * 1024
        stages = min(max_stages, (limit - 1024 - ring - 16 * max_stages
                                  - 16 * wgs) // (nb * 8192))
        total = 1024 + ring + stages * nb * 8192 + 16 * stages + 16 * wgs
        return ks, stages, total

    for d in WIDTHS:
        dp = k7.padded_width(d, True)
        wgs = most
        ks, stages, total = layout(dp, wgs)
        if not (stages >= min_stages and total <= limit):
            wgs = 2
            ks, stages, total = layout(dp, wgs)
        assert stages >= 2 and total <= limit, d
        plan = k7.fwd_smem_plan(dp, l2)
        assert plan["wgs"] == wgs, d
        assert (plan["total"], plan["stages"], plan["slabs"]) == (
            total, stages, ks), d


@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_k8_plans_fit_a_hopper_block(d, l2):
    plan = k7.bwd_smem_plan(d, l2)
    for key in ("tile", "weights", "tile_f32", "weights_f32"):
        assert plan[key] <= SMEM_LIMIT, (key, plan[key])
    # the chunks of d/64 wt slabs the tile pass holds at once fit the ring
    assert plan["stages"] >= plan["chunks"] * (d // 64)
