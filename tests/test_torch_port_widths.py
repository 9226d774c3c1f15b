"""The CartNet edge kernels beyond d = 256: K1 (edge_phase_fwd), K5
(edge_phase_bwd) and K6 (the merged backward) at d = 384, and the
shared-memory plans of the CUDA kernels at d in {128, 256, 384, 512}.

The plain versions (what the wrappers run on a CPU tensor, and what
chip_smoke.py holds the CUDA kernels to on the card) against the Pallas
kernels in interpret mode: K1 against ``edge_phase_fwd``, K5 against the
VJP of ``edge_phase``, K6 against ``_merged_bwd_call``. One RCM-reordered
synthetic crystal padded to E = 512 edges, the smallest batch the Pallas
kernels take (they walk 512-edge windows), at the JAX package's window so
that both sides fold the same window cotangents. Inputs and cotangents come
from numpy with a seed; cotangents are zero on pad-edge rows.

Tolerances, as max |ours - ref| / max |ref| per output, those of
test_torch_port_train_kernels.py: f32 elementwise 1e-5; f32 sums over
edges (weight, bias and node gradients, the moments) 1e-4; 2e-2 where bf16
rounding is involved.

The shared-memory plans mirror csrc/edge_phase_fwd.cu (``TcLayout``, the
f32 passes' SIMT tile) and csrc/edge_phase_bwd.cu (``TileLayout``, ``Layout1``, the
weight passes) in ``edge_kernels``; every width and dtype the kernels take
must fit a Hopper block's 232,448 bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cartnet_tpu.ops.pallas.edge_kernels as jek
from cartnet_tpu.data.batching import bandwidth_reorder as jreorder
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.data.synthetic import synthetic_dataset as jsynthetic
from cartnet_tpu.ops.pallas.edge_kernels import T_EDGES
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.ops.kernels import edge_kernels as ek

D = 384
TOL = {"f32": 1e-5, "sum": 1e-4, "bf16": 2e-2}
SMEM_LIMIT = 232448
PRIMALS = ("xi", "xj", "e", "we", "b", "w1g", "b1g", "w1a", "b1a")
GRADS = ("de", "dxi", "dxj", "dwe", "db", "dw1g", "db1g", "dw1a", "db1a")


def _jdt(case):
    return jnp.bfloat16 if case == "bf16" else jnp.float32


def _tdt(case):
    return torch.bfloat16 if case == "bf16" else torch.float32


def _pair(a, dt):
    """The same values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, dt)
    t = torch.tensor(np.asarray(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dt == jnp.bfloat16 else torch.float32)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(ours, ref):
    a, b = _np(ours), _np(ref).reshape(_np(ours).shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tol(case, name):
    if case == "bf16":
        return TOL["bf16"]
    return TOL["f32"] if name in ("gate", "sender", "saved", "pre", "de") \
        else TOL["sum"]


@pytest.fixture(scope="module")
def data():
    """One crystal collated by both packages into one 512-edge window (the
    JAX one carries the Pallas window plans) and random operands at d = 384
    and its shapes."""
    recs = [jreorder(r) for r in
            jsynthetic(1, mean_atoms=12, radius=5.0, adp=True, seed=7)]
    n, e = 128, T_EDGES
    assert sum(len(r["edge_src"]) for r in recs) <= e
    jb = jcollate(recs, n, e, 1, edge_align=T_EDGES)
    assert jb.edge_fuse_ok
    tb = collate(recs, n, e, 1, edge_align=T_EDGES).to("cpu")
    assert np.array_equal(tb.edge_dst.numpy(), jb.edge_dst)
    rng = np.random.default_rng(23)
    nt = e // T_EDGES
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    m = jb.edge_mask[:, None]
    s = 1.0 / np.sqrt(D)
    vals = dict(xi=mk(n, 2 * D), xj=mk(n, 2 * D), e=mk(e, D),
                we=mk(D, 2 * D) * 3 * s, b=mk(2 * D), w1g=mk(D, D) * 3 * s,
                b1g=mk(D), w1a=mk(D, D) * 3 * s, b1a=mk(D),
                env=rng.uniform(0.2, 1.0, (e, 1)).astype(np.float32),
                scale=(1.0 + 0.1 * rng.normal(size=D)).astype(np.float32),
                shift=mk(D), ds1w=mk(nt, D) * 0.01, dm2w=mk(nt, D) * 0.01,
                dgate=mk(e, D) * m, dsender=mk(e, D) * m,
                deres=mk(e, D) * m, deout=mk(e, D) * m, daggr=mk(n, D))
    return jb, tb, vals


def _jidx(jb):
    return (jnp.asarray(jb.edge_dst), jnp.asarray(jb.edge_src),
            jnp.asarray(jb.edge_mask), jnp.asarray(jb.edge_dst_lo),
            jnp.asarray(jb.edge_src_lo), jnp.asarray(jb.edge_src_nblk))


def _tidx(tb):
    return tb.edge_dst, tb.edge_src, tb.edge_mask


def _forward(tb, tin, pre_only):
    """The plain forward at the JAX window: gate, sender, the residual and
    mean_w."""
    dst, src, emask = _tidx(tb)
    gate, sender, res, s1w, _ = ek.edge_phase_fwd_plain(
        *tin, dst, src, emask, saved=True, pre_only=pre_only, moments=True,
        tile=T_EDGES)
    n_w = emask.reshape(-1, T_EDGES).sum(dim=1, dtype=torch.float32)[:, None]
    return gate, sender, res, s1w / torch.clamp(n_w, min=1.0)


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_k1_plain_matches_pallas_at_384(data, case):
    jb, tb, v = data
    p = {k: _pair(v[k], _jdt(case)) for k in PRIMALS}
    ref = jek.edge_phase_fwd(*(p[k][0] for k in PRIMALS), *_jidx(jb),
                             c_src=jb.src_band, interpret=True, saved=True)
    ours = ek.edge_phase_fwd_plain(*(p[k][1] for k in PRIMALS),
                                   *_tidx(tb), saved=True, moments=True,
                                   tile=T_EDGES)
    m = jb.edge_mask
    for name, a, r in zip(("gate", "sender", "saved"), ours[:3], ref[:3]):
        assert a.dtype == _tdt(case) and a.shape == tuple(r.shape), name
        assert _rel(_np(a)[m], _np(r)[m]) <= _tol(case, name), name
    # per-window moments cover masked rows only, so they agree everywhere
    for name, a, r in zip(("s1_w", "M2_w"), ours[3:], ref[3:]):
        assert a.dtype == torch.float32
        assert _rel(a, r) <= _tol(case, name), (name, _rel(a, r))


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_k5_plain_matches_pallas_vjp_at_384(data, case):
    jb, tb, v = data
    jdt = _jdt(case)
    p = {k: _pair(v[k], jdt) for k in PRIMALS + ("dgate", "dsender",
                                                  "deres")}
    f = lambda *prim: jek.edge_phase(*prim, *_jidx(jb)[:3],
                                     *_jidx(jb)[3:], jb.src_band, True)
    _, vjp = jax.vjp(f, *(p[k][0] for k in PRIMALS))
    ref = vjp((p["dgate"][0], p["dsender"][0], p["deres"][0],
               jnp.asarray(v["ds1w"]), jnp.asarray(v["dm2w"])))
    tin = [p[k][1] for k in PRIMALS]
    gate, _, saved, meanw = _forward(tb, tin, pre_only=False)
    dst, src, emask = _tidx(tb)
    ours = ek.edge_phase_bwd_plain(
        tin[2], tin[3], tin[5], tin[7], saved, gate, meanw,
        torch.tensor(v["ds1w"]), torch.tensor(v["dm2w"]), p["dgate"][1],
        p["dsender"][1], p["deres"][1], dst, src, emask, tb.num_nodes,
        tile=T_EDGES)
    got = dict(zip(GRADS, ours))
    assert got["de"].dtype == _tdt(case)
    # the VJP's primal order: xi, xj, e, we, b, w1g, b1g, w1a, b1a
    for name, r in zip(("dxi", "dxj", "de", "dwe", "db", "dw1g", "db1g",
                        "dw1a", "db1a"), ref[:9]):
        a = got[name]
        if name == "de":  # pad rows: Pallas gathers zeros out of its band
            a, r = _np(a)[jb.edge_mask], _np(r)[jb.edge_mask]
        else:
            assert a.dtype == torch.float32, name
        assert _rel(a, r) <= _tol(case, name), (name, _rel(a, r))


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_k6_plain_matches_pallas_at_384(data, case):
    jb, tb, v = data
    jdt = _jdt(case)
    p = {k: _pair(v[k], jdt) for k in PRIMALS + ("env", "deout", "daggr")}
    tin = [p[k][1] for k in PRIMALS]
    gate, sender, pre, meanw = _forward(tb, tin, pre_only=True)
    dst, src, emask = _tidx(tb)
    f32 = lambda k: torch.tensor(v[k])
    ours = ek.merged_bwd_plain(
        tin[2], tin[3], tin[5], tin[7], pre, gate, sender, p["env"][1],
        f32("scale"), f32("shift"), meanw, f32("ds1w"), f32("dm2w"),
        p["deout"][1], p["daggr"][1], dst, src, emask, tile=T_EDGES)
    j = lambda t: jnp.asarray(_np(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    ref = jek._merged_bwd_call(
        *(p[k][0] for k in PRIMALS), *_jidx(jb), j(pre), j(gate), j(sender),
        p["env"][0], jnp.asarray(v["scale"]), jnp.asarray(v["shift"]),
        j(meanw), jnp.asarray(v["ds1w"]), jnp.asarray(v["dm2w"]),
        p["deout"][0], p["daggr"][0], jb.src_band, True)
    assert ours[0].dtype == _tdt(case)
    assert all(g.dtype == torch.float32 for g in ours[1:])
    for name, a, r in zip(GRADS, ours, ref):
        assert _rel(a, r) <= _tol(case, name), (name, _rel(a, r))


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_smem_plans_fit_a_hopper_block(d, bf16):
    assert ek._smem_bytes(d, bf16) <= SMEM_LIMIT  # K1
    plan = ek.bwd_smem_plan(d, bf16)  # K5 / K6
    assert plan["tile"] <= SMEM_LIMIT and plan["weights"] <= SMEM_LIMIT
    if bf16:  # the tile pass keeps a TMA ring of at least 3 stages
        assert plan["stages"] >= 3
    assert d <= ek.MAX_WIDTH


def test_smem_plans_stop_at_the_stated_width():
    """Past MAX_WIDTH the bf16 backward's tiles leave no room for a ring:
    the wrapper's limit is the plan's."""
    assert ek.bwd_smem_plan(ek.MAX_WIDTH + 128, True)["stages"] < 3
