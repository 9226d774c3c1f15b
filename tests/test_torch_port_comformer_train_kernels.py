"""The eComformer training kernels' plain versions vs the JAX package, and
the autograd Functions that run them.

K8 = tp_kernels._tp_bwd_kernel (plain: tp_contract_bwd_plain) for layer 1
and layer 2 at E = 256, d = 128, in f32 and bf16, against the Pallas
``_bwd_call`` in interpret mode and against ``jax.vjp`` of
``tp_contract_l1`` / ``tp_contract_l2`` in interpret mode. The
``TPContractL1`` / ``TPContractL2`` Functions against autograd through
``tp_contract_plain``. K3 as the sorted gather's backward (``gather_sorted``)
against ``gather_sorted_vjp``'s VJP, and ``segment_sum_presorted``'s backward
against ``_ssp_bwd``.

Tolerances, as max |ours - ref| / max |ref| per output: f32 1e-5, and 1e-4
for the f32 sums over edges (dW, db) and over the 5120 columns (dh); 1e-2
where bf16 rounds (one bf16 step is 2^-8 of the value rounded, and another
f32 summation order may round to the neighbouring value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu.ops import segment as jseg
from cartnet_tpu.ops.pallas import tp_kernels as jtp
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.ops import segment as tseg
from cartnet_tpu_torch.ops.kernels import segsum_kernels as k3
from cartnet_tpu_torch.ops.kernels import tp_kernels as k8

E, C = 2 * jtp.T_TP, 128
TOL = {"f32": 1e-5, "sum": 1e-4, "bf16": 1e-2}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
SUMS = ("dh", "dW", "db")


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(ours, ref):
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pair(a, dt):
    j = jnp.asarray(a, JDT[dt])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dt])


def _same_dtype(t, j):
    assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype, j.dtype)


# ------------------------------------------------------------------- K8

@pytest.fixture(scope="module")
def tp_vals():
    rng = np.random.default_rng(17)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(h=np.log1p(np.exp(mk(E, C))), a0=mk(E, 64), a1=mk(E, 8),
                a2=mk(E, 8), W=mk(C, 5120) * 0.05, b=mk(5120) * 0.05,
                dc0=mk(E, 64), dc1=mk(E, 8), dc2=mk(E, 8))


def _inputs(vals, l2, dt):
    names = ["h", "a0", "a1", "a2", "W", "b"] if l2 else ["h", "a0", "W",
                                                          "b"]
    names += ["dc0"] if l2 else ["dc0", "dc1", "dc2"]
    p = {k: _pair(vals[k], dt) for k in names}
    j = {k: v[0] for k, v in p.items()}
    t = {k: v[1] for k, v in p.items()}
    t["W"] = t["W"].t().contiguous()  # the port takes wt [5120, d]
    a_names = ["a0", "a1", "a2"] if l2 else ["a0"]
    dc_names = ["dc0"] if l2 else ["dc0", "dc1", "dc2"]
    return j, t, a_names, dc_names


def _port_bwd(t, l2, a_names, dc_names):
    paths = k8.PATHS_L2 if l2 else k8.PATHS_L1
    dh, das, dwt, db = k8.tp_contract_bwd(
        paths, t["h"], [t[k] for k in a_names], t["W"], t["b"],
        [t[k] for k in dc_names])
    return dict(dh=dh, **{f"d{k}": v for k, v in zip(a_names, das)},
                dW=dwt.t(), db=db)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
@pytest.mark.parametrize("ref", ["kernel", "vjp"])
def test_tp_bwd_plain_matches_pallas(tp_vals, l2, dt, ref):
    """Against the Pallas ``_bwd_call`` itself and against jax.vjp of the
    custom-VJP entries (both in interpret mode)."""
    j, t, a_names, dc_names = _inputs(tp_vals, l2, dt)
    paths = jtp.PATHS_L2 if l2 else jtp.PATHS_L1
    a_list = [j[k] for k in a_names]
    dcs = [j[k] for k in dc_names]
    if ref == "kernel":
        outs = jtp._bwd_call(paths, len(a_list), l2, j["h"], a_list, j["W"],
                             j["b"], dcs, True)
        dh, das, dW, db = outs[0], outs[1:-2], outs[-2], outs[-1][0]
    else:
        if l2:
            f = lambda h, a0, a1, a2, W, b: jtp.tp_contract_l2(
                h, a0, a1, a2, W, b, True)
        else:
            f = lambda h, a0, W, b: jtp.tp_contract_l1(h, a0, W, b, True)
        _, vjp = jax.vjp(f, j["h"], *a_list, j["W"], j["b"])
        grads = vjp(dcs[0] if l2 else tuple(dcs))
        dh, das, dW, db = grads[0], grads[1:-2], grads[-2], grads[-1]
    want = dict(dh=dh, **{f"d{k}": v for k, v in zip(a_names, das)}, dW=dW,
                db=db)
    got = _port_bwd(t, l2, a_names, dc_names)
    assert got.keys() == want.keys()
    for name in want:
        if ref == "kernel":
            _same_dtype(got[name], want[name])
        tol = TOL["bf16"] if dt == "bf16" else TOL[
            "sum" if name in SUMS else "f32"]
        assert _err(got[name], want[name]) <= tol, (name, _err(got[name],
                                                                want[name]))


def test_tp_bwd_plain_rounds_where_the_pallas_kernel_does(tp_vals):
    # f32 a and dc beside bf16 h are rounded to bf16 first: the rounded
    # inputs give the same bits
    _, t, a_names, dc_names = _inputs(tp_vals, False, "bf16")
    args = (k8.PATHS_L1, t["h"], [t["a0"].float()], t["W"], t["b"])
    got = k8.tp_contract_bwd(*args, [t[k].float() for k in dc_names])
    want = k8.tp_contract_bwd(*args[:2], [t["a0"]], *args[3:],
                              [t[k] for k in dc_names])
    for g, w in zip((got[0], *got[1], got[2], got[3]),
                    (want[0], *want[1], want[2], want[3])):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].dtype == got[1][0].dtype == torch.bfloat16
    assert got[2].dtype == got[3].dtype == torch.float32


@pytest.mark.parametrize("l2", [False, True], ids=["l1", "l2"])
def test_tp_functions_match_autograd_of_plain(tp_vals, l2):
    _, t, a_names, _ = _inputs(tp_vals, l2, "f32")
    ins = [t["h"], *(t[k] for k in a_names), t["W"], t["b"]]
    rng = np.random.default_rng(3)
    ins1 = [x.clone().requires_grad_() for x in ins]
    ins2 = [x.clone().requires_grad_() for x in ins]
    fn = k8.TPContractL2 if l2 else k8.TPContractL1
    out1 = fn.apply(*ins1)
    paths = k8.PATHS_L2 if l2 else k8.PATHS_L1
    out2 = k8.tp_contract_plain(paths, ins2[0], ins2[1:-2], ins2[-2],
                                ins2[-1])
    out1 = (out1,) if l2 else out1
    out2 = (out2,) if l2 else out2
    cts = [torch.tensor(rng.normal(size=o.shape).astype(np.float32))
           for o in out1]
    g1 = torch.autograd.grad(out1, ins1, cts)
    g2 = torch.autograd.grad(out2, ins2, cts)
    for i, (a, b) in enumerate(zip(g1, g2)):
        assert a.dtype == ins[i].dtype
        tol = TOL["sum"] if i in (0, len(ins) - 2, len(ins) - 1) \
            else TOL["f32"]
        assert _err(a, b) <= tol, (i, _err(a, b))


def test_tp_bwd_wrapper_checks(tp_vals):
    _, t, _, _ = _inputs(tp_vals, False, "bf16")
    h, a, W, b = t["h"], t["a0"], t["W"], t["b"]
    dcs = [t["dc0"], t["dc1"], t["dc2"]]
    P1, P2 = k8.PATHS_L1, k8.PATHS_L2
    before = k8.bwd_launches
    k8.tp_contract_bwd(P1, h, [a], W, b, dcs)
    assert k8.bwd_launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):  # L2 takes one dc and three a
        k8.tp_contract_bwd(P2, h, [a], W, b, dcs)
    with pytest.raises(ValueError):
        k8.tp_contract_bwd(P1, h, [a], W, b, [dcs[0], dcs[1][:, :4],
                                              dcs[2]])
    with pytest.raises(ValueError):  # W in the JAX layout [d, 5120]
        k8.tp_contract_bwd(P1, h, [a], W.t(), b, dcs)
    with pytest.raises(TypeError):  # dc in f16
        k8.tp_contract_bwd(P1, h, [a], W, b, [dcs[0].half(), *dcs[1:]])
    with pytest.raises(TypeError):  # W in another dtype than h
        k8.tp_contract_bwd(P1, h, [a], W.float(), b, dcs)
    with pytest.raises(ValueError):  # paths that are neither layer's
        k8.tp_contract_bwd(P1[:2], h, [a], W, b, dcs[:2])
    with pytest.raises(ValueError):
        k8.tp_contract_bwd(P1, *(x.to("meta") for x in (h,)),
                           [a.to("meta")], W.to("meta"), b.to("meta"),
                           [x.to("meta") for x in dcs])
    with pytest.raises(ValueError):  # operands on two devices
        k8.tp_contract_bwd(P1, h, [a], W, b, [dcs[0].to("meta"), *dcs[1:]])


# ------------------------------------------------- K3 in the gather VJPs

@pytest.fixture(scope="module")
def batch():
    recs = synthetic_dataset(3, mean_atoms=40, radius=5.0, adp=True, seed=6)
    rnd = lambda v: -(-v // 512) * 512
    n_e = sum(rnd(len(r["edge_src"])) for r in recs)
    b = collate(recs, 192, n_e, 3, edge_align=512)
    assert (~b.edge_mask[:np.flatnonzero(b.edge_mask)[-1]]).any()
    return b


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gather_sorted_backward_matches_jax(batch, dt):
    b = batch
    rng = np.random.default_rng(8)
    vals = rng.normal(size=(b.num_nodes, 64)).astype(np.float32)
    # the model's pad-edge cotangents are zero (test_torch_port_comformer_
    # train checks it): the JAX package sums them, the port leaves them out
    ct = rng.normal(size=(b.num_edges, 64)).astype(np.float32) \
        * b.edge_mask[:, None]
    jv, tv = _pair(vals, dt)
    jct, tct = _pair(ct, dt)
    dst = jnp.asarray(b.edge_dst)
    out, vjp = jax.vjp(lambda v: jseg.gather_sorted_vjp(v, dst, None, None),
                       jv)
    # XLA's CPU segment_sum adds bf16 values in bf16; the reference sums
    # the same cotangents in f32 and rounds once, as K3 does
    ref = vjp(jct)[0] if dt == "f32" else jax.ops.segment_sum(
        jct.astype(jnp.float32), dst, b.num_nodes,
        indices_are_sorted=True).astype(jnp.bfloat16)
    tv.requires_grad_()
    got = tseg.gather_sorted(tv, torch.tensor(b.edge_dst),
                             torch.tensor(b.dst_rowptr),
                             torch.tensor(b.edge_mask))
    assert torch.equal(got.detach(), tv.detach()[torch.tensor(b.edge_dst)
                                                  .long()])
    assert _err(got, out) == 0.0
    before = k3.launches
    (grad,) = torch.autograd.grad(got, tv, tct)
    assert k3.launches == before  # the plain version on the CPU
    _same_dtype(grad, ref)
    assert _err(grad, ref) <= TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_segment_sum_presorted_backward_matches_jax(batch, dt):
    b = batch
    rng = np.random.default_rng(9)
    vals = rng.normal(size=(b.num_edges, 40)).astype(np.float32)
    ct = rng.normal(size=(b.num_nodes, 40)).astype(np.float32)
    jv, tv = _pair(vals, dt)
    jct, tct = _pair(ct, dt)
    src, perm = jnp.asarray(b.edge_src), jnp.asarray(b.edge_src_perm)
    mask = jnp.asarray(b.edge_mask)
    ids_eff = jnp.where(jnp.asarray(b.edge_mask_src_sorted),
                        jnp.asarray(b.edge_src_sorted),
                        b.num_nodes).astype(jnp.int32)
    _, vjp = jax.vjp(lambda v: jseg.segment_sum_presorted(
        v, src, perm, ids_eff, mask, b.num_nodes), jv)
    ref = vjp(jct)[0]
    tv.requires_grad_()
    T = torch.tensor
    out = tseg.segment_sum_presorted(tv, T(b.edge_src_perm), T(b.src_rowptr),
                                     T(b.edge_mask_src_sorted), T(b.edge_src),
                                     T(b.edge_mask))
    (grad,) = torch.autograd.grad(out, tv, tct)
    _same_dtype(grad, ref)
    assert _err(grad, ref) == 0.0  # a gather and a mask: exact
    assert not grad[T(~b.edge_mask)].any()
