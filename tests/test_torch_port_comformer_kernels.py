"""Plain versions of the eComformer's two kernels vs the JAX package's
Pallas kernels (interpret mode) and their jnp twins, and the wrappers'
checks.

K3 = segment_kernels._seg_kernel (``segment_sum_sorted_window``) as the
eComformer's scatter onto edge sources calls it, on a batch with per-graph
alignment pads on each graph's last node, and in the ``perm=None`` form
over dst-sorted edges. K7 = tp_kernels._tp_fwd_kernel through
``tp_contract_l1``/``tp_contract_l2`` at E = 256, d = 128, in the dtype cases
the eComformer feeds it: f32, bf16, and bf16 h/W with f32 a.

Tolerances, as max |port - JAX| / max |JAX|: 1e-5 in f32 (sums in another
order); 1e-2 where bf16 rounds (one bf16 step is 2^-8 of the value rounded,
and a different f32 summation order may round either way; the Pallas K3
also rounds each 512-edge window's partial to bf16, the port once).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartnet_tpu.ops.pallas import reference as jref
from cartnet_tpu.ops.pallas.segment_kernels import segment_sum_sorted_window
from cartnet_tpu.ops.pallas.tp_kernels import (T_TP, tp_contract_l1 as
                                               jax_l1, tp_contract_l2 as
                                               jax_l2)
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.ops import segment as tseg
from cartnet_tpu_torch.ops.kernels import segsum_kernels as k3
from cartnet_tpu_torch.ops.kernels import tp_kernels as k7

N, D = 256, 128
TOL = {"f32": 1e-5, "bf16": 1e-2}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _err(ours, ref):
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pair(a, dt):
    """The same values as a JAX array and a torch tensor of dtype dt."""
    j = jnp.asarray(a, JDT[dt])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dt])


def _same_dtype(t, j):
    assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype, j.dtype)


# ------------------------------------------------------------------- K3

@pytest.fixture(scope="module")
def seg_batch():
    recs = synthetic_dataset(3, mean_atoms=48, radius=5.0, adp=True, seed=4)
    rnd = lambda v: -(-v // 512) * 512
    E = sum(rnd(len(r["edge_src"])) for r in recs)
    batch = collate(recs, N, E, 3, edge_align=512)
    # pads sit inside the src-sorted order, on each graph's last node
    ms = batch.edge_mask_src_sorted
    assert (~ms[:np.flatnonzero(ms)[-1]]).any()
    return batch


def _widths(main: int, odd: int):
    """dt x width cases: the main width under the plain dtype ids, and a
    width that is not a multiple of 8 (the CUDA kernel's scalar route on
    the card)."""
    return [pytest.param(dt, w, id=dt if w == main else f"{dt}-{w}")
            for w in (main, odd) for dt in ("f32", "bf16")]


@pytest.mark.parametrize("dt,width", _widths(D, 36))
def test_segment_sum_plain_matches_pallas_kernel_and_twin(seg_batch, dt,
                                                          width):
    b = seg_batch
    E = b.num_edges
    vals = np.random.default_rng(0).normal(size=(E, width)).astype(
        np.float32)
    jv, tv = _pair(vals, dt)
    perm = jnp.asarray(b.edge_src_perm)
    ids_eff = jnp.where(jnp.asarray(b.edge_mask_src_sorted),
                        jnp.asarray(b.edge_src_sorted), N).astype(jnp.int32)
    vs = jv[perm]
    ref_k = segment_sum_sorted_window(vs, ids_eff, N, interpret=True)
    # XLA's CPU segment_sum adds bf16 values in bf16, a rounding per add
    # that neither kernel has: the twin sums the same values in f32 and
    # rounds once, as both kernels accumulate
    ref_t = jref.segment_sum_sorted_window_ref(
        vs.astype(jnp.float32), ids_eff, N).astype(vs.dtype)
    ours = k3.segment_sum_csr(tv, torch.tensor(b.src_rowptr),
                              torch.tensor(b.edge_mask_src_sorted),
                              torch.tensor(b.edge_src_perm))
    via_op = tseg.segment_sum_presorted(
        tv, torch.tensor(b.edge_src_perm), torch.tensor(b.src_rowptr),
        torch.tensor(b.edge_mask_src_sorted), torch.tensor(b.edge_src),
        torch.tensor(b.edge_mask))
    assert torch.equal(ours, via_op)
    for ref in (ref_k, ref_t):
        _same_dtype(ours, ref)
        assert _err(ours, ref) <= TOL[dt], dt
    # pad values never count: poisoning them changes nothing
    poisoned = tv.clone()
    poisoned[torch.tensor(~b.edge_mask)] = 1e4
    again = k3.segment_sum_csr(poisoned, torch.tensor(b.src_rowptr),
                               torch.tensor(b.edge_mask_src_sorted),
                               torch.tensor(b.edge_src_perm))
    assert torch.equal(ours, again)


@pytest.mark.parametrize("dt,width", _widths(64, 33))
def test_segment_sum_plain_without_perm(seg_batch, dt, width):
    # the form the gather backward will use: ids already sorted (dst)
    b = seg_batch
    vals = np.random.default_rng(1).normal(
        size=(b.num_edges, width)).astype(np.float32)
    jv, tv = _pair(vals, dt)
    ids_eff = jnp.where(jnp.asarray(b.edge_mask), jnp.asarray(b.edge_dst),
                        N).astype(jnp.int32)
    ref = segment_sum_sorted_window(jv, ids_eff, N, interpret=True)
    ours = k3.segment_sum_csr(tv, torch.tensor(b.dst_rowptr),
                              torch.tensor(b.edge_mask))
    _same_dtype(ours, ref)
    assert _err(ours, ref) <= TOL[dt]


def test_segment_sum_wrapper_checks(seg_batch):
    b = seg_batch
    v = torch.zeros(b.num_edges, D)
    rowptr = torch.tensor(b.src_rowptr)
    mask = torch.tensor(b.edge_mask_src_sorted)
    perm = torch.tensor(b.edge_src_perm)
    before = k3.launches
    k3.segment_sum_csr(v, rowptr, mask, perm)
    assert k3.launches == before  # no kernel on the CPU
    with pytest.raises(TypeError):
        k3.segment_sum_csr(v, rowptr, mask, perm.long())
    with pytest.raises(TypeError):
        k3.segment_sum_csr(v.double(), rowptr, mask, perm)
    with pytest.raises(ValueError):
        k3.segment_sum_csr(v, rowptr, mask[:-1], perm)
    with pytest.raises(ValueError):
        k3.segment_sum_csr(v.to("meta"), rowptr.to("meta"), mask.to("meta"),
                           perm.to("meta"))
    with pytest.raises(ValueError):  # operands on two devices
        k3.segment_sum_csr(v, rowptr, mask, perm.to("meta"))


# ------------------------------------------------------------------- K7

CASES = {"f32": ("f32", "f32"), "bf16": ("bf16", "bf16"),
         "mixed": ("bf16", "f32")}  # (h / W / b dtype, a dtype)


@pytest.fixture(scope="module")
def tp_vals():
    rng = np.random.default_rng(7)
    E, C = 2 * T_TP, 128
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(h=mk(E, C), a0=mk(E, 64), a1=mk(E, 8), a2=mk(E, 8),
                W=mk(C, 5120) * 0.05, b=mk(5120) * 0.05)


def _tp_inputs(vals, case):
    hdt, adt = CASES[case]
    p = {k: _pair(vals[k], adt if k.startswith("a") else hdt) for k in vals}
    j = {k: v[0] for k, v in p.items()}
    t = {k: v[1] for k, v in p.items()}
    t["W"] = t["W"].t().contiguous()  # the port takes wt [5120, d]
    return j, t


@pytest.mark.parametrize("case", list(CASES))
def test_tp_l1_plain_matches_pallas_kernel(tp_vals, case):
    j, t = _tp_inputs(tp_vals, case)
    ref = jax_l1(j["h"], j["a0"], j["W"], j["b"], True)
    ours = k7.tp_contract_l1(t["h"], t["a0"], t["W"], t["b"])
    tol = TOL["f32" if case == "f32" else "bf16"]
    for name, o, r in zip(("c0", "c1", "c2"), ours, ref):
        _same_dtype(o, r)
        assert _err(o, r) <= tol, (case, name, _err(o, r))


@pytest.mark.parametrize("case", list(CASES))
def test_tp_l2_plain_matches_pallas_kernel(tp_vals, case):
    j, t = _tp_inputs(tp_vals, case)
    ref = jax_l2(j["h"], j["a0"], j["a1"], j["a2"], j["W"], j["b"], True)
    ours = k7.tp_contract_l2(t["h"], t["a0"], t["a1"], t["a2"], t["W"],
                             t["b"])
    _same_dtype(ours, ref)
    err = _err(ours, ref)
    assert err <= TOL["f32" if case == "f32" else "bf16"], (case, err)


def test_tp_plain_rounds_where_the_pallas_kernel_does(tp_vals):
    # bf16 h with f32 a: a is rounded to bf16 first, so feeding the rounded
    # a gives the same bits
    _, t = _tp_inputs(tp_vals, "mixed")
    got = k7.tp_contract_l1(t["h"], t["a0"], t["W"], t["b"])
    want = k7.tp_contract_l1(t["h"], t["a0"].bfloat16(), t["W"], t["b"])
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_tp_wrapper_checks(tp_vals):
    _, t = _tp_inputs(tp_vals, "mixed")
    h, a0, a1, a2, W, b = (t[k] for k in ("h", "a0", "a1", "a2", "W", "b"))
    before = k7.launches
    k7.tp_contract_l2(h, a0, a1, a2, W, b)
    assert k7.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):  # W in the JAX layout [d, 5120]
        k7.tp_contract_l1(h, a0, W.t(), b)
    with pytest.raises(ValueError):
        k7.tp_contract_l2(h, a0, a1[:, :4], a2, W, b)
    with pytest.raises(TypeError):  # W in another dtype than h
        k7.tp_contract_l1(h, a0, W.float(), b)
    with pytest.raises(TypeError):  # a0 f32, a1 bf16
        k7.tp_contract_l2(h, a0, a1.bfloat16(), a2, W, b)
    with pytest.raises(TypeError):  # bf16 a beside f32 h
        k7.tp_contract_l1(h.float(), a0.bfloat16(), W.float(), b.float())
    with pytest.raises(ValueError):
        k7.tp_contract_l1(*(x.to("meta") for x in (h, a0, W, b)))
    with pytest.raises(ValueError):  # operands on two devices
        k7.tp_contract_l1(h, a0.to("meta"), W, b)
