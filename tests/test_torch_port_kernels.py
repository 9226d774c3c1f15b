"""Plain versions of the port's two kernels vs the JAX package's Pallas
kernels (interpret mode) and their jnp twins, and the wrappers' dispatch.

K1 = edge_kernels._fwd_kernel, K2 = segment_kernels._sigma_seg_kernel, at
the size of tests/test_edge_kernel.py (D = 128, N = 512). Dtype cases are
the ones the model feeds them: f32 compute, bf16 compute in layer 0 (bf16
node tables) and bf16 compute after layer 0 (f32 node tables, bf16 edges).

Tolerances: f32 1e-5 (summation order differs). bf16 2e-2: h and the
outputs are rounded to bf16 (relative step 2^-8), and a different f32
summation order may round either to the neighbouring bf16 value.
Edge-kernel rows are compared under edge_mask only: the Pallas kernel
gathers zeros for pad endpoints outside its band, the port real rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartnet_tpu.ops.pallas import reference as jref
from cartnet_tpu.ops.pallas.edge_kernels import (C_SRC, T_EDGES,
                                                 edge_phase_fwd as jax_ep_fwd,
                                                 edge_windows_ok)
from cartnet_tpu.ops.pallas.segment_kernels import C_WINDOW, sigma_segsum \
    as jax_sigma
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
from cartnet_tpu_torch.ops.kernels import segment_kernels as sk

D, N = 128, 512
CASES = {"f32": (np.float32, np.float32), "bf16": ("bf16", "bf16"),
         "mixed": (np.float32, "bf16")}  # (node tables / gate, edges)
TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}


def _jdt(dt):
    return jnp.bfloat16 if dt == "bf16" else jnp.float32


def _tdt(dt):
    return torch.bfloat16 if dt == "bf16" else torch.float32


def _pair(a, dt):
    """The same values as a JAX array and a torch tensor of dtype dt."""
    j = jnp.asarray(a, _jdt(dt))
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(_tdt(dt))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _batch(edge_align):
    recs = synthetic_dataset(3, mean_atoms=60, radius=5.0, adp=False, seed=5)
    rnd = lambda v: -(-v // T_EDGES) * T_EDGES
    if edge_align:
        e = sum(rnd(len(r["edge_src"])) for r in recs)
    else:
        e = rnd(sum(len(r["edge_src"]) for r in recs))
    return collate(recs, N, e, 3, edge_align=edge_align)


@pytest.fixture(scope="module")
def edge_setup():
    batch = _batch(0)
    ok, dst_lo, src_lo, src_nblk = edge_windows_ok(
        batch.edge_dst, batch.edge_src, batch.edge_mask, N)
    assert ok, "synthetic batch must satisfy the Pallas band condition"
    rng = np.random.default_rng(0)
    E = batch.num_edges
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    vals = dict(xi=mk(N, 2 * D), xj=mk(N, 2 * D), e=mk(E, D),
                we=mk(D, 2 * D), b=mk(2 * D), w1g=mk(D, D), b1g=mk(D),
                w1a=mk(D, D), b1a=mk(D))
    return batch, vals, (dst_lo, src_lo, src_nblk)


def _edge_inputs(vals, case):
    tdt, edt = CASES[case]
    names = ("xi", "xj", "e", "we", "b", "w1g", "b1g", "w1a", "b1a")
    pairs = {k: _pair(vals[k], tdt if k in ("xi", "xj") else edt)
             for k in names}
    return ([pairs[k][0] for k in names], [pairs[k][1] for k in names])


@pytest.fixture(scope="module", params=list(CASES))
def edge_case(request, edge_setup):
    case = request.param
    batch, vals, plan = edge_setup
    jin, tin = _edge_inputs(vals, case)
    idx = (jnp.asarray(batch.edge_dst), jnp.asarray(batch.edge_src),
           jnp.asarray(batch.edge_mask))
    ref = jax_ep_fwd(*jin, *idx, *(jnp.asarray(p) for p in plan),
                     c_src=C_SRC, interpret=True, saved=True)
    tidx = (torch.tensor(batch.edge_dst), torch.tensor(batch.edge_src),
            torch.tensor(batch.edge_mask))
    ours = ek.edge_phase_fwd_plain(*tin, *tidx, saved=True, moments=True,
                                   tile=T_EDGES)
    return case, batch, ref, ours


def test_edge_plain_matches_pallas_kernel(edge_case):
    case, batch, ref, ours = edge_case
    tol = TOL["f32" if case == "f32" else "bf16"]
    m = batch.edge_mask
    for name, a, r in zip(("gate", "sender", "saved"), ours[:3], ref[:3]):
        assert a.dtype == _tdt(CASES[case][0]), name
        assert a.shape == tuple(r.shape), name
        np.testing.assert_allclose(_np(a)[m], _np(r)[m], err_msg=name, **tol)
    # per-window moments cover masked rows only, so they agree everywhere
    for name, a, r in zip(("s1_w", "M2_w"), ours[3:], ref[3:]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(r), err_msg=name,
                                   atol=tol["atol"] * 64, rtol=tol["rtol"])


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_edge_plain_matches_jnp_twin(edge_setup, case):
    # the twin rounds h to the node-table dtype, the kernel to e's: the two
    # agree only when they are the same dtype, so the mixed case is held
    # against the Pallas kernel above
    batch, vals, _ = edge_setup
    jin, tin = _edge_inputs(vals, case)
    ref = jref.edge_phase_fwd_ref(*jin, jnp.asarray(batch.edge_dst),
                                  jnp.asarray(batch.edge_src),
                                  jnp.asarray(batch.edge_mask))
    ours = ek.edge_phase_fwd_plain(
        *tin, torch.tensor(batch.edge_dst), torch.tensor(batch.edge_src),
        torch.tensor(batch.edge_mask), moments=True, tile=T_EDGES)
    tol = TOL[case]
    for name, a, r in (("gate", ours[0], ref[0]), ("sender", ours[1], ref[1]),
                       ("s1_w", ours[3], ref[3])):
        np.testing.assert_allclose(_np(a), _np(r), err_msg=name,
                                   atol=tol["atol"] * (64 if name == "s1_w"
                                                       else 1),
                                   rtol=tol["rtol"])


def _sigma_vals(batch, d, seed=1):
    rng = np.random.default_rng(seed)
    E = batch.num_edges
    mk = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    return dict(gate=mk(E, d), sender=mk(E, d), scale=1.0 + 0.1 * mk(d),
                shift=mk(d), env=1.0 / (1.0 + np.exp(-mk(E, 1))),
                e_in=mk(E, d))


@pytest.fixture(scope="module", params=[0, 512])
def sigma_setup(request):
    batch = _batch(request.param)
    return request.param, batch, _sigma_vals(batch, D)


@pytest.mark.parametrize("case", list(CASES))
def test_sigma_plain_matches_pallas_kernel_and_twin(sigma_setup, case):
    align, batch, vals = sigma_setup
    _sigma_plain_vs_jax(batch, vals, case)
    if align:  # the batch really has pads between real edges
        last = np.flatnonzero(batch.edge_mask)[-1]
        assert (~batch.edge_mask[:last]).any()


@pytest.mark.parametrize("case", list(CASES))
def test_sigma_plain_matches_pallas_kernel_odd_width(case):
    # a width that is not a multiple of 8 (the CUDA kernel's scalar route
    # on the card): the same function at d = 36 on the aligned batch
    batch = _batch(512)
    _sigma_plain_vs_jax(batch, _sigma_vals(batch, 36, seed=2), case)


def _sigma_plain_vs_jax(batch, vals, case):
    """K2's plain version against the Pallas kernel (interpret mode) and
    its jnp twin on the same values, at the case's tolerance."""
    gdt, edt = CASES[case]
    pg = {k: _pair(vals[k], gdt) for k in ("gate", "sender", "env")}
    pe = _pair(vals["e_in"], edt)
    scale, shift = vals["scale"], vals["shift"]
    mask = jnp.asarray(batch.edge_mask)
    ids_eff = jnp.where(mask, jnp.asarray(batch.edge_dst), N).astype(
        jnp.int32)
    lo = ((ids_eff[::T_EDGES] // 16) * 16).astype(jnp.int32)
    jargs = (pg["gate"][0], jnp.asarray(scale), jnp.asarray(shift),
             pg["env"][0], pg["sender"][0], pe[0])
    ref_k = jax_sigma(*jargs, ids_eff, lo, N, C_WINDOW, True)
    ref_t = jref.sigma_fwd_ref(*jargs, ids_eff, N)
    e_out, aggr = sk.sigma_segsum_plain(
        pg["gate"][1], torch.tensor(scale), torch.tensor(shift),
        pg["env"][1], pg["sender"][1], pe[1], torch.tensor(batch.edge_dst),
        torch.tensor(batch.edge_mask), N)
    assert e_out.dtype == _tdt(edt) and aggr.dtype == _tdt(gdt)
    tol = TOL["f32" if case == "f32" else "bf16"]
    for ref in (ref_k, ref_t):
        assert _tdt(edt) == (torch.bfloat16 if ref[0].dtype == jnp.bfloat16
                             else torch.float32)
        np.testing.assert_allclose(_np(e_out), _np(ref[0]), **tol)
        np.testing.assert_allclose(_np(aggr), _np(ref[1]), **tol)


def _wrapper_args(batch, vals):
    T = torch.tensor
    tidx = (T(batch.edge_dst), T(batch.edge_src), T(batch.edge_mask))
    return [T(vals[k]) for k in ("xi", "xj", "e", "we", "b", "w1g", "b1g",
                                 "w1a", "b1a")], tidx


def test_wrappers_take_plain_path_on_cpu(edge_setup):
    batch, vals, _ = edge_setup
    tin, tidx = _wrapper_args(batch, vals)
    before = (ek.launches, sk.launches)
    got = ek.edge_phase_fwd(*tin, *tidx)
    want = ek.edge_phase_fwd_plain(*tin, *tidx)
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    assert got[2] is None and got[3] is None and got[4] is None
    E = batch.num_edges
    gate, sender = got[0], got[1]
    scale, shift = torch.ones(D), torch.zeros(D)
    env = torch.full((E, 1), 0.5)
    rowptr = torch.tensor(batch.dst_rowptr)
    e_out, aggr = sk.sigma_segsum(gate, scale, shift, env, sender, tin[2],
                                  tidx[0], tidx[2], rowptr, N)
    e_ref, a_ref = sk.sigma_segsum_plain(gate, scale, shift, env, sender,
                                         tin[2], tidx[0], tidx[2], N)
    assert torch.equal(e_out, e_ref) and torch.equal(aggr, a_ref)
    assert (ek.launches, sk.launches) == before  # no kernel on the CPU


def test_wrappers_check_inputs(edge_setup):
    batch, vals, _ = edge_setup
    tin, tidx = _wrapper_args(batch, vals)
    bad = list(tin)
    bad[3] = bad[3].bfloat16()  # We in another dtype than e
    with pytest.raises(TypeError):
        ek.edge_phase_fwd(*bad, *tidx)
    with pytest.raises(ValueError):
        ek.edge_phase_fwd(*tin, tidx[0][:-1], *tidx[1:])
    with pytest.raises(TypeError):
        ek.edge_phase_fwd(*tin, tidx[0].long(), *tidx[1:])
    E = batch.num_edges
    g = torch.zeros(E, D)
    with pytest.raises(ValueError):  # rowptr must have N + 1 entries
        sk.sigma_segsum(g, torch.ones(D), torch.zeros(D), torch.ones(E, 1),
                        g, g, tidx[0], tidx[2], torch.zeros(N, dtype=torch.int32),
                        N)


def _csrc_int(source: str, name: str) -> int:
    """``constexpr int name = n;`` of a CUDA source of the port."""
    import re
    from cartnet_tpu_torch.ops.kernels import _build
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("source,decl,ints", [
    ("sigma_segsum_fwd.cu", "__shared__ int list_s[WARPS][32 * WORD];",
     lambda threads, word: threads * word),
    ("segment_sum_csr.cu", "__shared__ int list_s[ROUND];",
     lambda threads, word: threads * word + threads // 32),
])
def test_row_kernel_lists_fit_static_shared_memory(source, decl, ints):
    """K2's per-warp lists and K3's per-block list hold one int per
    position of a window (WORD mask bytes a lane, row_vectors.cuh); with
    K3's warp counts they stay within the 48 KB of static shared memory a
    block may declare, so no launch opts in to more."""
    from cartnet_tpu_torch.ops.kernels import _build
    assert decl in (_build.CSRC / source).read_text()
    word = _csrc_int("row_vectors.cuh", "WORD")
    threads = _csrc_int(source, "THREADS")
    assert word == 32 and threads % 32 == 0
    assert 4 * ints(threads, word) <= 48 * 1024
