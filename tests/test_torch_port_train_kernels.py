"""Plain versions of the port's two backward kernels vs the JAX package, and
the autograd Functions that run them.

K4 = segment_kernels._sigma_seg_bwd_kernel (plain: sigma_segsum_bwd_plain),
K5 = edge_kernels._bwd_kernel (plain: edge_phase_bwd_plain), at the size of
test_torch_port_kernels.py (D = 128, N = 512), in the two dtype cases of
training: f32 compute, and bf16 compute (node tables, edges and weights all
bf16). Inputs and cotangents come from numpy with a seed; cotangents are zero
on pad-edge rows, as the model's are.

Tolerances, as max |ours - ref| / max |ref| per output: f32 elementwise
1e-5; f32 sums over all edges (weight and bias gradients, dscale/dshift,
dxi/dxj) 1e-4, since 10^3-10^4-term sums in another order differ that much;
2e-2 where bf16 rounding is involved (one bf16 step is 2^-8, and a
different f32 sum order may round to the neighbouring value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu.ops.pallas import reference as jref
from cartnet_tpu.ops.pallas.edge_kernels import (C_SRC, T_EDGES, edge_phase,
                                                 edge_windows_ok)
from cartnet_tpu.ops.pallas.segment_kernels import C_WINDOW
from cartnet_tpu.ops.pallas.segment_kernels import sigma_segsum as jsigma
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.nn.norm import combine_window_moments
from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
from cartnet_tpu_torch.ops.kernels import segment_kernels as sk

D, N = 128, 512
TOL = {"f32": 1e-5, "sum": 1e-4, "bf16": 2e-2}


def _jdt(case):
    return jnp.bfloat16 if case == "bf16" else jnp.float32


def _tdt(case):
    return torch.bfloat16 if case == "bf16" else torch.float32


def _pair(a, case):
    """The same values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, _jdt(case))
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(_tdt(case))


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(ours, ref, tol, name, scale=None):
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = np.abs(b).max() if scale is None else scale
    err = float(np.abs(a - b).max() / max(scale, 1e-30))
    assert err <= tol, (name, err, tol)


def _batch(edge_align):
    recs = synthetic_dataset(3, mean_atoms=60, radius=5.0, adp=False, seed=5)
    rnd = lambda v: -(-v // T_EDGES) * T_EDGES
    if edge_align:
        e = sum(rnd(len(r["edge_src"])) for r in recs)
    else:
        e = rnd(sum(len(r["edge_src"]) for r in recs))
    return collate(recs, N, e, 3, edge_align=edge_align)


def _idx(batch):
    T = torch.tensor
    return (T(batch.edge_dst), T(batch.edge_src), T(batch.edge_mask),
            T(batch.dst_rowptr), T(batch.edge_src_perm), T(batch.src_rowptr))


# ---------------------------------------------------------------- K4

@pytest.fixture(scope="module", params=[0, 512])
def sigma_setup(request):
    batch = _batch(request.param)
    rng = np.random.default_rng(11)
    E = batch.num_edges
    mk = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    m = batch.edge_mask[:, None]
    vals = dict(gate=mk(E, D), sender=mk(E, D), scale=1.0 + 0.1 * mk(D),
                shift=mk(D), env=1.0 / (1.0 + np.exp(-mk(E, 1))),
                e_in=mk(E, D), deout=mk(E, D) * m, daggr=mk(N, D))
    return batch, vals


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_sigma_bwd_plain_matches_pallas_vjp_and_twin(sigma_setup, case):
    batch, v = sigma_setup
    p = {k: _pair(v[k], case) for k in ("gate", "sender", "env", "e_in",
                                         "deout", "daggr")}
    scale, shift = v["scale"], v["shift"]
    mask = jnp.asarray(batch.edge_mask)
    ids_eff = jnp.where(mask, jnp.asarray(batch.edge_dst), N).astype(
        jnp.int32)
    lo = ((ids_eff[::T_EDGES] // 16) * 16).astype(jnp.int32)
    f = lambda g, sc, sh, env, snd, ein: jsigma(g, sc, sh, env, snd, ein,
                                                ids_eff, lo, N, C_WINDOW, True)
    _, vjp = jax.vjp(f, p["gate"][0], jnp.asarray(scale), jnp.asarray(shift),
                     p["env"][0], p["sender"][0], p["e_in"][0])
    ref_k = vjp((p["deout"][0], p["daggr"][0]))
    ref_t = jref.sigma_bwd_ref(p["gate"][0], jnp.asarray(scale),
                               jnp.asarray(shift), p["env"][0],
                               p["sender"][0], ids_eff, p["deout"][0],
                               p["daggr"][0], N)
    ours = sk.sigma_segsum_bwd_plain(
        p["gate"][1], torch.tensor(scale), torch.tensor(shift), p["env"][1],
        p["sender"][1], p["deout"][1], p["daggr"][1],
        torch.tensor(batch.edge_dst), torch.tensor(batch.edge_mask))
    names = ("dgate", "dscale", "dshift", "denv", "dsender")
    for ref in (ref_k[:5], ref_t):
        for name, a, r in zip(names, ours, ref):
            assert a.dtype == (torch.float32 if name in ("dscale", "dshift")
                               else _tdt(case)), name
            tol = TOL["bf16"] if case == "bf16" else (
                TOL["sum"] if name in ("dscale", "dshift") else TOL["f32"])
            _close(a, r, tol, name)
    # e_in's cotangent is deout itself
    _close(p["deout"][1], ref_k[5], 0.0, "de_in")


# ---------------------------------------------------------------- K5

@pytest.fixture(scope="module")
def edge_setup():
    batch = _batch(0)
    ok, dst_lo, src_lo, src_nblk = edge_windows_ok(
        batch.edge_dst, batch.edge_src, batch.edge_mask, N)
    assert ok, "synthetic batch must satisfy the Pallas band condition"
    rng = np.random.default_rng(12)
    E = batch.num_edges
    nt = E // T_EDGES
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    m = batch.edge_mask[:, None]
    vals = dict(xi=mk(N, 2 * D), xj=mk(N, 2 * D), e=mk(E, D),
                we=mk(D, 2 * D), b=mk(2 * D), w1g=mk(D, D) * 0.5,
                b1g=mk(D), w1a=mk(D, D) * 0.5, b1a=mk(D),
                dgate=mk(E, D) * m, dsender=mk(E, D) * m, deres=mk(E, D) * m,
                ds1w=mk(nt, D) * 0.01, dm2w=mk(nt, D) * 0.01)
    return batch, vals, (dst_lo, src_lo, src_nblk)


_PRIMALS = ("xi", "xj", "e", "we", "b", "w1g", "b1g", "w1a", "b1a")
_COTS = ("dgate", "dsender", "deres", "ds1w", "dm2w")
_GRADS = ("de", "dxi", "dxj", "dwe", "db", "dw1g", "db1g", "dw1a", "db1a")


def _edge_bwd_plain(batch, tin, tcot, tile):
    """Plain forward (for saved/gate/moments at ``tile``), then the plain
    backward with the given cotangents."""
    dst, src, emask = _idx(batch)[:3]
    gate, _, saved, s1w, _ = ek.edge_phase_fwd_plain(
        *tin, dst, src, emask, saved=True, moments=True, tile=tile)
    nt = s1w.shape[0]
    n_w = emask.reshape(nt, tile).sum(dim=1, dtype=torch.float32)[:, None]
    return ek.edge_phase_bwd_plain(
        tin[2], tin[3], tin[5], tin[7], saved, gate,
        s1w / torch.clamp(n_w, min=1.0), *tcot[3:], *tcot[:3], dst, src,
        emask, N, tile=tile)


def _tol(case, name):
    if case == "bf16":
        return TOL["bf16"]
    return TOL["f32"] if name == "de" else TOL["sum"]


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_edge_bwd_plain_matches_jnp_twin(edge_setup, case):
    batch, v, _ = edge_setup
    p = {k: _pair(v[k], case) for k in _PRIMALS + _COTS[:3]}
    tin = [p[k][1] for k in _PRIMALS]
    tcot = [p[k][1] for k in _COTS[:3]] + [torch.tensor(v[k])
                                           for k in _COTS[3:]]
    ours = _edge_bwd_plain(batch, tin, tcot, T_EDGES)
    # the twin takes the same saved residual, gate and mean_w
    dst, src, emask = _idx(batch)[:3]
    gate, _, saved, s1w, _ = ek.edge_phase_fwd_plain(
        *tin, dst, src, emask, saved=True, moments=True, tile=T_EDGES)
    n_w = emask.reshape(-1, T_EDGES).sum(dim=1, dtype=torch.float32)[:, None]
    j = lambda t: jnp.asarray(_np(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    ref = jref.edge_phase_bwd_ref(
        p["xi"][0], p["xj"][0], p["e"][0], p["we"][0], p["w1g"][0],
        p["w1a"][0], jnp.asarray(batch.edge_dst), jnp.asarray(batch.edge_src),
        jnp.asarray(batch.edge_mask), j(saved[:, :2 * D]), j(gate),
        j(s1w / torch.clamp(n_w, min=1.0)), jnp.asarray(v["ds1w"]),
        jnp.asarray(v["dm2w"]), p["dgate"][0], p["dsender"][0],
        p["deres"][0])
    for name, a, r in zip(_GRADS, ours, ref):
        _close(a, np.asarray(jnp.asarray(r, jnp.float32)).reshape(a.shape),
               _tol(case, name), name)
    assert ours[0].dtype == _tdt(case)
    assert all(g.dtype == torch.float32 for g in ours[1:])


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_edge_bwd_plain_matches_pallas_vjp(edge_setup, case):
    batch, v, plan = edge_setup
    p = {k: _pair(v[k], case) for k in _PRIMALS + _COTS[:3]}
    idx = (jnp.asarray(batch.edge_dst), jnp.asarray(batch.edge_src),
           jnp.asarray(batch.edge_mask)) + tuple(jnp.asarray(a) for a in plan)
    f = lambda *prim: edge_phase(*prim, *idx, C_SRC, True)
    _, vjp = jax.vjp(f, *(p[k][0] for k in _PRIMALS))
    ref = vjp((p["dgate"][0], p["dsender"][0], p["deres"][0],
               jnp.asarray(v["ds1w"]), jnp.asarray(v["dm2w"])))
    tin = [p[k][1] for k in _PRIMALS]
    tcot = [p[k][1] for k in _COTS[:3]] + [torch.tensor(v[k])
                                           for k in _COTS[3:]]
    de, dxi, dxj, dwe, db, dw1g, db1g, dw1a, db1a = _edge_bwd_plain(
        batch, tin, tcot, T_EDGES)
    ours = dict(dxi=dxi, dxj=dxj, de=de, dwe=dwe, db=db, dw1g=dw1g,
                db1g=db1g, dw1a=dw1a, db1a=db1a)
    for name, r in zip(("dxi", "dxj", "de", "dwe", "db", "dw1g", "db1g",
                        "dw1a", "db1a"), ref[:9]):
        a = ours[name]
        if name == "de":  # pad rows: Pallas gathers zeros out of its band
            a, r = _np(a)[batch.edge_mask], _np(r)[batch.edge_mask]
        _close(a, r, _tol(case, name), name)


# ------------------------------------------------- the autograd Functions

def _composition(batch, tin, gamma, beta, env, cts, functions: bool):
    """edge phase -> window-moment BN -> sigma chain -> weighted sum."""
    dst, src, emask, rowptr, perm, srowptr = _idx(batch)
    if functions:
        gate, sender, e_res, s1w, m2w = ek.EdgePhase.apply(
            *tin, dst, src, emask, rowptr, perm, srowptr)
    else:
        gate, sender, _, s1w, m2w = ek.edge_phase_fwd_plain(
            *tin, dst, src, emask, moments=True)
        e_res = tin[2]
    nt = s1w.shape[0]
    n_w = emask.reshape(nt, -1).sum(dim=1, dtype=torch.float32)[:, None]
    (scale, shift), _ = combine_window_moments(gamma, beta, s1w, m2w, n_w)
    envc = env.to(gate.dtype)
    if functions:
        e_out, aggr = sk.SigmaSegsum.apply(gate, scale, shift, envc, sender,
                                           e_res, dst, emask, rowptr, N)
    else:
        e_out, aggr = sk.sigma_segsum_plain(gate, scale, shift, envc,
                                            sender, e_res, dst, emask, N)
    return (e_out.float() * cts[0]).sum() + (aggr.float() * cts[1]).sum()


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_autograd_functions_match_plain_autograd(edge_setup, case):
    batch, v, _ = edge_setup
    rng = np.random.default_rng(13)
    E = batch.num_edges
    cts = (torch.tensor(rng.normal(size=(E, D)).astype(np.float32)
                        * batch.edge_mask[:, None]),
           torch.tensor(rng.normal(size=(N, D)).astype(np.float32)))
    env = torch.tensor(rng.uniform(0.2, 1.0, (E, 1)).astype(np.float32))
    bn = {"gamma": (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32),
          "beta": (0.1 * rng.normal(size=D)).astype(np.float32)}
    grads = []
    for functions in (True, False):
        tin = [_pair(v[k], case)[1].requires_grad_() for k in _PRIMALS]
        gamma = _pair(bn["gamma"], case)[1].requires_grad_()
        beta = _pair(bn["beta"], case)[1].requires_grad_()
        loss = _composition(batch, tin, gamma, beta, env, cts, functions)
        grads.append(torch.autograd.grad(loss, tin + [gamma, beta]))
    names = _PRIMALS + ("gamma", "beta")
    ref = dict(zip(names, grads[1]))
    for name, a, r in zip(names, *grads):
        assert a.dtype == r.dtype, name
        tol = TOL["bf16"] if case == "bf16" else (
            TOL["f32"] if name == "e" else TOL["sum"])
        # BN undoes a constant shift of the gate, so b1g's true gradient
        # cancels to rounding noise: hold it to the size of its summands,
        # which is that of W1g's gradient
        scale = float(np.abs(_np(ref["w1g"])).max()) if name == "b1g" \
            else None
        _close(a, r, tol, name, scale)


def test_edge_phase_function_passes_e_through(edge_setup):
    """e_res is e itself; its cotangent reaches de once (not twice)."""
    batch, v, _ = edge_setup
    tin = [torch.tensor(v[k]).requires_grad_() for k in _PRIMALS]
    dst, src, emask, rowptr, perm, srowptr = _idx(batch)
    out = ek.EdgePhase.apply(*tin, dst, src, emask, rowptr, perm, srowptr)
    assert torch.equal(out[2], tin[2])
    (de,) = torch.autograd.grad(out[2].sum(), [tin[2]])
    assert torch.equal(de, torch.ones_like(de))


def test_backward_wrappers_take_plain_path_on_cpu(edge_setup, sigma_setup):
    batch, v, _ = edge_setup
    tin = [torch.tensor(v[k]) for k in _PRIMALS]
    dst, src, emask, rowptr, perm, srowptr = _idx(batch)
    gate, _, saved, s1w, _ = ek.edge_phase_fwd(*tin, dst, src, emask,
                                               saved=True, moments=True)
    cot = [torch.tensor(v[k]) for k in ("dgate", "dsender", "deres")]
    z = torch.zeros_like(s1w)
    before = (ek.bwd_launches, sk.bwd_launches)
    got = ek.edge_phase_bwd(tin[2], tin[3], tin[5], tin[7], saved, gate, z,
                            z, z, *cot, dst, src, emask, rowptr, perm,
                            srowptr)
    want = ek.edge_phase_bwd_plain(tin[2], tin[3], tin[5], tin[7], saved,
                                   gate, z, z, z, *cot, dst, src, emask, N)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    sb, sv = sigma_setup
    T = torch.tensor
    sargs = (T(sv["gate"]), T(sv["scale"]), T(sv["shift"]), T(sv["env"]),
             T(sv["sender"]), T(sv["deout"]), T(sv["daggr"]),
             T(sb.edge_dst), T(sb.edge_mask))
    for a, b in zip(sk.sigma_segsum_bwd(*sargs),
                    sk.sigma_segsum_bwd_plain(*sargs)):
        assert torch.equal(a, b)
    assert (ek.bwd_launches, sk.bwd_launches) == before
    with pytest.raises(TypeError):  # one dtype for tables, edges, weights
        ek.edge_phase_bwd(tin[2], tin[3].bfloat16(), tin[5], tin[7], saved,
                          gate, z, z, z, *cot, dst, src, emask, rowptr, perm,
                          srowptr)
    with pytest.raises(ValueError):  # src_rowptr: at least N + 1 entries
        ek.edge_phase_bwd(tin[2], tin[3], tin[5], tin[7], saved, gate, z, z,
                          z, *cot, dst, src, emask, rowptr, perm,
                          srowptr[:-1])
    with pytest.raises(ValueError):  # daggr must be [N, d] in gate's dtype
        sk.sigma_segsum_bwd(*sargs[:6], sargs[6][:, :-1], *sargs[7:])


def _k4_constant(name: str) -> int:
    """``constexpr int name = n;`` of sigma_segsum_bwd.cu."""
    import re
    from cartnet_tpu_torch.ops.kernels import _build
    text = (_build.CSRC / "sigma_segsum_bwd.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("E", [1, 5, 8, 20993, 20992, 2 * 132 * 8 - 3])
def test_k4_scratch_rows_follow_the_grid_rule(E):
    """K4's partial rows (one per row-pass block) as ``bwd_parts`` mirrors
    them: the source's BLOCKS_PER_SM blocks an SM, at most one per WARPS
    edges, at least one; the wrapper sizes its scratch by the library's
    own count (``sigma_segsum_bwd_parts``), which the card run holds to
    the mirror. E below one block's warps, an odd E and the main path's."""
    import inspect
    warps = _k4_constant("THREADS") // 32
    per_sm = _k4_constant("BLOCKS_PER_SM")
    assert (sk.BWD_WARPS, sk.BWD_BLOCKS_PER_SM) == (warps, per_sm)
    for n_sm in (132, 114):
        want = max(1, min(n_sm * per_sm, -(-E // warps)))
        assert sk.bwd_parts(E, n_sm) == want
    assert sk.bwd_parts(20992, 132) == 264
    assert sk.bwd_parts(5, 132) == 1
    src = inspect.getsource(sk.sigma_segsum_bwd)
    assert "part = torch.empty((lib.sigma_segsum_bwd_parts(E), 2 * d)" in src


@pytest.mark.parametrize("d", [1, 256, 512])
def test_k4_row_pass_needs_no_shared_memory_opt_in(d):
    """K4's row pass holds its warps' partials [2][WARPS][d] f32 in dynamic
    shared memory; up to the source's MAX_WIDTH (the wrapper's limit) that
    stays within the 48 KB a launch takes without opting in, so a call
    sets no function attribute."""
    from cartnet_tpu_torch.ops.kernels import _build
    text = (_build.CSRC / "sigma_segsum_bwd.cu").read_text()
    warps = _k4_constant("THREADS") // 32
    assert d <= _k4_constant("MAX_WIDTH") == 512
    assert "sizeof(float) * 2 * WARPS * p.d, s, p);" in text
    assert 4 * 2 * warps * d <= 48 * 1024
    assert "cudaFuncSetAttribute(" not in text


# ----------------------------- K5 with separate dst and src row counts

N_RECV = 64  # the received rows past the dst table (halo partitioning)


def _two_counts(batch):
    """The batch's index tensors with a src table of N + N_RECV rows: every
    other real edge takes its src from a received row, and the src plan
    is rebuilt over the longer table -> (dst, src, emask, dst_rowptr,
    src_perm, src_rowptr), dst_rowptr over N rows."""
    src = batch.edge_src.astype(np.int64).copy()
    moved = batch.edge_mask & (np.arange(len(src)) % 2 == 1)
    src[moved] = N + src[moved] % N_RECV
    perm = np.argsort(src, kind="stable")
    srowptr = np.searchsorted(src[perm], np.arange(N + N_RECV + 1), "left")
    T = lambda a: torch.tensor(np.asarray(a, np.int32))
    return (T(batch.edge_dst), T(src), torch.tensor(batch.edge_mask),
            T(batch.dst_rowptr), T(perm), T(srowptr))


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_edge_phase_function_two_row_counts(edge_setup, case):
    """``EdgePhase`` (K5's plain version) with xj over N + N_RECV rows and
    xi over N: dxi has N rows, dxj N + N_RECV, and every gradient agrees
    with autograd through the plain forward (the received rows' dxj
    included, the rows no edge reads zero)."""
    batch, v, _ = edge_setup
    rng = np.random.default_rng(14)
    idx = _two_counts(batch)
    E = batch.num_edges
    xj_long = np.concatenate([v["xj"], (rng.normal(size=(N_RECV, 2 * D))
                                        * 0.3).astype(np.float32)])
    vals = dict(v, xj=xj_long)
    cts = [torch.tensor(rng.normal(size=(E, D)).astype(np.float32)
                        * batch.edge_mask[:, None]) for _ in range(2)]
    grads = []
    for functions in (True, False):
        tin = [_pair(vals[k], case)[1].requires_grad_() for k in _PRIMALS]
        if functions:
            gate, sender = ek.EdgePhase.apply(*tin, *idx, False)[:2]
        else:
            gate, sender = ek.edge_phase_fwd_plain(*tin, *idx[:3])[:2]
        loss = (gate.float() * cts[0]).sum() + (sender.float() * cts[1]).sum()
        grads.append(torch.autograd.grad(loss, tin))
    assert grads[0][0].shape == (N, 2 * D)
    assert grads[0][1].shape == (N + N_RECV, 2 * D)
    recv = torch.zeros(N + N_RECV, dtype=torch.bool)
    recv[idx[1][batch.edge_mask].long()] = True
    assert recv[N:].any() and not grads[0][1][~recv].any()
    for name, a, r in zip(_PRIMALS, *grads):
        assert a.dtype == r.dtype, name
        tol = TOL["bf16"] if case == "bf16" else (
            TOL["f32"] if name == "e" else TOL["sum"])
        _close(a, r, tol, name)
