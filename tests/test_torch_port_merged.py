"""The merged CartNet backward (K6) and the CARTNET_MERGED=1 training path
vs the JAX package.

K6 = edge_kernels._bwd_merged_kernel (plain: merged_bwd_plain), driven by
_fes_bwd, the backward of fused_edge_sigma under CARTNET_MERGED=1; K1's
pre-only residual is the forward's saved=False. At D = 128 on three
RCM-reordered synthetic crystals with per-graph edge_align 512 (the setting
of tests/test_merged_backward.py), so that the JAX package takes its Pallas
kernels, run in interpret mode. Inputs and cotangents come from numpy with a
seed; cotangents are zero on pad-edge rows, as the model's are.

Tolerances, as max |ours - ref| / max |ref| per output, those of
test_torch_port_train_kernels.py: f32 elementwise 1e-5; f32 sums over all
edges (weight, bias, node and BN-parameter gradients, the env cotangent's
d-term sums) 1e-4; 2e-2 where bf16 rounding is involved. K6's plain version
runs at the JAX package's 512-edge windows, fed the same window
cotangents; the whole op and the model run at the port's 64-edge tiles,
since their results do not depend on the tiling beyond f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cartnet_tpu.models.cartnet as jcm
import cartnet_tpu.ops.pallas.edge_kernels as jek
from cartnet_tpu.config import Config as JConfig
from cartnet_tpu.config import DataConfig as JDataConfig
from cartnet_tpu.config import ModelConfig as JModelConfig
from cartnet_tpu.config import OptimConfig as JOptimConfig
from cartnet_tpu.data.batching import bandwidth_reorder as jreorder
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.data.synthetic import synthetic_dataset as jsynthetic
from cartnet_tpu.ops.pallas.edge_kernels import T_EDGES
from cartnet_tpu.train import loop as jloop
from cartnet_tpu.train import schedule as jsched
from cartnet_tpu_torch import cli
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.interop import params_from_jax
from cartnet_tpu_torch.models.cartnet import CartNet
from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
from cartnet_tpu_torch.ops.kernels import segment_kernels as sk
from cartnet_tpu_torch.train import loop, schedule

D, RBF, L, G = 128, 16, 2, 3
TOL = {"f32": 1e-5, "sum": 1e-4, "bf16": 2e-2}
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


def _rel(ours, ref, scale=None):
    a, b = _np(ours), _np(ref).reshape(_np(ours).shape)
    scale = np.abs(b).max() if scale is None else scale
    return float(np.abs(a - b).max() / max(scale, 1e-30))


@pytest.fixture(scope="module")
def data():
    """One batch collated by both packages (identical arrays; the JAX one
    carries the Pallas window plans) and random operands at its shapes."""
    recs = [jreorder(r) for r in
            jsynthetic(G, mean_atoms=60, radius=5.0, adp=True, seed=5)]
    n = -(-sum(len(r["z"]) for r in recs) // 128) * 128
    e = sum(-(-len(r["edge_src"]) // T_EDGES) * T_EDGES for r in recs)
    jb = jcollate(recs, n, e, G, edge_align=T_EDGES)
    assert jb.edge_fuse_ok and jb.pallas_seg_ok
    tb = collate(recs, n, e, G, edge_align=T_EDGES).to("cpu")
    assert np.array_equal(tb.edge_dst.numpy(), jb.edge_dst)
    rng = np.random.default_rng(17)
    E, N = e, n
    nt = E // T_EDGES
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)
    m = jb.edge_mask[:, None]
    vals = dict(xi=mk(N, 2 * D), xj=mk(N, 2 * D), e=mk(E, D),
                we=mk(D, 2 * D), b=mk(2 * D), w1g=mk(D, D) * 0.5, b1g=mk(D),
                w1a=mk(D, D) * 0.5, b1a=mk(D),
                gamma=(1.0 + 0.1 * rng.normal(size=D)).astype(np.float32),
                beta=(0.1 * rng.normal(size=D)).astype(np.float32),
                env=rng.uniform(0.2, 1.0, (E, 1)).astype(np.float32),
                scale=(1.0 + 0.1 * rng.normal(size=D)).astype(np.float32),
                shift=mk(D), ds1w=mk(nt, D) * 0.01, dm2w=mk(nt, D) * 0.01,
                deout=mk(E, D) * m, daggr=mk(N, D))
    return jb, tb, vals


def _jidx(jb):
    return (jnp.asarray(jb.edge_dst), jnp.asarray(jb.edge_src),
            jnp.asarray(jb.edge_mask), jnp.asarray(jb.edge_dst_lo),
            jnp.asarray(jb.edge_src_lo), jnp.asarray(jb.edge_src_nblk))


def _tidx(tb):
    return (tb.edge_dst, tb.edge_src, tb.edge_mask, tb.dst_rowptr,
            tb.edge_src_perm, tb.src_rowptr)


# ------------------------------------------------- K1's pre-only residual

@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_pre_only_residual_matches_pallas_saved_false(data, case):
    jb, tb, v = data
    p = {k: _pair(v[k], _jdt(case)) for k in PRIMALS}
    ref = jek.edge_phase_fwd(*(p[k][0] for k in PRIMALS), *_jidx(jb),
                             c_src=jb.src_band, interpret=True, saved=False)
    tin = [p[k][1] for k in PRIMALS]
    ours = ek.edge_phase_fwd_plain(*tin, *_tidx(tb)[:3], saved=True,
                                   pre_only=True, moments=True, tile=T_EDGES)
    full = ek.edge_phase_fwd_plain(*tin, *_tidx(tb)[:3], saved=True,
                                   moments=True, tile=T_EDGES)
    assert ours[2].shape == (tb.num_edges, 2 * D)
    assert ours[2].dtype == _tdt(case)
    m = jb.edge_mask
    tol = TOL["f32" if case == "f32" else "bf16"]
    for name, a, r in zip(("gate", "sender", "pre"), ours[:3], ref[:3]):
        assert _rel(_np(a)[m], _np(r)[m]) <= tol, name
    # the layout changes nothing else: gate, sender and moments are the
    # [pre ‖ sig] run's, and pre is its first half
    for a, b in zip(ours[:2] + ours[3:], full[:2] + full[3:]):
        assert torch.equal(a, b)
    assert torch.equal(ours[2], full[2][:, :2 * D])


# ---------------------------------------------------------------- K6

@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_merged_bwd_plain_matches_pallas(data, case):
    """K6's plain version at the JAX package's 512-edge windows vs
    _merged_bwd_call in interpret mode, on the same residual, gate, sender
    and window cotangents."""
    jb, tb, v = data
    jdt = _jdt(case)
    p = {k: _pair(v[k], jdt) for k in PRIMALS + ("env", "deout", "daggr")}
    dst, src, emask = _tidx(tb)[:3]
    tin = [p[k][1] for k in PRIMALS]
    gate, sender, pre, s1w, _ = ek.edge_phase_fwd_plain(
        *tin, dst, src, emask, saved=True, pre_only=True, moments=True,
        tile=T_EDGES)
    n_w = emask.reshape(-1, T_EDGES).sum(dim=1, dtype=torch.float32)[:, None]
    meanw = s1w / torch.clamp(n_w, min=1.0)
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
        tol = TOL["bf16"] if case == "bf16" else TOL[
            "f32" if name == "de" else "sum"]
        assert _rel(a, r) <= tol, (name, _rel(a, r))


# ------------------------------------------------- the merged Function

def _fes_jax(jb, p, cts):
    """Outputs and input gradients of the JAX package's merged op."""
    jp = [p[k][0] for k in PRIMALS + ("gamma", "beta")]
    env = p["env"][0]
    dst, src, emask, dlo, slo, nblk = _jidx(jb)
    f = lambda *a: jek.fused_edge_sigma(
        *a, dst, src, emask, dlo, slo, nblk, jb.src_band, jek.C_DST, 1e-5,
        (), True)
    out, vjp = jax.vjp(f, *jp, env)
    return out, vjp((cts[0].astype(out[0].dtype), cts[1].astype(out[1].dtype),
                     jnp.zeros_like(out[2]), jnp.zeros_like(out[3]),
                     jnp.zeros_like(out[4])))


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_fused_edge_sigma_matches_jax_vjp(data, case, monkeypatch):
    monkeypatch.setenv("CARTNET_MERGED", "1")
    jb, tb, v = data
    jdt = _jdt(case)
    names = PRIMALS + ("gamma", "beta", "env")
    p = {k: _pair(v[k], jdt) for k in names}
    cts = (jnp.asarray(v["deout"]), jnp.asarray(v["daggr"]))
    jout, jgrads = _fes_jax(jb, p, cts)
    tin = [p[k][1].requires_grad_() for k in names]
    out = ek.FusedEdgeSigma.apply(*tin, *_tidx(tb), 1e-5)
    assert not any(o.requires_grad for o in out[2:])
    loss = ((out[0].float() * torch.tensor(v["deout"])).sum()
            + (out[1].float() * torch.tensor(v["daggr"])).sum())
    grads = torch.autograd.grad(loss, tin)
    m = jb.edge_mask
    tol = TOL["f32" if case == "f32" else "bf16"]
    assert _rel(_np(out[0])[m], _np(jout[0])[m]) <= tol, "e_out"
    assert _rel(out[1], jout[1]) <= tol, "aggr"
    for name, a, r in zip(("mean", "var", "n"), out[2:], jout[2:]):
        assert a.dtype == torch.float32
        assert _rel(a, r) <= TOL["sum"], name
    for name, a, r in zip(names, grads, jgrads):
        assert a.dtype == p[name][1].dtype, name
        gtol = TOL["bf16"] if case == "bf16" else (
            TOL["f32"] if name == "e" else TOL["sum"])
        # BN removes a constant shift of the gate, so b1g's true gradient
        # cancels to rounding noise: hold it to the size of its summands,
        # which is that of W1g's gradient
        scale = float(np.abs(_np(jgrads[5])).max()) if name == "b1g" \
            else None
        assert _rel(a, r, scale) <= gtol, (name, _rel(a, r, scale))


# --------------------------------------------------- the model micro-step

def _cfgs(case, n=0, e=0):
    jcfg = JConfig(model=JModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                                      cholesky=True,
                                      compute_dtype=_jdt(case)),
                   data=JDataConfig(max_nodes=n, max_edges=e, max_graphs=G),
                   optim=JOptimConfig(lr=1e-3, batch_accumulation=1))
    tcfg = Config(model=ModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                                    cholesky=True, compute_dtype=_tdt(case)),
                  optim=OptimConfig(lr=1e-3, batch_accumulation=1))
    return jcfg, tcfg


def _jax_micro(jb, case):
    """One JAX micro-step through the merged op (K1/K2/K6 in interpret
    mode) -> (initial params, bn state, stats, gradients)."""
    jcfg, _ = _cfgs(case, len(jb.z), len(jb.edge_dst))
    opt = jsched.make_optimizer(1e-3, 4, 0.1)
    state = jloop.init_train_state(jax.random.key(3), jcfg, jcm.cartnet_init,
                                   opt)
    init = (jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.bn_state))
    calls = {"k6": 0}
    orig = jek._merged_bwd_call

    def spy(*a, **k):
        calls["k6"] += 1
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcm, "_FORCE_SIGMA_INTERPRET", True)
        mp.setenv("CARTNET_MERGED", "1")
        mp.setattr(jek, "_merged_bwd_call", spy)
        state, stats = jloop.make_steps(jcfg, jcm.cartnet_apply, opt)[0](
            state, jb)
    assert calls["k6"] == L, "the JAX merged kernel must run"
    return init, stats, (jax.tree.map(np.asarray, state.grad_accum),
                         jax.tree.map(np.asarray, state.bn_state))


@pytest.fixture(scope="module")
def jax_steps(data):
    jb, _, _ = data
    return {case: _jax_micro(jb, case) for case in ("f32", "bf16")}


def _port_micro(tcfg, init, tb, merged: bool):
    """One port micro-step from the JAX initial weights, counting the
    training backward kernels' wrapper calls -> (stats, grads by name,
    buffers by name, calls)."""
    model = CartNet(tcfg.model, device="cpu")
    model.load_state_dict(params_from_jax(*init, tcfg.model), strict=True)
    opt = schedule.make_optimizer(model.parameters(), 1e-3, 4, 0.1)
    calls = dict(k4=0, k5=0, k6=0)

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CARTNET_MERGED", "1" if merged else "0")
        mp.setattr(sk, "sigma_segsum_bwd", count("k4", sk.sigma_segsum_bwd))
        mp.setattr(ek, "edge_phase_bwd", count("k5", ek.edge_phase_bwd))
        mp.setattr(ek, "merged_bwd", count("k6", ek.merged_bwd))
        state, stats = loop.make_steps(tcfg)[0](
            loop.init_train_state(model, opt), tb)
    names = [n for n, _ in model.named_parameters()]
    return (stats, dict(zip(names, state.grad_accum)),
            dict(model.named_buffers()), calls)


def _bn_shift_cancelled(name):
    """MLP_gate's last bias shifts the gate by a constant, which train BN
    removes: its true gradient is rounding noise of terms as large as W1g's
    gradient (tests/test_torch_port_train.py)."""
    return name.endswith("MLP_gate.2.bias")


def _grad_rel(name, g, ref):
    scale = (np.abs(_np(ref[name.replace("2.bias", "2.weight")])).max()
             if _bn_shift_cancelled(name) else None)
    return _rel(g, ref[name], scale)


def _layer_rel(grads, ref):
    """max |g - ref| of each gradient over the largest reference entry of
    its layer (encoder, layers.i, head), chip_smoke.py's normalization."""
    group = lambda n: ".".join(n.split(".")[:2 if n.startswith("layers")
                                               else 1])
    scale = {}
    for n in grads:
        scale[group(n)] = max(scale.get(group(n), 0.0),
                              float(np.abs(_np(ref[n])).max()))
    return {n: float(np.abs(_np(g) - _np(ref[n])).max())
            / max(scale[group(n)], 1e-30) for n, g in grads.items()}


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_merged_micro_step_matches_jax_make_steps(data, jax_steps, case):
    """f32: loss 1e-5 relative, gradients 5e-4 normalized per layer, BN
    stats 1e-5. At this width the layer-0 gate gradients of every f32 step
    (the JAX package's XLA and Pallas paths included) differ from a float64
    step by more than 5e-4 of their own largest entry, since train BN's
    backward cancels; per layer, as chip_smoke.py normalizes, the f32 steps
    agree. bf16: loss 1e-2, BN stats 2e-2, and each gradient within twice
    the JAX package's own bf16 error (plus 2e-2) of the JAX f32 gradient,
    as tests/test_torch_port_train.py holds the default path."""
    jb, tb, _ = data
    _, tcfg = _cfgs(case)
    init, jstats, (jgrads, jbn) = jax_steps[case]
    stats, grads, bufs, calls = _port_micro(tcfg, init, tb, merged=True)
    assert calls == dict(k4=0, k5=0, k6=L)
    f32 = case == "f32"
    ref = params_from_jax(jgrads, jbn, tcfg.model)
    ref32 = params_from_jax(*jax_steps["f32"][2], tcfg.model)
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-5 if f32 else 1e-2)
    per_layer = _layer_rel(grads, ref)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        if f32:
            assert per_layer[name] <= 5e-4, (name, per_layer[name])
        else:
            own = _grad_rel(name, ref[name], ref32)
            assert _grad_rel(name, g, ref32) <= 2 * own + 2e-2, (name, own)
    for name, buf in bufs.items():
        if name.endswith("num_batches_tracked"):
            assert int(buf) == int(ref[name]) == 1, name
        else:
            assert _rel(buf, ref[name]) <= (1e-5 if f32 else 2e-2), name


@pytest.fixture(scope="module")
def port_steps(data, jax_steps):
    """The port's f32 micro-step from the same weights, default and merged."""
    _, tb, _ = data
    _, tcfg = _cfgs("f32")
    init = jax_steps["f32"][0]
    return {merged: _port_micro(tcfg, init, tb, merged)
            for merged in (False, True)}


def test_merged_matches_default_path(port_steps):
    """The forward is the same computation (only K1's residual layout
    differs): loss and BN running stats bitwise equal. The gradients differ
    by f32 summation order only (dg rounded once instead of twice is exact
    in f32): 1e-4 per layer."""
    (s0, g0, b0, _), (s1, g1, b1, _) = port_steps[False], port_steps[True]
    assert torch.equal(s0["loss"], s1["loss"])
    for name in b0:
        assert torch.equal(b0[name], b1[name]), name
    for name, err in _layer_rel(g1, g0).items():
        assert err <= 1e-4, (name, err)


def test_merged_path_runs_k6_once_per_layer(port_steps):
    assert port_steps[False][3] == dict(k4=L, k5=L, k6=0)
    assert port_steps[True][3] == dict(k4=0, k5=0, k6=L)


def test_cli_trains_merged_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CARTNET_MERGED", "1")
    calls = {"k6": 0}
    orig = ek.merged_bwd

    def spy(*a, **k):
        calls["k6"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(ek, "merged_bwd", spy)
    state, test = cli.main(["--device", "cpu", "--dataset", "synthetic", "--cholesky",
                            "--limit", "8", "--epochs", "1",
                            "--batch_accumulation", "2", "--dim_in", "128",
                            "--num_layers", "2"])
    assert state.step == 1 and int(state.bad_steps) == 0
    assert calls["k6"] == 2 * 2  # 2 micro-steps x 2 layers
    assert np.isfinite(test["MAE"]) and 0.0 <= test["iou"] <= 1.0


# ------------------------ K6 with separate dst and src row counts

def _fes_plain(tin, idx, eps):
    """``FusedEdgeSigma``'s forward from plain parts, for autograd: K1's
    plain version with moments, the window-moment merge, K2's plain
    version."""
    xi, xj, e, we, b, w1g, b1g, w1a, b1a, gamma, beta, env = tin
    dst, src, emask, rowptr = idx[:4]
    gate, sender, _, s1w, m2w = ek.edge_phase_fwd_plain(
        xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask, moments=True)
    n_w = emask.reshape(s1w.shape[0], -1).sum(dim=1,
                                              dtype=torch.float32)[:, None]
    from cartnet_tpu_torch.nn.norm import combine_window_moments
    (scale, shift), _ = combine_window_moments(gamma, beta, s1w, m2w, n_w,
                                               eps)
    return sk.sigma_segsum_plain(gate, scale.float(), shift.float(), env,
                                 sender, e, dst, emask, xi.shape[0])


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_fused_edge_sigma_two_row_counts(data, case):
    """``FusedEdgeSigma`` (K6's plain version) with xj over N + 128 rows,
    a received row for every other real edge's src and the src plan over
    the longer table: dxi has N rows, dxj N + 128, and every gradient
    agrees with autograd through the plain forward."""
    _, tb, v = data
    N, n_recv = tb.num_nodes, 128
    rng = np.random.default_rng(18)
    src = tb.edge_src.numpy().astype(np.int64).copy()
    moved = tb.edge_mask.numpy() & (np.arange(len(src)) % 2 == 1)
    src[moved] = N + src[moved] % n_recv
    perm = np.argsort(src, kind="stable")
    srowptr = np.searchsorted(src[perm], np.arange(N + n_recv + 1), "left")
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))
    idx = (tb.edge_dst, i32(src), tb.edge_mask, tb.dst_rowptr, i32(perm),
           i32(srowptr))
    vals = dict(v, xj=np.concatenate([v["xj"], (rng.normal(
        size=(n_recv, 2 * D)) * 0.3).astype(np.float32)]))
    dt = _jdt(case)
    names = PRIMALS + ("gamma", "beta", "env")
    grads = []
    for fused in (True, False):
        tin = [_pair(vals[k], dt)[1].requires_grad_() for k in names]
        out = (ek.FusedEdgeSigma.apply(*tin, *idx, 1e-5) if fused
               else _fes_plain(tin, idx, 1e-5))
        loss = ((out[0].float() * torch.tensor(v["deout"])).sum()
                + (out[1].float() * torch.tensor(v["daggr"])).sum())
        grads.append(torch.autograd.grad(loss, tin))
    assert grads[0][0].shape == (N, 2 * D)
    assert grads[0][1].shape == (N + n_recv, 2 * D)
    for name, a, r in zip(names, *grads):
        assert a.dtype == r.dtype, name
        gtol = TOL["bf16"] if case == "bf16" else (
            TOL["f32"] if name == "e" else TOL["sum"])
        scale = float(np.abs(_np(grads[1][5])).max()) if name == "b1g" \
            else None
        assert _rel(a, r, scale) <= gtol, (name, _rel(a, r, scale))
