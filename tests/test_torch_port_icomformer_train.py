"""The port's iComformer training path vs the JAX package: the train-mode
edge update (output, BN running stats, gradients of its inputs and
parameters), one micro-step of the whole model against JAX ``make_steps``
with ``icomformer_apply`` (loss, every parameter gradient, BN running
stats), the pad-edge cotangents at the q gathers, and the CLI.

Dim 128, Cholesky head, on one batch of two crystals of ~48 atoms collated
alike on both sides (no edge alignment). The JAX package takes its XLA
paths on the CPU; the port its kernels' plain versions through the
autograd Functions (K1/K5, K2/K4, K3 under the sorted gather). Weights and
gradients move across with ``icomformer_params_from_jax``.

Tolerances, normalized by the reference's largest magnitude: f32 outputs
1e-4, loss 1e-5 relative, BN stats 1e-5; f32 gradients 5e-4, each held
against the largest gradient entry of its layer (conv0..conv3,
edge_update, the heads): at d = 128 train BN's backward cancels and
amplifies f32 summation-order differences in a few small gradients of
every layer (as in the CartNet tests at this width). bf16 as in the
eComformer's tests: loss 1e-2 and BN stats 2e-2 of JAX bf16; the
gradients within twice JAX's own bf16 distance from the f32 gradients
plus 2e-2, each distance taken over a whole layer (over the norm of its
f32 gradients, as ``chip_smoke.bf16_grad_gate`` groups them): both
packages' bf16 gradients sit 2-40% of a layer's norm from the f32 ones,
and a scalar such as rbf_gamma, a sum of that noise over every edge of
two heads, lands anywhere within it (2.4% for JAX, 8% for the port on
this batch, on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu.config import Config as JConfig
from cartnet_tpu.config import ModelConfig as JModelConfig
from cartnet_tpu.config import OptimConfig as JOptimConfig
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.models import comformer as JC
from cartnet_tpu.train import loop as jloop
from cartnet_tpu.train import schedule as jsched
from cartnet_tpu_torch import cli
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.interop import icomformer_params_from_jax
from cartnet_tpu_torch.models.comformer import IComformer
from cartnet_tpu_torch.nn.core import Params, cast_params
from cartnet_tpu_torch.train import loop, schedule

D = 128
LR, PCT, STEPS = 3e-4, 0.1, 50


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b, scale=None):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(b).max() if scale is None else scale
    return float(np.abs(a - b).max() / max(scale, 1e-30))


def _dts(case):
    return ((jnp.bfloat16, torch.bfloat16) if case == "bf16"
            else (jnp.float32, torch.float32))


def _cfgs(case):
    jdt, tdt = _dts(case)
    jcfg = JConfig(model=JModelConfig(name="icomformer", dim_in=D,
                                      cholesky=True, compute_dtype=jdt),
                   optim=JOptimConfig(lr=LR))
    tcfg = Config(model=ModelConfig(name="icomformer", dim_in=D,
                                    cholesky=True, compute_dtype=tdt),
                  optim=OptimConfig(lr=LR))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def batches():
    recs = synthetic_dataset(2, mean_atoms=48, adp=True, seed=21)
    nodes = -(-sum(len(r["z"]) for r in recs) // 128) * 128
    edges = -(-sum(len(r["edge_src"]) for r in recs) // 512) * 512
    tb = collate(recs, nodes, edges, 2)
    assert (~tb.edge_mask).any() and (~tb.node_mask).any()
    return (jax.tree.map(jnp.asarray, jcollate(recs, nodes, edges, 2)),
            tb.to("cpu"))


def _jax_state():
    """A fresh JAX train state (``make_steps`` donates its buffers)."""
    jcfg, _ = _cfgs("f32")
    opt = jsched.make_optimizer(LR, STEPS, PCT)
    return opt, jloop.init_train_state(jax.random.key(3), jcfg,
                                       JC.icomformer_init, opt)


def _to_port(tree, bn_state, tcfg):
    return icomformer_params_from_jax(jax.tree.map(np.asarray, tree),
                                      jax.tree.map(np.asarray, bn_state),
                                      tcfg.model)


def _port_model(tcfg, jstate):
    model = IComformer(tcfg.model, device="cpu", seed=9)
    model.load_state_dict(_to_port(jstate.params, jstate.bn_state, tcfg),
                          strict=True)
    return model


def _group(name):
    """The layer of a parameter; the RBF heads' centers and gamma join
    their heads."""
    head = name.split(".")[0]
    return {"rbf_centers": "rbf", "rbf_gamma": "rbf",
            "rbfa_centers": "rbf_angle", "rbfa_gamma": "rbf_angle"}.get(
                head, head)


def _group_dists(names, got, ref):
    """Per layer: the distance of ``got`` from ``ref`` over all of the
    layer's entries, over the norm of its ``ref`` entries."""
    acc = {}
    for n, g in zip(names, got):
        a, r = _np(g).astype(np.float64), _np(ref[n]).astype(np.float64)
        s = acc.setdefault(_group(n), [0.0, 0.0])
        s[0] += float(np.sum((a - r) ** 2))
        s[1] += float(np.sum(r * r))
    return {k: np.sqrt(d / max(n, 1e-300)) for k, (d, n) in acc.items()}


def _layer_errs(names, got, ref):
    """Each gradient's largest distance over its layer's largest entry."""
    scale = {}
    for n in names:
        g = _group(n)
        scale[g] = max(scale.get(g, 0.0), float(np.abs(_np(ref[n])).max()))
    return {n: _rel(t, ref[n], scale[_group(n)]) for n, t in zip(names, got)}


# --------------------------------------------------------- edge update

def test_train_edge_update_matches_jax(batches):
    """f32: the train-mode edge update against ``conv_edge_apply`` with
    training=True under one random cotangent: output, BN running stats,
    the gradients of its three inputs and of every parameter."""
    jb, tb = batches
    jcfg, tcfg = _cfgs("f32")
    _, jstate = _jax_state()
    params, state = jstate.params, jstate.bn_state
    rng = np.random.default_rng(4)
    E = tb.num_edges
    e, nl, na = (np.abs(rng.normal(size=s)).astype(np.float32)
                 for s in ((E, D), (3 * E, D), (3 * E, D)))
    ct = rng.normal(size=(E, D)).astype(np.float32)

    def jf(p, *ins):
        y, s = JC.conv_edge_apply(p, state["edge_update"], *ins,
                                  jb.edge_mask, jcfg.model, True)
        return (y * ct).sum(), (y, s)

    (_, (jy, js)), grads = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(
            params["edge_update"], *(jnp.asarray(a) for a in (e, nl, na)))
    g_full = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, params))
    g_full["edge_update"] = jax.tree.map(np.asarray, grads[0])
    bn_full = jax.tree.map(np.asarray, state)
    bn_full["edge_update"] = jax.tree.map(np.asarray, js)
    ref = _to_port(g_full, bn_full, tcfg)

    model = _port_model(tcfg, jstate)
    model.train()
    ins = [torch.tensor(a).requires_grad_() for a in (e, nl, na)]
    p = Params(cast_params(model, torch.float32, torch.float32))
    sub = model.edge_update
    y = sub(*ins, tb.edge_mask, p.sub("edge_update"))
    assert y.dtype == torch.float32
    assert _rel(y, jy) <= 1e-4
    names = [n for n, _ in sub.named_parameters()]
    got = torch.autograd.grad((y * torch.tensor(ct)).sum(),
                              ins + [q for _, q in sub.named_parameters()])
    for g, j in zip(got[:3], grads[1:]):
        assert _rel(g, j) <= 5e-4
    errs = _layer_errs([f"edge_update.{n}" for n in names], got[3:], ref)
    assert max(errs.values()) <= 5e-4, errs
    for n, buf in sub.named_buffers():
        want = ref[f"edge_update.{n}"]
        if n.endswith("num_batches_tracked"):
            assert int(buf) == int(want) == 1, n
        else:
            assert _rel(buf, want) <= 1e-5, n


# ------------------------------------------------------------ micro-step

def _jax_micro(case, batch):
    jcfg, tcfg = _cfgs(case)
    opt, jstate = _jax_state()
    model = _port_model(tcfg, jstate)
    jstate, jstats = jloop.make_steps(jcfg, JC.icomformer_apply, opt)[0](
        jstate, batch)
    return tcfg, model, jstats, _to_port(jstate.grad_accum, jstate.bn_state,
                                         tcfg)


@pytest.fixture(scope="module")
def jax_f32_micro(batches):
    return _jax_micro("f32", batches[0])


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_micro_step_matches_jax_make_steps(batches, jax_f32_micro, case):
    jb, tb = batches
    tcfg, model, jstats, ref = (jax_f32_micro if case == "f32"
                                else _jax_micro(case, jb))
    opt = schedule.make_optimizer(model.parameters(), LR, STEPS, PCT)
    state, stats = loop.make_steps(tcfg)[0](
        loop.init_train_state(model, opt), tb)
    f32 = case == "f32"
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-5 if f32 else 1e-2)
    ref32 = jax_f32_micro[3]
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(state.grad_accum)
    assert {"conv3.bn.weight", "edge_update.value_e3.weight",
            "rbf_angle.lin.weight", "rbfa_gamma"} <= set(names)
    if f32:
        errs = _layer_errs(names, state.grad_accum, ref)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 5e-4, (worst, errs[worst])
    assert all(g.dtype == torch.float32 for g in state.grad_accum)
    if not f32:
        own = _group_dists(names, [ref[n] for n in names], ref32)
        ours = _group_dists(names, state.grad_accum, ref32)
        for grp, dist in ours.items():
            assert dist <= 2 * own[grp] + 2e-2, (grp, dist, own[grp])
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert int(buf) == int(ref[name]) == 1, name
        else:
            assert _rel(buf, ref[name]) <= (1e-5 if f32 else 2e-2), name
    assert int(state.accum_count) == 1 and int(state.bad_steps) == 0


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_gather_pad_cotangents_are_zero(batches, monkeypatch, case):
    """The four q gathers of a micro-step (one a conv) receive cotangents
    that are exactly zero on pad edges, so ``gather_sorted``'s backward may
    leave the pads out where the JAX package sums every edge. The edge
    update mixes the edge features of the three lattice channels, but the
    q gathers' cotangents come from the conv's alpha alone, whose masked
    BN and aggregation see no pad edge."""
    from cartnet_tpu_torch.models import comformer as tcm
    from cartnet_tpu_torch.ops import segment as tseg
    _, tb = batches
    _, tcfg = _cfgs(case)
    model = _port_model(tcfg, _jax_state()[1])
    seen = []

    def hooked(values, idx, rowptr, mask):
        out = tseg.gather_sorted(values, idx, rowptr, mask)
        out.register_hook(lambda ct: seen.append((ct.clone(), mask)))
        return out

    monkeypatch.setattr(tcm, "gather_sorted", hooked)
    opt = schedule.make_optimizer(model.parameters(), LR, STEPS, PCT)
    loop.make_steps(tcfg)[0](loop.init_train_state(model, opt), tb)
    assert len(seen) == 4
    for ct, mask in seen:
        assert ct[mask].abs().max() > 0
        assert not ct[~mask].any()


def test_cli_trains_icomformer_on_cpu(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    caplog.set_level("INFO")
    state, test = cli.main(["--device", "cpu", "--dataset", "synthetic",
                            "--cholesky", "--limit", "8", "--epochs", "1",
                            "--batch_accumulation", "2", "--model",
                            "iComformer", "--dim_in", "64"])
    assert isinstance(state.model, IComformer)
    assert state.step == 1 and int(state.bad_steps) == 0
    assert np.isfinite(test["MAE"]) and 0.0 <= test["iou"] <= 1.0
    assert "model icomformer" in caplog.text
    bufs = loop.bn_buffers(state.model)
    assert len(bufs) == 3 * 10  # four convs and the edge update, 2 BNs each
    assert all(int(b) == 2 for b in bufs[2::3])  # two train micro-steps
