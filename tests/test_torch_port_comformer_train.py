"""The port's eComformer training path vs the JAX package: the train-mode
conv and equivariant block (outputs, BN running stats, gradients of inputs
and parameters), one micro-step of the whole model against JAX
``make_steps`` with ``ecomformer_apply`` (loss, every parameter gradient, BN
running stats), gradient accumulation with the epoch-end flush, and the CLI.

Dim 64 with the published irreps (64x0e + 8x1o + 8x2e) and Cholesky head, on
the small batches of tests/test_torch_port_train.py (two crystals of ~10
atoms each, padded to 64 nodes and 4096 edges). The JAX package takes its
XLA paths on the CPU; the port its kernels' plain versions through the
autograd Functions (K1/K5, K2/K4, K7/K8, K3 and the sorted gather). Weights
and gradients move across with ``ecomformer_params_from_jax``.

Tolerances, normalized by the reference's largest magnitude: f32 outputs
1e-4 and loss 1e-5 relative, gradients 5e-4 (train BN's backward cancels and
amplifies f32 summation-order differences), BN stats 1e-5. bf16: the two
packages round at different places (XLA adds and reduces in bf16 where the
port's kernels sum in f32 and round once), so the loss is held to 1e-2 and
BN stats to 2e-2 of JAX bf16, and each gradient to twice JAX's own bf16
distance from the f32 gradient plus 2e-2.
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
from cartnet_tpu.data.synthetic import synthetic_dataset as jsynthetic
from cartnet_tpu.models import comformer as JC
from cartnet_tpu.models import equivariant as JE
from cartnet_tpu.train import loop as jloop
from cartnet_tpu.train import schedule as jsched
from cartnet_tpu_torch import cli
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.interop import ecomformer_params_from_jax
from cartnet_tpu_torch.models.comformer import EComformer, IComformer
from cartnet_tpu_torch.nn.core import Params, cast_params
from cartnet_tpu_torch.train import loop, schedule

D = 64
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


def _cfgs(case, accum=1):
    jdt, tdt = _dts(case)
    jcfg = JConfig(model=JModelConfig(name="ecomformer", dim_in=D,
                                      cholesky=True, compute_dtype=jdt),
                   optim=JOptimConfig(lr=LR, batch_accumulation=accum))
    tcfg = Config(model=ModelConfig(name="ecomformer", dim_in=D,
                                    cholesky=True, compute_dtype=tdt),
                  optim=OptimConfig(lr=LR, batch_accumulation=accum))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def batches():
    recs = jsynthetic(8, mean_atoms=10, radius=5.0, adp=True, seed=21)
    groups = [recs[i * 2:(i + 1) * 2] for i in range(4)]
    return ([jax.tree.map(jnp.asarray, jcollate(g, 64, 4096, 2))
             for g in groups],
            [collate(g, 64, 4096, 2) for g in groups])


def _jax_state(jcfg, steps=STEPS):
    opt = jsched.make_optimizer(LR, steps, PCT)
    return opt, jloop.init_train_state(jax.random.key(3), jcfg,
                                       JC.ecomformer_init, opt)


def _to_port(tree, bn_state, tcfg):
    return ecomformer_params_from_jax(jax.tree.map(np.asarray, tree),
                                      jax.tree.map(np.asarray, bn_state),
                                      tcfg.model)


def _port_model(tcfg, jstate):
    model = EComformer(tcfg.model, device="cpu", seed=9)
    model.load_state_dict(_to_port(jstate.params, jstate.bn_state, tcfg),
                          strict=True)
    return model


def _cancelled(name):
    """lin_concate's bias shifts the conv output by a constant that the node
    BN removes: its true gradient is zero and what both packages return is
    rounding noise of terms as large as the weight's gradient."""
    return name.endswith("lin_concate.bias")


def _grad_err(name, g, ref):
    scale = (np.abs(_np(ref[name.replace("bias", "weight")])).max()
             if _cancelled(name) else None)
    return _rel(g, ref[name], scale)


# ------------------------------------------------------- conv and block

@pytest.mark.parametrize("module", ["conv0", "equi"])
def test_train_module_matches_jax(batches, module):
    """f32: the train-mode conv (conv0) and equivariant block against the
    JAX package's ``conv_apply`` / ``equi_block_apply`` with training=True
    under one random cotangent: output, BN running stats, and the
    gradients of x, the edge features and every parameter."""
    jb, tb = batches
    jcfg, tcfg = _cfgs("f32")
    _, jstate = _jax_state(jcfg)
    params, state = jstate.params, jstate.bn_state
    rng = np.random.default_rng(4)
    N, E = tb[0].num_nodes, tb[0].num_edges
    x = rng.normal(size=(N, D)).astype(np.float32)
    e = np.abs(rng.normal(size=(E, D))).astype(np.float32)
    ct = rng.normal(size=(N, D)).astype(np.float32)
    apply = JC.conv_apply if module == "conv0" else JE.equi_block_apply

    def jf(p, x_, e_):
        y, s = apply(p, state[module], x_, e_, jb[0], jcfg.model, True)
        return (y * ct).sum(), (y, s)

    (_, (jy, js)), (gp, gx, ge) = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(params[module], jnp.asarray(x),
                                             jnp.asarray(e))
    g_full = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, params))
    g_full[module] = jax.tree.map(np.asarray, gp)
    bn_full = jax.tree.map(np.asarray, state)
    bn_full[module] = jax.tree.map(np.asarray, js)
    ref = _to_port(g_full, bn_full, tcfg)

    model = _port_model(tcfg, jstate)
    model.train()
    tx = torch.tensor(x).requires_grad_()
    te = torch.tensor(e).requires_grad_()
    p = Params(cast_params(model, torch.float32, torch.float32))
    sub = getattr(model, module)
    y = sub(tx, te, tb[0].to("cpu"), p.sub(module))
    assert y.dtype == torch.float32
    assert _rel(y, jy) <= 1e-4
    names = [n for n, _ in sub.named_parameters()]
    grads = torch.autograd.grad((y * torch.tensor(ct)).sum(),
                                [tx, te] + [q for _, q in
                                            sub.named_parameters()])
    assert _rel(grads[0], gx) <= 5e-4 and _rel(grads[1], ge) <= 5e-4
    for n, g in zip(names, grads[2:]):
        assert _grad_err(f"{module}.{n}", g, ref) <= 5e-4, n
    for n, buf in sub.named_buffers():
        want = ref[f"{module}.{n}"]
        if n.endswith("num_batches_tracked"):
            assert int(buf) == int(want) == 1, n
        else:
            assert _rel(buf, want) <= 1e-5, n


# ------------------------------------------------------------ micro-step

def _jax_micro(case, batch):
    jcfg, tcfg = _cfgs(case)
    opt, jstate = _jax_state(jcfg)
    model = _port_model(tcfg, jstate)
    jstate, jstats = jloop.make_steps(jcfg, JC.ecomformer_apply, opt)[0](
        jstate, batch)
    return tcfg, model, jstats, _to_port(jstate.grad_accum, jstate.bn_state,
                                         tcfg)


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_micro_step_matches_jax_make_steps(batches, case):
    jb, tb = batches
    tcfg, model, jstats, ref = _jax_micro(case, jb[0])
    opt = schedule.make_optimizer(model.parameters(), LR, STEPS, PCT)
    state, stats = loop.make_steps(tcfg)[0](
        loop.init_train_state(model, opt), tb[0].to("cpu"))
    f32 = case == "f32"
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-5 if f32 else 1e-2)
    ref32 = ref if f32 else _jax_micro("f32", jb[0])[3]
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(state.grad_accum)
    for name, g in zip(names, state.grad_accum):
        assert g.dtype == torch.float32, name
        if f32:
            assert _grad_err(name, g, ref) <= 5e-4, (name,
                                                     _grad_err(name, g, ref))
        else:
            own = _grad_err(name, ref[name], ref32)
            assert _grad_err(name, g, ref32) <= 2 * own + 2e-2, (name, own)
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert int(buf) == int(ref[name]) == 1, name
        else:
            assert _rel(buf, ref[name]) <= (1e-5 if f32 else 2e-2), name
    assert int(state.accum_count) == 1 and int(state.bad_steps) == 0


def test_accumulation_with_epoch_end_flush_matches_jax(batches):
    """3 micro-batches with batch_accumulation 2: an update after the
    second and the epoch-end flush after the third, as in JAX (two steps).
    The first update's summed gradients within 5e-4 of JAX's and the
    parameters and BN state after it within 1e-4. Adam moves an element
    whose gradient is at rounding level by ~lr in a direction the rounding
    picks (~13% of conv0.lin_query.weight is below 1e-4 of its largest
    entry), so elements with a gradient under 1e-3 of their tensor's
    largest are held to two Adam steps instead, and the trajectories part
    after it: the flush is checked against the port's own micro-step on
    the third batch from the weights after the first update (the same sum,
    bitwise)."""
    jb, tb = batches
    jcfg, tcfg = _cfgs("f32", accum=2)
    opt, jstate = _jax_state(jcfg, steps=4)
    model = _port_model(tcfg, jstate)
    jmicro, jupdate, _ = jloop.make_steps(jcfg, JC.ecomformer_apply, opt)
    jseen, seen = [], []

    def jupdate_seen(st):
        g = _to_port(st.grad_accum, st.bn_state, tcfg)
        st = jupdate(st)
        jseen.append((g, _to_port(st.params, st.bn_state, tcfg)))
        return st

    jstate = jloop.train_epoch(jstate, jb[:3], jmicro, jupdate_seen, 2)
    state = loop.init_train_state(
        model, schedule.make_optimizer(model.parameters(), LR, 4, PCT))
    micro, update, _ = loop.make_steps(tcfg)

    def update_seen(st):
        g = [a.clone() for a in st.grad_accum]
        st = update(st)
        seen.append((g, {k: v.clone() for k, v in
                         st.model.state_dict().items()}))
        return st

    state, rows = loop.train_epoch(state, tb[:3], micro, update_seen, 2,
                                   device="cpu")
    assert state.step == int(jstate.step) == 2 and len(rows) == 3
    assert len(seen) == len(jseen) == 2
    assert all(int(g.abs().max()) == 0 for g in state.grad_accum)
    names = [n for n, _ in model.named_parameters()]
    (grads, sd1), (jgrads, jsd1) = seen[0], jseen[0]
    tiny = {}
    for name, g in zip(names, grads):
        assert _grad_err(name, g, jgrads) <= 5e-4, name
        r = np.abs(_np(jgrads[name]))
        tiny[name] = (r < 1e-3 * r.max()) | _cancelled(name)
    for name, t in sd1.items():
        diff = np.abs(_np(t) - _np(jsd1[name]))
        scale = max(np.abs(_np(jsd1[name])).max(), 1e-30)
        if name in tiny:
            assert diff[tiny[name]].max(initial=0.0) <= 2 * 2 * LR, name
            diff = diff[~tiny[name]]
        assert diff.max(initial=0.0) <= 1e-4 * scale, name
    model.load_state_dict(sd1)
    opt2 = schedule.make_optimizer(model.parameters(), LR, 4, PCT)
    fresh, _ = micro(loop.init_train_state(model, opt2), tb[2].to("cpu"))
    for name, a, b in zip(names, seen[1][0], fresh.grad_accum):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_gather_pad_cotangents_are_zero(batches, monkeypatch, case):
    """The five node-to-edge gathers of a micro-step (q in each conv,
    s_node and cat1 in the block) receive cotangents that are exactly zero
    on pad edges, so ``gather_sorted``'s backward may leave the pads out
    where the JAX package sums every edge."""
    from cartnet_tpu_torch.models import comformer as tcm
    from cartnet_tpu_torch.models import equivariant as teq
    from cartnet_tpu_torch.ops import segment as tseg
    _, tb = batches
    jcfg, tcfg = _cfgs(case)
    _, jstate = _jax_state(jcfg)
    model = _port_model(tcfg, jstate)
    seen = []

    def hooked(values, idx, rowptr, mask):
        out = tseg.gather_sorted(values, idx, rowptr, mask)
        out.register_hook(lambda ct: seen.append((ct.clone(), mask)))
        return out

    monkeypatch.setattr(tcm, "gather_sorted", hooked)
    monkeypatch.setattr(teq, "gather_sorted", hooked)
    batch = tb[0].to("cpu")
    assert (~batch.edge_mask).any()
    opt = schedule.make_optimizer(model.parameters(), LR, STEPS, PCT)
    loop.make_steps(tcfg)[0](loop.init_train_state(model, opt), batch)
    assert len(seen) == 5
    for ct, mask in seen:
        assert ct[mask].abs().max() > 0
        assert not ct[~mask].any()


def test_cli_trains_ecomformer_on_cpu(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    caplog.set_level("INFO")
    state, test = cli.main(["--device", "cpu", "--dataset", "synthetic", "--cholesky",
                            "--limit", "8", "--epochs", "1",
                            "--batch_accumulation", "2", "--model",
                            "eComformer", "--dim_in", str(D)])
    assert isinstance(state.model, EComformer)
    assert state.step == 1 and int(state.bad_steps) == 0
    assert np.isfinite(test["MAE"]) and 0.0 <= test["iou"] <= 1.0
    assert "model ecomformer" in caplog.text
    # the iComformer, which raised here until it was ported, trains too
    istate, itest = cli.main(["--device", "cpu", "--dataset", "synthetic",
                              "--limit", "8", "--epochs", "1", "--model",
                              "iComformer", "--dim_in", str(D)])
    assert isinstance(istate.model, IComformer) and istate.step == 1
    assert int(istate.bad_steps) == 0 and np.isfinite(itest["MAE"])
    assert "model icomformer" in caplog.text
