"""The port's training path vs the JAX package: train-mode BN, the OneCycle
schedules and Adam, the step guard, one micro-step of the whole model
(loss, every parameter gradient, BN running stats), a 50-step loss
trajectory against the committed golden file, gradient accumulation with
the epoch-end flush, and the CLI.

The model cases run at dim 32, 16 RBF, 2 layers with the flagship inputs
(temperature + atom types, Cholesky head) on the batches of
tests/test_train_parity.py. At dim 32 the JAX package takes its XLA path
(no Pallas kernel is active below dim 128), the port its kernels' plain
versions through the autograd Functions. Weights are the JAX package's,
moved across with ``params_from_jax``. Tolerances are stated per test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cartnet_tpu.config import Config as JConfig
from cartnet_tpu.config import DataConfig as JDataConfig
from cartnet_tpu.config import ModelConfig as JModelConfig
from cartnet_tpu.config import OptimConfig as JOptimConfig
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.data.synthetic import synthetic_dataset as jsynthetic
from cartnet_tpu.models import cartnet as M
from cartnet_tpu.nn import norm as jnorm
from cartnet_tpu.train import loop as jloop
from cartnet_tpu.train import schedule as jsched
from cartnet_tpu_torch import cli
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.interop import params_from_jax
from cartnet_tpu_torch.models.cartnet import CartNet
from cartnet_tpu_torch.nn import norm
from cartnet_tpu_torch.train import loop, schedule
from cartnet_tpu_torch.train.guard import guard_contribution

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "train_loss_trajectory.npy")
D, RBF, L = 32, 16, 2
LR, PCT, STEPS = 3e-4, 0.1, 50  # the golden trajectory's setting


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------- BN

@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_train_bn_matches_jax(case):
    rng = np.random.default_rng(0)
    M_, d = 96, 16
    x = (rng.normal(size=(M_, d)) * 2 + 1).astype(np.float32)
    mask = rng.uniform(size=M_) < 0.7
    gamma = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    beta = (0.1 * rng.normal(size=d)).astype(np.float32)
    ct = rng.normal(size=(M_, d)).astype(np.float32)
    jdt = jnp.bfloat16 if case == "bf16" else jnp.float32
    tdt = torch.bfloat16 if case == "bf16" else torch.float32
    jx, jg, jb = (jnp.asarray(a, jdt) for a in (x, gamma, beta))
    state = {"mean": jnp.asarray(0.3 * rng.normal(size=d), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2, d), jnp.float32),
             "count": jnp.asarray(4, jnp.int32)}

    def jf(x_, g_, b_):
        y, s = jnorm.masked_batch_norm({"gamma": g_, "beta": b_}, state, x_,
                                       jnp.asarray(mask), training=True)
        return (y.astype(jnp.float32) * ct).sum(), (y, s)

    (_, (jy, js)), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                               has_aux=True)(jx, jg, jb)
    tx, tg, tb = (torch.tensor(_np(a)).to(tdt).requires_grad_()
                  for a in (jx, jg, jb))
    y, (mean, var, n) = norm.masked_batch_norm_train(tx, tg, tb,
                                                     torch.tensor(mask))
    assert y.dtype == tdt
    tgrads = torch.autograd.grad((y.float() * torch.tensor(ct)).sum(),
                                 [tx, tg, tb])
    tol = 2e-2 if case == "bf16" else 1e-5
    assert _rel(y, jy) <= tol
    for a, b in zip(tgrads, jgrads):
        assert _rel(a, b) <= (tol if case == "bf16" else 1e-4)
    bn = torch.nn.BatchNorm1d(d)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor(np.asarray(state["mean"])))
        bn.running_var.copy_(torch.tensor(np.asarray(state["var"])))
        bn.num_batches_tracked.fill_(4)
    norm.bn_state_update(bn, mean, var, n)
    assert _rel(bn.running_mean, js["mean"]) <= 1e-6
    assert _rel(bn.running_var, js["var"]) <= 1e-6
    assert int(bn.num_batches_tracked) == int(js["count"]) == 5


def test_window_moments_combine_matches_jax():
    rng = np.random.default_rng(1)
    nt, tile, d = 6, 64, 16
    g = rng.normal(size=(nt * tile, d)).astype(np.float32) * 3
    mask = rng.uniform(size=nt * tile) < 0.8
    gamma = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    beta = (0.1 * rng.normal(size=d)).astype(np.float32)
    from cartnet_tpu_torch.ops.kernels.edge_kernels import window_moments
    s1, m2 = window_moments(torch.tensor(g), torch.tensor(mask), tile)
    n_w = mask.reshape(nt, tile).sum(1).astype(np.float32)[:, None]
    cts = rng.normal(size=(2, d)).astype(np.float32)

    def jf(gm, bt, s1_, m2_):
        (sc, sh), (mean, var, n) = jnorm.combine_window_moments(
            gm, bt, s1_, m2_, jnp.asarray(n_w))
        return (sc * cts[0]).sum() + (sh * cts[1]).sum(), (sc, sh, mean, var)

    args = [jnp.asarray(a) for a in (gamma, beta, _np(s1), _np(m2))]
    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                           has_aux=True)(*args)
    targs = [torch.tensor(_np(a)).requires_grad_() for a in args]
    (sc, sh), (mean, var, n) = norm.combine_window_moments(
        *targs, torch.tensor(n_w))
    tgrads = torch.autograd.grad((sc * torch.tensor(cts[0])).sum()
                                 + (sh * torch.tensor(cts[1])).sum(), targs)
    for a, b in zip((sc, sh, mean, var), jout):
        assert _rel(a, b) <= 1e-5
    for a, b in zip(tgrads, jgrads):
        assert _rel(a, b) <= 1e-5
    # the merge equals two-pass masked moments of the same rows
    _, (mean2, var2, _) = norm.masked_bn_scale_shift_train(
        torch.tensor(g), torch.tensor(gamma), torch.tensor(beta),
        torch.tensor(mask))
    assert _rel(mean, mean2) <= 1e-5 and _rel(var, var2) <= 1e-5


# ---------------------------------------------------------------- schedule

def test_onecycle_schedules_match_jax():
    assert schedule.reference_total_steps(50, 37, 16) == \
        jsched.reference_total_steps(50, 37, 16)
    total = jsched.reference_total_steps(3, 40, 2)
    jl = jsched.onecycle_lr(1e-3, total, 0.1)
    jb = jsched.onecycle_beta1(total, 0.1)
    tl = schedule.onecycle_lr(1e-3, total, 0.1)
    tb = schedule.onecycle_beta1(total, 0.1)
    for k in range(total + 3):  # the whole cycle and past its end
        np.testing.assert_allclose(tl(k), float(jl(k)), rtol=1e-5)
        np.testing.assert_allclose(tb(k), float(jb(k)), rtol=1e-6)


def test_adam_with_cycling_beta1_matches_optax():
    rng = np.random.default_rng(2)
    shapes = [(5, 3), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    opt = jsched.make_optimizer(1e-2, 8, 0.3)
    jp = [jnp.asarray(p) for p in params]
    st = opt.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    topt = schedule.make_optimizer(tp, 1e-2, 8, 0.3)
    for g in grads:
        upd, st = opt.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step([torch.tensor(a) for a in g])
    assert topt.count == 5
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- guard

def test_guard_skips_nonfinite_step_and_keeps_bn():
    g = [torch.ones(3), torch.tensor([1.0, float("nan")])]
    new_bn, old_bn = [torch.ones(2) * 5], [torch.ones(2)]
    ok, g2, bn = guard_contribution(torch.tensor(0.5), g, new_bn, old_bn)
    assert not bool(ok)
    assert all(torch.equal(a, torch.zeros_like(a)) for a in g2)
    assert torch.equal(bn[0], old_bn[0])
    ok, g2, bn = guard_contribution(torch.tensor(0.5), g[:1], new_bn, old_bn)
    assert bool(ok) and torch.equal(g2[0], g[0])
    assert torch.equal(bn[0], new_bn[0])


# ---------------------------------------------------------------- model

def _cfgs(case, accum=1, steps=STEPS):
    jdt = jnp.bfloat16 if case == "bf16" else jnp.float32
    tdt = torch.bfloat16 if case == "bf16" else torch.float32
    jcfg = JConfig(model=JModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                                      cholesky=True, compute_dtype=jdt),
                   data=JDataConfig(max_nodes=64, max_edges=4096,
                                    max_graphs=2),
                   optim=JOptimConfig(lr=LR, batch_accumulation=accum))
    tcfg = Config(model=ModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                                    cholesky=True, compute_dtype=tdt),
                  optim=OptimConfig(lr=LR, batch_accumulation=accum))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def batches():
    """The batches of test_train_parity.py, collated by both packages."""
    recs = jsynthetic(8, mean_atoms=10, radius=5.0, adp=True, seed=21)
    groups = [recs[i * 2:(i + 1) * 2] for i in range(4)]
    return ([jax.tree.map(jnp.asarray, jcollate(g, 64, 4096, 2))
             for g in groups],
            [collate(g, 64, 4096, 2) for g in groups])


def _jax_state(jcfg, steps=STEPS):
    opt = jsched.make_optimizer(LR, steps, PCT)
    state = jloop.init_train_state(jax.random.key(3), jcfg, M.cartnet_init,
                                   opt)
    return opt, state


def _port_state(tcfg, jstate, steps=STEPS):
    model = CartNet(tcfg.model, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state), tcfg.model), strict=True)
    opt = schedule.make_optimizer(model.parameters(), LR, steps, PCT)
    return loop.init_train_state(model, opt)


def _jax_micro(case, batch):
    jcfg, tcfg = _cfgs(case)
    opt, jstate = _jax_state(jcfg)
    state = _port_state(tcfg, jstate)
    jstate, jstats = jloop.make_steps(jcfg, M.cartnet_apply, opt)[0](jstate,
                                                                    batch)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.grad_accum),
                          jax.tree.map(np.asarray, jstate.bn_state),
                          tcfg.model)
    return tcfg, state, jstats, ref


def _bn_shift_cancelled(name):
    """MLP_gate's last bias shifts the gate by a constant, which train BN
    removes: its true gradient is zero and what both packages return is
    rounding noise of a sum of terms as large as W1g's gradient."""
    return name.endswith("MLP_gate.2.bias")


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_micro_step_matches_jax_make_steps(batches, case):
    """f32: loss 1e-5 relative; gradients 5e-4 normalized (train BN's
    backward cancels, amplifying the f32 summation-order differences about
    tenfold in the layers below it); BN stats 1e-5.
    bf16: the JAX package's XLA path at this width adds pre = gi + gj +
    e@We + b in bf16 where the port adds in f32 and rounds once, so the two
    bf16 runs round at different places. Loss 1e-2 relative and BN stats
    2e-2 normalized against JAX bf16; each gradient within twice the JAX
    package's own bf16 error (plus 2e-2) of the f32 gradient: some
    gradients under train BN are mostly bf16 rounding noise in both."""
    jb, tb = batches
    tcfg, state, jstats, ref = _jax_micro(case, jb[0])
    state, stats = loop.make_steps(tcfg)[0](state, tb[0].to("cpu"))
    f32 = case == "f32"
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-5 if f32 else 1e-2)
    if f32:  # the volume error of bf16 predictions is ill-conditioned
        for k in ("volume_percentage_error", "similarity_index"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       rtol=1e-5)
    ref32 = ref if f32 else _jax_micro("f32", jb[0])[3]
    names = [n for n, _ in state.model.named_parameters()]
    assert "encoder.rbf.means" in names and "encoder.rbf.betas" in names
    assert len(names) == len(state.grad_accum) == len(ref32) - 6 * L
    grads = dict(zip(names, state.grad_accum))
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        scale = (np.abs(_np(ref32[name.replace("2.bias", "2.weight")])).max()
                 if _bn_shift_cancelled(name) else None)
        rel = lambda a, b: float(np.abs(_np(a) - _np(b)).max() / max(
            scale or np.abs(_np(b)).max(), 1e-30))
        if f32:
            assert rel(g, ref[name]) <= 5e-4, (name, rel(g, ref[name]))
        else:
            own = rel(ref[name], ref32[name])
            assert rel(g, ref32[name]) <= 2 * own + 2e-2, (name, own)
    for name, buf in state.model.named_buffers():
        if name.endswith("num_batches_tracked"):
            assert int(buf) == int(ref[name]) == 1, name
        else:
            assert _rel(buf, ref[name]) <= (1e-5 if f32 else 2e-2), name
    assert int(state.accum_count) == 1 and int(state.bad_steps) == 0


def test_rbf_parameters_get_the_jax_gradients(batches):
    """means/betas are trained, as in the JAX package: nonzero gradients
    that match JAX's params['encoder']['rbf_means'/'rbf_betas']."""
    jb, tb = batches
    jcfg, tcfg = _cfgs("f32")
    opt, jstate = _jax_state(jcfg)
    state = _port_state(tcfg, jstate)
    jstate, _ = jloop.make_steps(jcfg, M.cartnet_apply, opt)[0](jstate,
                                                               jb[1])
    state, _ = loop.make_steps(tcfg)[0](state, tb[1].to("cpu"))
    rbf = state.model.encoder.rbf
    for p, key in ((rbf.means, "rbf_means"), (rbf.betas, "rbf_betas")):
        assert isinstance(p, torch.nn.Parameter)
        g = next(a for q, a in zip(state.optimizer.params,
                                   state.grad_accum) if q is p)
        ref = np.asarray(jstate.grad_accum["encoder"][key])
        assert np.abs(ref).max() > 0
        assert _rel(g, ref) <= 5e-4  # as the micro-step's f32 gradients


def test_50_step_trajectory_matches_golden(batches):
    _, tb = batches
    jcfg, tcfg = _cfgs("f32")
    _, jstate = _jax_state(jcfg)
    state = _port_state(tcfg, jstate)
    micro, update, _ = loop.make_steps(tcfg)
    losses = []
    for s in range(STEPS):
        state, stats = micro(state, tb[s % len(tb)].to("cpu"))
        state = update(state)
        losses.append(float(stats["loss"]))
    losses, golden = np.asarray(losses), np.load(GOLDEN)
    np.testing.assert_allclose(losses[0], golden[0], rtol=1e-5)
    np.testing.assert_allclose(losses, golden, rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(losses.mean(), golden.mean(), rtol=2e-3)
    assert state.step == STEPS and int(state.bad_steps) == 0


def test_accumulation_with_epoch_end_flush_matches_jax(batches):
    """3 micro-batches with batch_accumulation 2: an update after the
    second and the epoch-end flush after the third."""
    jb, tb = batches
    jcfg, tcfg = _cfgs("f32", accum=2)
    opt, jstate = _jax_state(jcfg, steps=4)
    state = _port_state(tcfg, jstate, steps=4)
    jmicro, jupdate, _ = jloop.make_steps(jcfg, M.cartnet_apply, opt)
    jstate = jloop.train_epoch(jstate, jb[:3], jmicro, jupdate, 2)
    micro, update, _ = loop.make_steps(tcfg)
    state, rows = loop.train_epoch(state, tb[:3], micro, update, 2,
                                   device="cpu")
    assert state.step == int(jstate.step) == 2 and len(rows) == 3
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                          jax.tree.map(np.asarray, jstate.bn_state),
                          tcfg.model)
    for name, t in state.model.state_dict().items():
        if _bn_shift_cancelled(name):  # Adam turns its noise into ~lr steps
            assert np.abs(_np(t) - _np(ref[name])).max() <= 2 * 2 * LR
        else:
            assert _rel(t, ref[name]) <= 1e-4, name
    assert all(int(g.abs().max()) == 0 for g in state.grad_accum)


def test_cli_trains_on_cpu(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    caplog.set_level("INFO")
    state, test = cli.main(["--device", "cpu", "--dataset", "synthetic", "--cholesky",
                            "--limit", "8", "--epochs", "1",
                            "--batch_accumulation", "2", "--dim_in", "32",
                            "--dim_rbf", "16", "--num_layers", "2"])
    assert state.step == 1 and int(state.bad_steps) == 0
    assert np.isfinite(test["MAE"]) and 0.0 <= test["iou"] <= 1.0
    assert "best epoch 0" in caplog.text
    # --augment (ported with the adpfix path) trains and writes the run dir
    astate, atest = cli.main(["--device", "cpu", "--dataset", "adpfix",
                              "--limit", "8", "--epochs", "1", "--augment",
                              "--batch_accumulation", "2", "--dim_in", "32",
                              "--dim_rbf", "16", "--num_layers", "2",
                              "--name", "aug"])
    assert astate.step == 1 and int(astate.bad_steps) == 0
    assert np.isfinite(atest["MAE"]) and 0.0 <= atest["iou"] <= 1.0
    run = tmp_path / "results" / "aug" / "0"
    assert (run / "ckpt" / "best.ckpt").is_file()
    assert (run / "ckpt" / "last.ckpt").is_file()
    assert all((run / s / "stats.json").is_file()
               for s in ("train", "val", "test"))
    if not torch.cuda.is_available():  # training defaults to the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--limit", "8", "--epochs", "1"])
