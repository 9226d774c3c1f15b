"""Fused epochs (``--fused_steps K``) of the port against the JAX package's
and against the port's own unfused epochs, on the CPU, where the chunk runs
eagerly through the kernels' plain versions (on the card the same chunk is
one CUDA-graph replay, ``train/graphs.py``; ``chip_smoke.py``'s ``fused``
phase holds the replay against eager there).

* ``train_epoch_fused`` + ``make_fused_chunk`` (K = 2, 5 batches,
  batch_accumulation 2: two chunks of two, then one batch and one fully
  masked pad step; two updates on the device and the epoch-end flush)
  against the JAX ``make_fused_chunk`` / ``train_epoch_fused`` from the same
  weights, moved across with ``params_from_jax``; again with one micro-step
  the guard rejects (a NaN target): it adds to ``bad_steps`` and does not
  advance the cadence. Compared: every weight and BN buffer, ``step``,
  ``accum_count`` and ``bad_steps``, and each micro-step's loss.
* ``make_fused_steps`` (an update after every micro-step) against the JAX
  ``make_fused_steps``, with a guard-rejected step among three.
* The fused epoch against the port's unfused ``train_epoch`` when every
  batch is valid, and a resumed run (a checkpoint's state dict loaded into
  a fresh state) across fused and unfused epochs against the unbroken run.
* ``OneCycleAdam.step_where`` (the update driven from the device) against
  ``OneCycleAdam.step``, clipping included, to the bit, and as an exact
  no-op where its predicate is false.
* The CLI with ``--fused_steps 3``: the stats lines carry the unfused keys
  and values, and ``--resume`` continues unfused.

dim 32, 16 RBF, 2 layers, f32, Cholesky head, on 2-crystal batches (64
nodes, 4096 edges) of the synthetic ADP crystals of test_torch_port_train:
the JAX package takes its XLA path there. Tolerances: against JAX, as
test_torch_port_train's accumulation test (1e-4 after two updates), each
weight and BN buffer within 1e-3 of its largest entry after three updates
(the port's unfused epoch on these batches is 1.15e-4 from the JAX unfused
epoch, 6.2e-4 with the poisoned batch, both in layers.0.MLP_gate.0.weight,
whose train BN takes its moments per 64-edge window in the port and in two
passes in the JAX package; the fused epochs are 1.15e-4 and 4.1e-4 apart)
plus 1e-3 lr an update (BN's beta starts at 0, and its entries
are a few Adam steps of about lr, as in test_torch_port_dp.py), MLP_gate's
last bias (BN cancels its gradient, Adam turns the noise into steps of
about lr) within 2 lr an update, losses 1e-5.
On the CPU the device-driven update rounds as torch.optim.Adam's
single-tensor path does, so the port's fused and unfused epochs agree to
the bit, and so does a resumed run with the unbroken one.
"""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu.config import Config as JConfig
from cartnet_tpu.config import DataConfig as JDataConfig
from cartnet_tpu.config import ModelConfig as JModelConfig
from cartnet_tpu.config import OptimConfig as JOptimConfig
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.data.synthetic import synthetic_dataset as jsynthetic
from cartnet_tpu.models import cartnet as M
from cartnet_tpu.train import loop as jloop
from cartnet_tpu.train import schedule as jsched
from cartnet_tpu_torch import cli
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.interop import params_from_jax
from cartnet_tpu_torch.models.cartnet import CartNet
from cartnet_tpu_torch.train import loop, schedule
from cartnet_tpu_torch.train.graphs import ChunkRunner
from cartnet_tpu_torch.train.logger import EpochLogger

D, RBF, L = 32, 16, 2
LR, PCT, TOTAL = 3e-4, 0.1, 8
K, ACCUM = 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this file runs: its models are tiny, and in
    six test workers on a shared CPU, torch's default of a thread a core
    ran these steps up to ~100x slower (as test_torch_port_dp.py's ranks
    found)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cfgs(accum=ACCUM):
    jcfg = JConfig(model=JModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                                      cholesky=True),
                   data=JDataConfig(max_nodes=64, max_edges=4096,
                                    max_graphs=2),
                   optim=JOptimConfig(lr=LR, batch_accumulation=accum))
    tcfg = Config(model=ModelConfig(dim_in=D, dim_rbf=RBF, num_layers=L,
                                    cholesky=True),
                  optim=OptimConfig(lr=LR, batch_accumulation=accum))
    return jcfg, tcfg


def _batches(poison=None):
    """Five 2-crystal batches, collated by both packages; ``poison``: the
    batch whose first crystal gets a NaN target (the guard rejects its
    micro-step)."""
    recs = jsynthetic(10, mean_atoms=10, radius=5.0, adp=True, seed=21)
    if poison is not None:
        rec = dict(recs[2 * poison])
        y = np.array(rec["y"], dtype=np.float32)
        y[0, 0, 0] = np.nan
        rec["y"] = y
        recs[2 * poison] = rec
    groups = [recs[i * 2:(i + 1) * 2] for i in range(5)]
    return ([jax.tree.map(jnp.asarray, jcollate(g, 64, 4096, 2))
             for g in groups],
            [collate(g, 64, 4096, 2) for g in groups])


@functools.lru_cache(maxsize=None)
def _jax_fns():
    """The JAX package's optimizer, fused chunk and update step, built
    once (each compiles once)."""
    jcfg, _ = _cfgs()
    opt = jsched.make_optimizer(LR, TOTAL, PCT)
    return (opt, jloop.make_fused_chunk(jcfg, M.cartnet_apply, opt, K),
            jloop.make_steps(jcfg, M.cartnet_apply, opt)[1])


def jax_init():
    """The JAX package's optimizer and a fresh initial state (seed 3; its
    steps donate the state)."""
    opt = _jax_fns()[0]
    return opt, jloop.init_train_state(jax.random.key(3), _cfgs()[0],
                                       M.cartnet_init, opt)


def _port_state(jstate, tcfg=None):
    tcfg = tcfg or _cfgs()[1]
    model = CartNet(tcfg.model, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state), tcfg.model), strict=True)
    opt = schedule.make_optimizer(model.parameters(), LR, TOTAL, PCT)
    return loop.init_train_state(model, opt)


def _check_against_jax(state, jstate, updates):
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                          jax.tree.map(np.asarray, jstate.bn_state),
                          state.model.cfg)
    for name, t in state.model.state_dict().items():
        if name.endswith("MLP_gate.2.bias"):  # BN cancels its gradient
            assert np.abs(_np(t) - _np(ref[name])).max() <= \
                2 * updates * LR, name
        elif name.endswith("num_batches_tracked"):
            assert int(t) == int(ref[name]), name
        else:  # BN's beta starts at 0: its entries are a few Adam steps
            err = np.abs(_np(t) - _np(ref[name])).max()
            assert err <= 1e-3 * np.abs(_np(ref[name])).max() + \
                1e-3 * LR * updates, (name, err)


def _fused_epoch(state, tb, tcfg, chunk_size=K, logger=None):
    _, update, _ = loop.make_steps(tcfg)
    run = ChunkRunner(loop.make_fused_chunk(tcfg, chunk_size), chunk_size,
                      "cpu")
    return loop.train_epoch_fused(
        state, tb, run, chunk_size, update, tcfg.optim.batch_accumulation,
        "cpu", logger, loop.build_lr_fn(tcfg, len(tb)))


@pytest.mark.parametrize("poison", [None, 1], ids=["clean", "guard"])
def test_fused_epoch_matches_jax(poison):
    """K = 2 over 5 batches with batch_accumulation 2 (a pad step in the
    last chunk); ``guard``: batch 1 poisoned, so the valid micro-steps are
    0, 2, 3, 4: the device updates after 2 and 4 and no flush is left."""
    _, jstate = jax_init()
    jb, tb = _batches(poison)
    _, tcfg = _cfgs()
    state = _port_state(jstate)
    _, chunk, jupdate = _jax_fns()
    jstate = jloop.train_epoch_fused(jstate, jb, chunk, K, jupdate)
    state, rows = _fused_epoch(state, tb, tcfg)
    bad = 0 if poison is None else 1
    assert state.step == int(jstate.step) == 3 - bad
    assert state.optimizer.count == int(state.optimizer.count_t) == \
        state.step
    assert int(state.accum_count) == int(jstate.accum_count) == 0
    assert int(state.bad_steps) == int(jstate.bad_steps) == bad
    assert all(float(g.abs().max()) == 0 for g in state.grad_accum)
    _check_against_jax(state, jstate, 3)
    assert len(rows) == 5
    if poison is not None:
        assert np.isnan(rows[poison][0]["loss"])


def test_fused_steps_match_jax():
    """``make_fused_steps`` over batches 0, 1 (poisoned), 2: two updates,
    one bad step."""
    opt, jstate = jax_init()
    jb, tb = _batches(poison=1)
    jcfg, tcfg = _cfgs(accum=1)
    state = _port_state(jstate, tcfg)
    jfused = jloop.make_fused_steps(jcfg, M.cartnet_apply, opt, 3)
    jstate, jstats = jfused(jstate, jloop.stack_batches(jb[:3]))
    fused = loop.make_fused_steps(tcfg, 3)
    stats = fused(state, loop.stack_batches(tb[:3]).to("cpu"))
    assert loop.sync_step(state) == int(jstate.step) == 2
    assert int(state.bad_steps) == int(jstate.bad_steps) == 1
    _check_against_jax(state, jstate, 2)
    for k in ("loss", "MAE"):
        got, want = _np(stats[k]), _np(jstats[k])
        assert np.isnan(got[1]) and np.isnan(want[1])
        np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-5)


def _fresh(seed=0, accum=ACCUM):
    _, tcfg = _cfgs(accum)
    model = CartNet(tcfg.model, device="cpu", seed=seed)
    opt = loop.build_optimizer(tcfg, model.parameters(), 5)
    return tcfg, loop.init_train_state(model, opt)


def test_fused_epoch_matches_unfused_epoch():
    """Every batch valid, two epochs: the same updates (two and the flush
    an epoch), weights, BN buffers, Adam state, per-micro-step stats and
    weights, and lr stamps, to the bit."""
    _, tb = _batches()
    tcfg, a = _fresh()
    _, b = _fresh()
    micro, update, _ = loop.make_steps(tcfg)
    logs = [EpochLogger("a"), EpochLogger("b")]
    for _ in range(2):
        a, rows_a = loop.train_epoch(a, tb, micro, update, ACCUM, "cpu",
                                     logs[0], loop.build_lr_fn(tcfg, len(tb)))
        b, rows_b = _fused_epoch(b, tb, tcfg, logger=logs[1])
        assert [{k: float(v) for k, v in s.items()} for s, _ in rows_a] \
            == [s for s, _ in rows_b]
        assert [w for _, w in rows_a] == [w for _, w in rows_b]
        assert logs[0]._lr == logs[1]._lr  # the last micro-batch's stamp
        sa, sb = (lg.write_epoch(0) for lg in logs)
        assert {k: v for k, v in sa.items() if not k.startswith("time")
                and k != "edges_per_sec"} == {
                    k: v for k, v in sb.items() if not k.startswith("time")
                    and k != "edges_per_sec"}
    assert a.step == b.step == b.optimizer.count == 6
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for x, y in zip(a.optimizer.params, b.optimizer.params):
        for key, v in a.optimizer.adam.state[x].items():
            assert torch.equal(v, b.optimizer.adam.state[y][key]), key


def _resumed(state):
    """``state`` through a checkpoint's round trip into a fresh state."""
    buf = io.BytesIO()
    torch.save(state.state_dict(), buf)
    _, fresh = _fresh(seed=5)
    fresh.load_state_dict(torch.load(io.BytesIO(buf.getvalue()),
                                     weights_only=False))
    return fresh


@pytest.mark.parametrize("first_fused", [True, False],
                         ids=["fused_then_unfused", "unfused_then_fused"])
def test_resume_across_fused_steps_equals_unbroken_run(first_fused):
    """Epoch 0 in one mode, a checkpoint, epoch 1 in the other: the same
    state, to the bit, as both epochs on the one state. 3 batches with
    batch_accumulation 2 leave a flush at each epoch's end."""
    _, tb = _batches()
    tb = tb[:3]
    tcfg, ref = _fresh()
    _, broken = _fresh()
    micro, update, _ = loop.make_steps(tcfg)
    fused = lambda s: _fused_epoch(s, tb, tcfg)[0]
    unfused = lambda s: loop.train_epoch(s, tb, micro, update, ACCUM,
                                         "cpu")[0]
    first, second = (fused, unfused) if first_fused else (unfused, fused)
    ref = second(first(ref))
    broken = second(_resumed(first(broken)))
    assert ref.step == broken.step == 4
    a, b = ref.state_dict(), broken.state_dict()
    for k in a["model_state"]:
        assert torch.equal(a["model_state"][k], b["model_state"][k]), k
    for x, y in zip(ref.optimizer.params, broken.optimizer.params):
        for key, v in ref.optimizer.adam.state[x].items():
            assert torch.equal(v, broken.optimizer.adam.state[y][key]), key
    assert ref.optimizer.count == broken.optimizer.count == 4
    assert int(ref.accum_count) == int(broken.accum_count) == 0


@pytest.mark.parametrize("clip", [None, 0.5])
def test_step_where_matches_onecycle_adam_step(clip):
    """Updates taken on a pattern of predicates against ``step`` on the
    true ones: weights, moments and counts to the bit; a false predicate
    leaves every tensor as it was, to the bit."""
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,), (2, 2, 2), (300,)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 3).astype(np.float32) for s in shapes]
             for _ in range(8)]
    preds = [True, False, True, True, False, True, True, True]
    mk = lambda: [torch.nn.Parameter(torch.tensor(p)) for p in init]
    ref_p, dev_p = mk(), mk()
    ref = schedule.make_optimizer(ref_p, 1e-2, 6, 0.3, grad_clip=clip)
    dev = schedule.make_optimizer(dev_p, 1e-2, 6, 0.3, grad_clip=clip)
    for g, on in zip(grads, preds):
        before = [t.clone() for t in dev_p + dev.device_state()]
        dev.step_where([torch.tensor(a) for a in g], torch.tensor(on))
        if on:
            ref.step([torch.tensor(a) for a in g])
        else:
            assert all(torch.equal(a, b) for a, b in
                       zip(before, dev_p + dev.device_state()))
    assert dev.sync_count() == ref.count == sum(preds)  # past the cycle
    for a, b in zip(dev_p, ref_p):
        assert torch.equal(a, b)
        for key, v in ref.adam.state[b].items():
            assert torch.equal(dev.adam.state[a][key], v), key


def test_cli_fused_steps_trains_and_resumes_unfused(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--dataset", "synthetic", "--cholesky",
            "--limit", "8", "--batch", "2", "--batch_accumulation", "3",
            "--dim_in", str(D), "--dim_rbf", str(RBF), "--num_layers",
            str(L)]
    state, test = cli.main(argv + ["--epochs", "1", "--name", "plain"])
    fstate, ftest = cli.main(argv + ["--epochs", "1", "--name", "fused",
                                     "--fused_steps", "3"])
    # 4 micro-steps a chunk of 3 and one of 1 + 2 pad steps: one device
    # update and the flush, as unfused
    assert state.step == fstate.step == 2
    assert set(ftest) == set(test)
    run = lambda name: tmp_path / "results" / name / "0"
    lines = lambda name, split: (run(name) / split / "stats.json"
                                 ).read_text().splitlines()
    plain, fused = (json.loads(lines(n, "train")[0]) for n in ("plain",
                                                               "fused"))
    assert set(plain) == set(fused)
    assert fused["lr"] == plain["lr"]
    np.testing.assert_allclose(fused["loss"], plain["loss"], rtol=1e-5)
    rstate, _ = cli.main(argv + ["--epochs", "2", "--name", "fused",
                                 "--resume"])
    assert rstate.step == 4 and len(lines("fused", "train")) == 2
