"""The port's failure detection and recovery vs the JAX package: the
heartbeat file and its staleness check, ``GuardMonitor``'s policy report
for report against the JAX monitor, the poison-batch run of
tests/test_guard.py through the port's ``runner.train``, a forced
rollback that retries the epoch on a new shuffle and raises once the retry
budget is spent, ``--no_guard``, and ``--profile``'s trace on the CPU.

CartNet at dim 32, 16 RBF, 2 layers on synthetic scalar-target crystals;
everything on the CPU.
"""

import glob
import json
import logging
import math
import os
import time

import numpy as np
import pytest
import torch

from cartnet_tpu.train import guard as jguard
from cartnet_tpu_torch import cli, runner
from cartnet_tpu_torch.config import (Config, DataConfig, GuardConfig,
                                      ModelConfig, OptimConfig)
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.train import guard, loop

D = 32
SMALL = ["--dataset", "synthetic", "--limit", "4", "--epochs", "1",
         "--batch_accumulation", "1", "--dim_in", str(D), "--dim_rbf", "16",
         "--num_layers", "2", "--device", "cpu"]


def test_heartbeat_round_trip_and_staleness(tmp_path):
    path = str(tmp_path / "hb.json")
    assert guard.is_stale(path, 10.0) and guard.read_heartbeat(path) is None
    hb = guard.Heartbeat(path, interval=0.05)
    hb.beat(status="startup", epoch=0, name="x")
    first = guard.read_heartbeat(path)
    assert first["status"] == "startup" and first["pid"] == os.getpid()
    hb.start()
    time.sleep(0.3)  # the pulse re-writes the payload, only time moves
    pulsed = guard.read_heartbeat(path)
    assert pulsed["time"] > first["time"] and pulsed["name"] == "x"
    hb.beat(status="training", epoch=1)
    hb.stop()
    last = guard.read_heartbeat(path)
    assert (last["status"], last["epoch"], last["name"]) == ("stopped", 1,
                                                             "x")
    assert not guard.is_stale(path, 60.0)
    assert guard.is_stale(path, 60.0, now=last["time"] + 61.0)
    assert jguard.is_stale(path, 60.0, now=last["time"] + 61.0)
    assert jguard.read_heartbeat(path) == last
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    (tmp_path / "bad.json").write_text("{not json")
    assert guard.is_stale(str(tmp_path / "bad.json"), 60.0)
    off = guard.Heartbeat(None)
    off.start()
    off.beat(status="x")
    off.stop()


def test_monitor_matches_jax_report_for_report():
    rng = np.random.default_rng(0)
    for trial in range(20):
        kw = dict(max_bad_fraction=float(rng.uniform(0.1, 0.9)),
                  max_retries=int(rng.integers(0, 3)),
                  initial_bad_steps=int(rng.integers(0, 5)))
        ours, ref = guard.GuardMonitor(**kw), jguard.GuardMonitor(**kw)
        bad = kw["initial_bad_steps"]
        for _ in range(12):
            bad += int(rng.integers(0, 8))
            val = float(rng.choice([1.0, 0.5, float("nan"), float("inf")],
                                   p=[0.6, 0.2, 0.1, 0.1]))
            steps = int(rng.integers(1, 10))
            got = want = None
            try:
                want = ref.epoch_report(bad, steps, val)
            except RuntimeError as err:
                want = str(err)
            try:
                got = ours.epoch_report(bad, steps, val)
            except RuntimeError as err:
                got = str(err)
            assert got == want, trial
            if isinstance(want, str):
                break
            if want:
                bad = max(bad - int(rng.integers(0, 4)), 0)
                ours.note_rollback(bad)
                ref.note_rollback(bad)
            assert ours.retries == ref.retries


def _cfg(tmp_path, **guard_kw):
    return Config(
        model=ModelConfig(dim_in=D, dim_rbf=16, num_layers=2,
                          cholesky=False, use_temperature=False),
        data=DataConfig(name="synthetic", batch_size=3),
        optim=OptimConfig(lr=1e-3, max_epoch=2, batch_accumulation=2),
        guard=GuardConfig(**guard_kw), run_dir=str(tmp_path / "run"))


def _state(cfg, pipes):
    model = create_model(cfg.model, "cpu", 0)
    opt = loop.build_optimizer(cfg, model.parameters(), len(pipes[0]))
    return loop.init_train_state(model, opt)


def _poisoned():
    recs = synthetic_dataset(6, mean_atoms=40, radius=5.0, adp=False,
                             seed=7)
    recs[2] = dict(recs[2], y=float("nan"))
    return recs


def test_train_run_recovers_from_poison_batch(tmp_path):
    """tests/test_guard.py's run: an epoch holding a NaN target completes
    with finite weights, a bad-step count and a "stopped" heartbeat."""
    hb = str(tmp_path / "hb.json")
    cfg = _cfg(tmp_path, heartbeat_path=hb, max_bad_fraction=0.9)
    recs = _poisoned()
    pipes = runner.pipelines(cfg, (recs, recs[3:], recs[3:]))
    state, test = runner.train(cfg, _state(cfg, pipes), pipes, "cpu")
    assert int(state.bad_steps) >= 1
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert math.isfinite(test["MAE"])
    assert guard.read_heartbeat(hb)["status"] == "stopped"


def test_forced_rollback_retries_then_raises(tmp_path, monkeypatch):
    """A NaN val target makes every val MAE NaN: each epoch 0 is rolled
    back to the starting state (no checkpoint yet) and retried on the next
    shuffle, twice; the third report raises, the heartbeat says
    "failed"."""
    hb = str(tmp_path / "hb.json")
    cfg = _cfg(tmp_path, heartbeat_path=hb, max_retries=2)
    recs = synthetic_dataset(8, mean_atoms=30, radius=5.0, adp=False,
                             seed=3)
    val = [dict(recs[6], y=float("nan"))]
    pipes = runner.pipelines(cfg, (recs[:6], val, recs[7:]))
    state = _state(cfg, pipes)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    seen, beats = [], []
    real_epoch = runner.train_epoch
    real_beat = guard.Heartbeat.beat

    def spy(st, batches, *a, **k):
        got = list(batches)
        seen.append(({k_: v.clone() for k_, v in
                      st.model.state_dict().items()},
                     [np.asarray(b.y).tolist() for b in got]))
        return real_epoch(st, got, *a, **k)

    monkeypatch.setattr(runner, "train_epoch", spy)
    monkeypatch.setattr(guard.Heartbeat, "beat",
                        lambda self, **f: (beats.append(f.get("status")),
                                           real_beat(self, **f)))
    with pytest.raises(RuntimeError, match="retry budget"):
        runner.train(cfg, state, pipes, "cpu")
    assert len(seen) == 3
    for weights, _ in seen:
        for k, v in weights.items():
            assert torch.equal(v, start[k]), k
    orders = [o for _, o in seen]
    assert orders[0] != orders[1] and orders[1] != orders[2]
    assert beats == ["startup", "rollback", "rollback", "failed"]
    assert guard.read_heartbeat(hb)["status"] == "failed"
    assert not os.path.exists(runner.checkpoint_paths(cfg.run_dir)[1])


def test_rollback_restores_last_checkpoint(tmp_path, monkeypatch):
    """Once last.ckpt exists a rollback restores it (the end of epoch 0)
    and the retried epoch 1 continues from there."""
    cfg = _cfg(tmp_path)
    recs = synthetic_dataset(8, mean_atoms=30, radius=5.0, adp=False,
                             seed=3)
    pipes = runner.pipelines(cfg, (recs[:6], recs[6:7], recs[7:]))
    reports = iter([False, True, False])
    monkeypatch.setattr(guard.GuardMonitor, "epoch_report",
                        lambda self, *a: next(reports))
    starts = []
    real = runner.train_epoch

    def spy(st, batches, *a, **k):
        starts.append((st.step, {k_: v.clone() for k_, v in
                                 st.model.state_dict().items()}))
        return real(st, batches, *a, **k)

    monkeypatch.setattr(runner, "train_epoch", spy)
    state, _ = runner.train(cfg, _state(cfg, pipes), pipes, "cpu")
    assert [s for s, _ in starts] == [0, 1, 1]
    for k, v in starts[1][1].items():
        assert torch.equal(v, starts[2][1][k]), k
    assert state.step == 2


def test_no_guard(tmp_path, monkeypatch):
    """--no_guard: no step guard (the poisoned step is taken and counted
    nowhere: its NaN loss reaches the epoch's train MAE) and no monitor
    (no rollback, no raise)."""
    monkeypatch.chdir(tmp_path)
    cfg = cli.args_to_config(cli.build_parser().parse_args(
        SMALL + ["--no_guard"]))
    assert not cfg.guard.enabled and cfg.guard.max_retries == 2
    cfg = _cfg(tmp_path, enabled=False)
    recs = _poisoned()
    pipes = runner.pipelines(cfg, (recs, recs[3:], recs[3:]))
    monkeypatch.setattr(runner, "GuardMonitor", None)  # never built
    state, _ = runner.train(cfg, _state(cfg, pipes), pipes, "cpu")
    assert int(state.bad_steps) == 0 and state.step == 2
    with open(os.path.join(cfg.run_dir, "train", "stats.json")) as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == 2 and all(math.isnan(r["MAE"]) for r in lines)


def test_profile_writes_a_trace(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.INFO):
        cli.main(SMALL + ["--profile", "--name", "prof", "--heartbeat",
                          "hb.json"])
    # the port's host spans of the profiled epoch, logged after it
    table = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("host spans of the profiled")]
    assert len(table) == 1
    rows = {ln.split()[0]: ln.split()[1:] for ln in table[0].splitlines()[2:]}
    assert {"data.batch", "model.forward", "batch.to_device"} <= set(rows)
    assert int(rows["data.batch"][0]) >= 1
    traces = glob.glob(str(tmp_path / "results" / "prof" / "0" / "profile"
                           / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)
    assert guard.read_heartbeat("hb.json")["status"] == "stopped"
