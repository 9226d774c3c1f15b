"""The port's adpfix product path vs the JAX package: the CLI run with SO(3)
augmentation (stats.json, checkpoints), resume, the checkpoint layouts,
the Monte-Carlo audit and the CLI's config.

Both CLIs train CartNet at dim 32, 16 RBF, 2 layers on the fixture cut to
8 / 2 / 2 crystals (``--limit 8``), batch 4 with ``--batch_accumulation
2``: one optimizer update an epoch, from one shared torch ``.pt`` made
from the JAX package's init (``params_from_jax``). At dim 32 the JAX
package takes its XLA path and the port its kernels' plain versions. The
augmented batches are bitwise the same on both sides
(tests/test_torch_port_adpfix.py), so the runs differ by f32 rounding
only: sums in other orders, amplified where Adam's first update divides a
gradient by its own magnitude. Stated tolerances: the MAE lines within
1e-4 relative, eval forwards within 1e-5 of the largest prediction.

``val_mae_both`` is the F5 comparison: one checkpoint's val MAE through
the port's eval forward and through the JAX package's (which reads the
checkpoint with ``load_torch_checkpoint``), in bf16 and in f32, on the
same val batches. A test runs it on a port ``best.ckpt`` at dim 32; run
as a script it takes a full-width checkpoint of the README's fixture
run on the CPU:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_port_adpfix_train.py \
        f5_audit/bf16_last.pt

(one JSON line: each package's val MAE per dtype, their relative
difference, and the largest per-structure prediction difference over the
largest prediction). Limits: the MAEs within 2% of each other, the
predictions within the bf16 forward tolerance, 3e-2.
"""

import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu import cli as jcli
from cartnet_tpu import runner as jrunner
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.interop import load_torch_checkpoint
from cartnet_tpu.models import cartnet as M
from cartnet_tpu_torch import cli, runner
from cartnet_tpu_torch.data.adpfix import load_fixture
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.interop import (load_reference_checkpoint,
                                       params_from_jax)
from cartnet_tpu_torch.models.cartnet import CartNet
from cartnet_tpu_torch.ops.rotations import random_rotation
from cartnet_tpu_torch.train import checkpoint as ckpt
from cartnet_tpu_torch.train import loop

D, RBF, L = 32, 16, 2
SMALL = ["--dataset", "adpfix", "--limit", "8", "--augment",
         "--batch_accumulation", "2", "--dim_in", str(D), "--dim_rbf",
         str(RBF), "--num_layers", str(L)]
MAE_TOL = 1e-4
PRED_TOL = 1e-5


def _port_cfg():
    return cli.args_to_config(cli.build_parser().parse_args(
        ["--device", "cpu"] + SMALL))


def _jax_cfg():
    return jcli.args_to_config(jcli.build_parser().parse_args(SMALL))


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs, two epochs each, from one .pt of the JAX init."""
    root = tmp_path_factory.mktemp("adpfix_cli")
    jcfg = _jax_cfg()
    params, bn = M.cartnet_init(jax.random.key(3), jcfg.model)
    sd = params_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, bn), _port_cfg().model)
    torch.save(sd, root / "init.pt")
    common = SMALL + ["--epochs", "2", "--checkpoint_path",
                      str(root / "init.pt")]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        state, test = cli.main(["--device", "cpu", "--name", "port"] + common)
        jcli.main(["--cpu", "--name", "jax"] + common)
    return root, state, test


def test_cli_stats_match_jax_cli(runs):
    root, state, test = runs
    assert state.step == 2 and int(state.bad_steps) == 0
    for split, n in (("train", 2), ("val", 2), ("test", 1)):
        ours = _rows(root / "results" / "port" / "0" / split / "stats.json")
        ref = _rows(root / "results" / "jax" / "0" / split / "stats.json")
        assert len(ours) == len(ref) == n, split
        for a, b in zip(ours, ref):
            assert a["epoch"] == b["epoch"] and a["params"] == b["params"]
            assert "fused_fraction" not in a and "gpu_memory" not in a
            assert set(a) == set(b) - {"fused_fraction", "gpu_memory"}
            for k in ("MAE", "MSE", "loss", "similarity_index"):
                assert abs(a[k] - b[k]) <= MAE_TOL * abs(b[k]), (split, k)
            # the JAX schedule is evaluated in f32, the port's in f64
            assert abs(a["lr"] - b["lr"]) <= 1e-6 * abs(b["lr"])
    assert 0.0 <= test["iou"] <= 1.0 and test["epoch"] == ours[-1]["epoch"]


def test_checkpoint_layouts(runs):
    root, state, _ = runs
    best, last = runner.checkpoint_paths(str(root / "results" / "port" /
                                             "0"))
    b = torch.load(best, weights_only=True)
    assert set(b) == {"model_state", "optimizer_state"}
    assert set(b["optimizer_state"]) == {"state", "param_groups"}
    ll = torch.load(last, weights_only=True)
    assert {"model_state", "optimizer_state", "grad_accum", "accum_count",
            "step", "bad_steps", "generator", "meta"} <= set(ll)
    assert ll["meta"]["epoch"] == 1 and ll["step"] == 2
    assert set(ll["meta"]) == {"epoch", "best_val", "best_epoch",
                               "pipeline_rng"}
    assert ckpt.latest_step(last) == 2 and ckpt.latest_step(best) is None
    assert ckpt.latest_step(str(root / "nothing.ckpt")) is None
    assert not [f for f in os.listdir(os.path.dirname(best))
                if f.endswith(".tmp")]
    sd = load_reference_checkpoint(best)
    for k, v in sd.items():
        assert torch.equal(v, b["model_state"][k])


def test_best_ckpt_loads_in_jax(runs):
    """A port best.ckpt through the JAX package's load_torch_checkpoint:
    the JAX eval forward equals the port's within PRED_TOL."""
    root, _, _ = runs
    best, _ = runner.checkpoint_paths(str(root / "results" / "port" / "0"))
    jcfg = _jax_cfg()
    params, bn = load_torch_checkpoint(best, jcfg.model)
    model = CartNet(_port_cfg().model, device="cpu")
    model.load_state_dict(load_reference_checkpoint(best), strict=True)
    recs = load_fixture(limit=8)[2]
    tb = collate(recs, 256, 4608, 4)
    jb = jcollate(recs, 256, 4608, 4)
    ref, ref_mask, _ = M.cartnet_apply(params, bn, jax.tree.map(
        jnp.asarray, jb), jcfg.model, training=False)
    with torch.no_grad():
        pred, mask = model(tb.to("cpu"))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    m = mask.numpy()
    a, r = pred.numpy()[m], np.asarray(ref)[m]
    assert np.abs(a - r).max() <= PRED_TOL * np.abs(r).max()


def val_mae_both(ckpt, argv, dtype: str) -> dict:
    """``ckpt``'s val MAE (the weighted mean of |pred - y| over non-H
    atoms) through both packages' eval forwards in ``dtype`` ("bf16" or
    "f32"), on the val batches the CLI of ``argv`` builds."""
    extra = ["--bf16"] if dtype == "bf16" else []
    cfg = cli.args_to_config(cli.build_parser().parse_args(argv + extra))
    jcfg = jcli.args_to_config(jcli.build_parser().parse_args(argv + extra))
    splits = load_fixture(limit=cli.build_parser().parse_args(argv).limit)
    model = CartNet(cfg.model, device="cpu")
    model.load_state_dict(load_reference_checkpoint(ckpt), strict=True)
    params, bn = load_torch_checkpoint(ckpt, jcfg.model)
    err = {"port": 0.0, "jax": 0.0}
    n, pred_err, scale = 0, 0.0, 0.0
    for tb, jb in zip(runner.pipelines(cfg, splits)[1],
                      jrunner._pipelines(jcfg, splits)[1]):
        with torch.no_grad():
            pred, mask = model(tb.to("cpu"))
        ref, _, _ = M.cartnet_apply(params, bn, jax.tree.map(jnp.asarray,
                                                             jb),
                                    jcfg.model, training=False)
        m = mask.numpy()
        ours = pred.float().numpy()[m]
        theirs = np.asarray(ref.astype(jnp.float32))[m]
        y = np.asarray(tb.y)[m]
        err["port"] += float(np.abs(ours - y).sum())
        err["jax"] += float(np.abs(theirs - y).sum())
        n += y.size
        pred_err = max(pred_err, float(np.abs(ours - theirs).max()))
        scale = max(scale, float(np.abs(theirs).max()))
    mae = {k: v / n for k, v in err.items()}
    return {"dtype": dtype, "val_MAE_port": mae["port"],
            "val_MAE_jax": mae["jax"],
            "rel_diff": abs(mae["port"] - mae["jax"]) / mae["jax"],
            "pred_max_rel": pred_err / scale}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_val_mae_matches_jax_on_a_port_checkpoint(runs, dtype):
    """F5's comparison on a port best.ckpt at dim 32: the two packages'
    eval forwards give the same val MAE within 2% and the same
    predictions within 3e-2 (bf16) / PRED_TOL (f32)."""
    root, _, _ = runs
    best, _ = runner.checkpoint_paths(str(root / "results" / "port" / "0"))
    out = val_mae_both(best, SMALL, dtype)
    assert out["rel_diff"] <= 2e-2, out
    assert out["pred_max_rel"] <= (3e-2 if dtype == "bf16" else PRED_TOL), \
        out


def test_montecarlo_round_matches_jax(runs, tmp_path, monkeypatch):
    """One round of both audits under the same R (each package's
    random_rotation replaced by it): the same pickle layout, targets
    Rᵀ U R of the unrotated prediction, and predictions on the rotated
    batch within PRED_TOL; the per-structure MAE, IoU and S12 agree."""
    root, _, _ = runs
    best, _ = runner.checkpoint_paths(str(root / "results" / "port" / "0"))
    R = random_rotation(torch.Generator().manual_seed(11))
    monkeypatch.setattr(runner, "random_rotation", lambda gen: R)
    monkeypatch.setattr("cartnet_tpu.ops.rotations.random_rotation",
                        lambda key: jnp.asarray(R.numpy()))
    cfg = _port_cfg()
    model = CartNet(cfg.model, device="cpu")
    model.load_state_dict(load_reference_checkpoint(best), strict=True)
    splits = load_fixture(limit=8)
    stats = runner.montecarlo(cfg, model, runner.pipelines(cfg, splits)[2],
                              str(tmp_path / "port.pkl"), iterations=1,
                              device="cpu")
    jcfg = _jax_cfg()
    params, bn = load_torch_checkpoint(best, jcfg.model)
    jstate = types.SimpleNamespace(params=params, bn_state=bn)
    jpipes = jrunner._pipelines(jcfg, splits)
    jstats = jrunner.montecarlo(jcfg, jstate, M.cartnet_apply, jpipes[2],
                                str(tmp_path / "jax.pkl"), iterations=1)
    ours = pickle.loads((tmp_path / "port_montecarlo_0.pkl").read_bytes())
    ref = pickle.loads((tmp_path / "jax_montecarlo_0.pkl").read_bytes())
    assert ours.keys() == ref.keys() and len(ours["pred"]) == 2
    for k in ("cell", "pos", "atoms", "refcode"):
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("pred", "true"):
        for a, b in zip(ours[k], ref[k]):
            assert np.abs(a - b).max() <= PRED_TOL * np.abs(b).max(), k
    for k in ("mae", "iou", "similarity_index"):
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    assert stats.keys() == jstats.keys()
    assert all(np.isfinite(v).all() for v in stats.values())


def test_resume_is_bitwise(tmp_path, monkeypatch):
    """A two-epoch run against one cut after its first epoch (the train
    loop raises at the second) and resumed with --resume: the same
    weights, BN stats, Adam moments, counters and stats.json lines."""
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--epochs", "2"] + SMALL
    full, full_test = cli.main(argv + ["--name", "full"])
    calls = {"n": 0}
    real = runner.train_epoch

    def cut(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("cut")
        return real(*a, **k)

    monkeypatch.setattr(runner, "train_epoch", cut)
    with pytest.raises(KeyboardInterrupt):
        cli.main(argv + ["--name", "cut"])
    monkeypatch.setattr(runner, "train_epoch", real)
    run_dir = tmp_path / "results" / "cut" / "0"
    assert len(_rows(run_dir / "train" / "stats.json")) == 1
    assert not (run_dir / "test" / "stats.json").exists()
    res, res_test = cli.main(argv + ["--name", "cut", "--resume"])
    sd_f, sd_r = full.model.state_dict(), res.model.state_dict()
    assert sd_f.keys() == sd_r.keys()
    for k in sd_f:
        assert torch.equal(sd_f[k], sd_r[k]), k
    opt_f, opt_r = (s.optimizer.state_dict() for s in (full, res))
    assert opt_f["count"] == opt_r["count"] == 2
    for i, st in opt_f["adam"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt_r["adam"]["state"][i][k]), (i, k)
    assert (full.step, int(full.bad_steps), int(full.accum_count)) == (
        res.step, int(res.bad_steps), int(res.accum_count))
    for a, b in zip(full.grad_accum, res.grad_accum):
        assert torch.equal(a, b)
    assert torch.equal(full.generator.get_state(), res.generator.get_state())
    for split in ("train", "val", "test"):
        fa = _rows(tmp_path / "results" / "full" / "0" / split / "stats.json")
        ra = _rows(run_dir / split / "stats.json")
        assert [r["epoch"] for r in fa] == [r["epoch"] for r in ra]
        assert [r["MAE"] for r in fa] == [r["MAE"] for r in ra], split
    assert full_test["MAE"] == res_test["MAE"]


def test_resume_adds_one_epoch(tmp_path, monkeypatch):
    """--resume with a larger --epochs continues at the next epoch: one
    more train and val line, one more test line."""
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu"] + SMALL + ["--name", "more"]
    cli.main(argv + ["--epochs", "1"])
    state, _ = cli.main(argv + ["--epochs", "2", "--resume"])
    run_dir = tmp_path / "results" / "more" / "0"
    assert [r["epoch"] for r in _rows(run_dir / "train" / "stats.json")] \
        == [0, 1]
    assert len(_rows(run_dir / "test" / "stats.json")) == 2
    assert state.step == 2


def test_args_to_config_matches_jax():
    """--dataset adpfix turns on the temperature input and the Cholesky
    head; --augment is forced off for the Comformers; the run dir is
    results/<name>/<seed>; --no_standarize_temp reaches the data config."""
    for extra in ([], ["--model", "eComformer"], ["--model", "iComformer"],
                  ["--no_standarize_temp", "--name", "x", "--seed", "3"]):
        argv = SMALL + extra
        ours = cli.args_to_config(cli.build_parser().parse_args(argv))
        ref = jcli.args_to_config(jcli.build_parser().parse_args(argv))
        assert (ours.name, ours.run_dir, ours.seed) == (ref.name,
                                                        ref.run_dir, ref.seed)
        assert (ours.data.augment, ours.data.standarize_temp) == (
            ref.data.augment, ref.data.standarize_temp)
        assert (ours.model.use_temperature, ours.model.cholesky) == (
            ref.model.use_temperature, ref.model.cholesky) == (True, True)
    assert ours.run_dir == os.path.join("results", "x", "3")


def test_montecarlo_cli_needs_the_cholesky_head(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="Cholesky"):
        cli.main(["--device", "cpu", "--dataset", "synthetic", "--limit",
                  "4", "--montecarlo", "--dim_in", str(D), "--dim_rbf",
                  str(RBF), "--num_layers", str(L)])


def test_train_epoch_feeds_the_logger(tmp_path):
    """The logger gets every micro-batch (weights from the host batch, lr
    after each update) and the eval pass's masked values; its stats are
    the epoch means of the rows the loop returns."""
    from cartnet_tpu_torch.train.logger import EpochLogger
    cfg = _port_cfg()
    splits = load_fixture(limit=8)
    pipes = runner.pipelines(cfg, splits)
    model = CartNet(cfg.model, device="cpu")
    opt = loop.build_optimizer(cfg, model.parameters(), len(pipes[0]))
    state = loop.init_train_state(model, opt)
    micro, update, evals = loop.make_steps(cfg)
    lr_fn = loop.build_lr_fn(cfg, len(pipes[0]))
    lg = EpochLogger("train", str(tmp_path), "cpu")
    state, rows = loop.train_epoch(state, pipes[0], micro, update, 2, "cpu",
                                   lg, lr_fn)
    line = lg.write_epoch(0)
    means = loop.epoch_means(rows)
    for k, v in means.items():
        assert abs(line[k] - v) <= 1e-6 * abs(v), k
    assert line["lr"] == lr_fn(1) and line["edges_per_sec"] > 0
    vl = EpochLogger("val", None, "cpu")
    vrows = loop.eval_epoch(state, pipes[1], evals, "cpu", logger=vl)
    vline = vl.write_epoch(0)
    assert "r2" in vline and "spearmanr" in vline
    assert vline["edges_per_sec"] > 0 and vline["time_epoch"] > 0
    assert abs(vline["MAE"] - loop.epoch_means(vrows)["MAE"]) <= 1e-6


if __name__ == "__main__":
    import sys
    jax.config.update("jax_platforms", "cpu")
    full = ["--dataset", "adpfix", "--augment", "--batch", "4"]
    print(json.dumps([val_mae_both(sys.argv[1], full, dt)
                      for dt in ("bf16", "f32")]))
