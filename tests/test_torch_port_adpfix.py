"""The port's adpfix data path, augmentation, rotations, KL, epoch logger
and aggregation vs the JAX package, and the pin of the committed port run.

Host-side numpy code (the fixture loader, ``augment_record``, the
augmented pipeline) must be bitwise the JAX package's for the same seed;
the torch math (rotations, KL) is held to 1e-6; the logger's lines must
equal the JAX logger's for the same updates, apart from the time and
memory keys.
"""

import hashlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu import aggregate as jaggregate
from cartnet_tpu.data import adp as jadp
from cartnet_tpu.data import adpfix as jadpfix
from cartnet_tpu.data.pipeline import BatchPipeline as JPipe
from cartnet_tpu.ops import rotations as jrot
from cartnet_tpu.train import logger as jlogger
from cartnet_tpu.train import metrics as jmetrics
from cartnet_tpu_torch import aggregate
from cartnet_tpu_torch.data import adp, adpfix
from cartnet_tpu_torch.data.pipeline import BatchPipeline
from cartnet_tpu_torch.ops import rotations
from cartnet_tpu_torch.train import logger, metrics

REPO = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("z", "pos", "graph_id", "node_mask", "non_h_mask", "edge_src",
          "edge_dst", "cart_dir", "cart_dist", "edge_mask", "cell",
          "temperature", "graph_mask", "y")
# the keys a port stats.json line may differ in from the JAX one: wall
# times, and the memory key the port reads from torch on the card only
TIME_KEYS = {"time_epoch", "time_iter", "edges_per_sec", "gpu_memory"}


def _same_records(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_fixture_copy_is_the_jax_file():
    digest = lambda p: hashlib.sha256(pathlib.Path(p).read_bytes()
                                      ).hexdigest()
    assert adpfix.FIXTURE_PATH != jadpfix.FIXTURE_PATH
    assert digest(adpfix.FIXTURE_PATH) == digest(jadpfix.FIXTURE_PATH)
    assert (adpfix.TEMP_MEAN, adpfix.TEMP_STD, adpfix.RADIUS) == (
        jadpfix.TEMP_MEAN, jadpfix.TEMP_STD, jadpfix.RADIUS)


@pytest.mark.parametrize("standarize", [True, False])
def test_load_fixture_matches_jax(standarize):
    ours = adpfix.load_fixture(standarize_temp=standarize)
    ref = jadpfix.load_fixture(standarize_temp=standarize)
    assert [len(s) for s in ours] == [200, 20, 20]
    for a, b in zip(ours, ref):
        _same_records(a, b)
    if standarize:
        raw = adpfix.load_fixture(standarize_temp=False)[0][0]
        assert ours[0][0]["temperature"] == (
            raw["temperature"] - 192.1785) / 81.2135
    limited = adpfix.load_fixture(standarize_temp=standarize, limit=8)
    assert [len(s) for s in limited] == [8, 2, 2]
    for a, b in zip(limited, jadpfix.load_fixture(standarize_temp=standarize,
                                                  limit=8)):
        _same_records(a, b)


@pytest.mark.parametrize("rotate_targets", [True, False])
def test_augment_record_matches_jax(rotate_targets):
    recs = adpfix.load_fixture(limit=8)[0]
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for rec in recs:
        ours = adp.augment_record(rec, r1, rotate_targets)
        ref = jadp.augment_record(rec, r2, rotate_targets)
        _same_records([ours], [ref])
        assert ours["cart_dir"].dtype == np.float32
        assert (ours["y"] is rec["y"]) != rotate_targets
    assert r1.bit_generator.state == r2.bit_generator.state


def test_augmented_pipeline_matches_jax():
    """Two epochs of the augmented train pipeline: one shuffle an epoch,
    then four normals a record as each batch is emitted, from one rng."""
    recs = adpfix.load_fixture(limit=8)[0]
    ours = BatchPipeline(recs, 4, shuffle=True, augment=True, seed=7)
    ref = JPipe(recs, 4, shuffle=True, augment=True, seed=7, prefetch=0)
    assert (ours.max_nodes, ours.max_edges, ours.edge_align) == (
        ref.max_nodes, ref.max_edges, 0)  # unaligned: no RCM relabeling
    seen = []
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            for f in FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                              np.asarray(getattr(b, f)),
                                              err_msg=f)
        seen.append(got[0].cart_dir)
    assert not np.array_equal(seen[0], seen[1])  # a new rotation an epoch
    assert ours.rng.bit_generator.state == ref._rng.bit_generator.state
    # val/test pipelines never augment: the same batches every pass
    val = BatchPipeline(recs, 4, seed=7)
    np.testing.assert_array_equal(next(iter(val)).cart_dir,
                                  next(iter(val)).cart_dir)


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = rotations.quat_to_matrix(torch.tensor(q))
    np.testing.assert_allclose(R.numpy(),
                               np.asarray(jrot.quat_to_matrix(jnp.asarray(q))),
                               atol=1e-6, rtol=1e-6)
    y = rng.normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        rotations.rotate_adp_targets(torch.tensor(y), R[0]).numpy(),
        np.asarray(jrot.rotate_adp_targets(jnp.asarray(y),
                                           jnp.asarray(R[0].numpy()))),
        atol=1e-6, rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    Rs = rotations.random_rotation(gen, (8,))
    assert Rs.shape == (8, 3, 3) and Rs.dtype == torch.float32
    eye = torch.eye(3).expand(8, 3, 3)
    assert torch.allclose(Rs @ Rs.transpose(-1, -2), eye, atol=1e-6)
    assert torch.allclose(torch.linalg.det(Rs), torch.ones(8), atol=1e-6)
    again = rotations.random_rotation(torch.Generator().manual_seed(0), (8,))
    assert torch.equal(Rs, again)


def test_get_kl_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(32, 3, 3))
    b = rng.normal(size=(32, 3, 3))
    pred = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    true = (b @ b.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    ours = metrics.get_kl(torch.tensor(pred), torch.tensor(true)).numpy()
    ref = np.asarray(jmetrics.get_kl(jnp.asarray(pred), jnp.asarray(true)))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)
    same = metrics.get_kl(torch.tensor(pred), torch.tensor(pred))
    assert float(same.abs().max()) < 1e-5


def _updates(seed):
    rng = np.random.default_rng(seed)
    for i in range(5):
        stats = {"loss": np.float32(rng.uniform()),
                 "MAE": np.float32(rng.uniform()),
                 "similarity_index": np.float32(rng.uniform(0, 100))}
        yield dict(stats=stats, weight=float(rng.integers(10, 40)),
                   lr=float(rng.uniform(1e-5, 1e-3)),
                   edges=float(rng.integers(100, 900)),
                   true=rng.normal(size=(7, 3, 3)).astype(np.float32),
                   pred=rng.normal(size=(7, 3, 3)).astype(np.float32))


@pytest.mark.parametrize("with_values", [True, False])
def test_epoch_logger_matches_jax(tmp_path, with_values):
    """The same update sequences (two epochs; device scalars on the
    port's side) give the same stats.json lines apart from the time and
    memory keys."""
    ours = logger.create_loggers(str(tmp_path / "port"), device="cpu")
    ref = jlogger.create_loggers(str(tmp_path / "jax"))
    for lg in ours + ref:
        lg.params = 1234
    for epoch in range(2):
        for u in _updates(epoch):
            if not with_values:
                u = {k: v for k, v in u.items() if k not in ("true", "pred")}
            ref[1].update(**u)
            ours[1].update(**{**u, "stats": {k: torch.tensor(v) for k, v
                                             in u["stats"].items()}})
        ref[1].note_time(0.5)
        ours[1].note_time(0.5)
        a, b = ours[1].write_epoch(epoch), ref[1].write_epoch(epoch)
        assert ("r2" in a) == with_values and "gpu_memory" not in a
        assert "fused_fraction" not in a
        assert a == {k: v for k, v in b.items() if k != "gpu_memory"}
    lines = [[json.loads(x) for x in (tmp_path / side / "val" /
                                      "stats.json").read_text().splitlines()]
             for side in ("port", "jax")]
    assert len(lines[0]) == len(lines[1]) == 2
    for a, b in zip(*lines):
        assert {k: v for k, v in a.items() if k not in TIME_KEYS} == \
            {k: v for k, v in b.items() if k not in TIME_KEYS}


def test_r2_and_spearman_match_jax():
    rng = np.random.default_rng(2)
    t = rng.normal(size=200)
    p = t + 0.3 * rng.normal(size=200)
    p[:20] = p[20:40]  # ties
    assert logger.eval_r2(t, p) == jlogger.eval_r2(t, p)
    assert logger.eval_spearman(t, p) == jlogger.eval_spearman(t, p)
    assert logger.eval_spearman(t, np.ones(200)) == 0.0


def test_aggregate_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    for seed in (0, 1, 3):
        d = tmp_path / "run" / str(seed) / "test"
        d.mkdir(parents=True)
        rows = [{"epoch": e, "lr": 0.0, "time_epoch": 1.0,
                 "MAE": float(rng.uniform()), "iou": float(rng.uniform())}
                for e in range(2)]
        if seed == 3:
            rows[-1]["similarity_index"] = 50.0
        (d / "stats.json").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
    args = ("run", [0, 1, 2, 3], str(tmp_path))
    ours = aggregate.aggregate(*args)
    assert ours == jaggregate.aggregate(*args)
    assert ours["similarity_index"]["n"] == 1 and ours["MAE"]["n"] == 3
    assert "missing" in capsys.readouterr().out
    assert aggregate.load_last_stats(
        str(tmp_path / "run" / "0" / "test" / "stats.json"))["epoch"] == 1
    with pytest.raises(FileNotFoundError):
        aggregate.aggregate("nope", [0], str(tmp_path))


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("name,seed", [("adpfix_torch_f32", 0),
                                       ("adpfix_torch_f32", 1),
                                       ("adpfix_torch_bf16", 0),
                                       ("adpfix_torch_bf16", 1)])
def test_pinned_port_fixture_run(name, seed):
    """The committed runs of the port on the card (README's fixture
    command, ``--name adpfix_torch_{f32,bf16}``, seeds 0 and 1): 300
    epochs from an untrained start (train MAE > 0.05 in epoch 0) to a test
    MAE, taken at the best val epoch, under the JAX run's pin of 4.8e-4
    (predicting zero gives 5.9e-4)."""
    run = REPO / "results" / name / str(seed)
    tr = _rows(run / "train" / "stats.json")
    val = _rows(run / "val" / "stats.json")
    test = _rows(run / "test" / "stats.json")[-1]
    assert tr[0]["MAE"] > 0.05
    assert [r["epoch"] for r in tr] == [r["epoch"] for r in val] == \
        list(range(300))
    assert test["MAE"] < 4.8e-4, test
    assert test["epoch"] == min(val, key=lambda r: r["MAE"])["epoch"]
    assert 0.0 < test["iou"] <= 1.0 and "similarity_index" in test


def test_aggregate_epoch_medians():
    """``--epochs LO HI``: each seed's medians over its lines of that epoch
    window (epoch times kept), here on the committed JAX fixture run's
    val curve and on the port's f32 run."""
    results = str(REPO / "results")
    for name in ("adpfix", "adpfix_torch_f32"):
        val = _rows(REPO / "results" / name / "0" / "val" / "stats.json")
        got = aggregate.aggregate(name, [0], results, "val", (150, 300))
        window = [r for r in val if 150 <= r["epoch"] < 300]
        assert len(window) == 150
        for key in ("MAE", "time_epoch", "similarity_index"):
            want = float(np.median([r[key] for r in window]))
            assert got[key] == {"mean": want, "std": 0.0, "max": want,
                                "min": want, "n": 1}
        assert "epoch" not in got and "lr" not in got
    assert aggregate.epoch_medians(
        [{"epoch": e, "MAE": float(e)} for e in range(5)], 1, 4) == \
        {"MAE": 2.0}
    with pytest.raises(ValueError):
        aggregate.epoch_medians(val, 300, 400)
