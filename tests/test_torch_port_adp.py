"""The port's CSD ADP source (``--dataset ADP``) vs the JAX package: the
lattice canonicalization on seeded and degenerate cells, the record
transforms (H removal, temperature standardization, the iComformer's cell
canonicalization, re-edging under a neighbour cap) and the CSD-ETL math,
bitwise; ``ADPDataset`` and ``LazyRecords`` over reference-layout ``.pt``
files the test writes (records, the re-edge caches and the sizing
sidecars, each package reading the other's); ``BatchPipeline``'s fetch
pool (``workers``) against the JAX pipeline, bitwise; the CLI's first
epoch against the JAX CLI on the same files; ``--wandb`` without wandb.

Both packages build radius graphs on the numpy path (the JAX package's
native extension is switched off for these tests; the two agree bitwise
on these crystals either way). The ``.pt`` files hold a ``SimpleNamespace``
in the attribute layout of the reference's PyG ``Data`` graphs.
"""

import json
import logging
import os
import shutil
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import cartnet_tpu.native as jnative
from cartnet_tpu import cli as jcli
from cartnet_tpu.data import adp as JA
from cartnet_tpu.data import csd_etl as JE
from cartnet_tpu.data import lattice as JL
from cartnet_tpu.data.pipeline import BatchPipeline as JPipe
from cartnet_tpu.models import cartnet as JM
from cartnet_tpu.models import comformer as JC
from cartnet_tpu_torch import cli, runner
from cartnet_tpu_torch.data import adp as TA
from cartnet_tpu_torch.data import csd_etl as TE
from cartnet_tpu_torch.data import lattice as TL
from cartnet_tpu_torch.data.pipeline import BatchPipeline
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.interop import (icomformer_params_from_jax,
                                       params_from_jax)
from cartnet_tpu_torch.models.factory import create_model

BATCH_FIELDS = ("z", "pos", "graph_id", "node_mask", "non_h_mask",
                "edge_src", "edge_dst", "cart_dir", "cart_dist", "edge_mask",
                "cell", "temperature", "graph_mask", "y")
SPLITS = {"train": 8, "val": 3, "test": 3}
D, RBF, L = 32, 16, 2


@pytest.fixture(autouse=True)
def numpy_graphs(monkeypatch):
    monkeypatch.setattr(jnative, "get_native", lambda: None)


def save_pt(path, rec):
    """A reference-format per-refcode ``.pt`` (attribute-style graph)."""
    data = SimpleNamespace(
        x=torch.tensor(rec["z"], dtype=torch.long),
        pos=torch.tensor(rec["pos"]),
        cell=torch.tensor(rec["cell"]).reshape(1, 3, 3),
        edge_index=torch.tensor(np.stack([rec["edge_src"],
                                          rec["edge_dst"]])),
        cart_dist=torch.tensor(rec["cart_dist"]).unsqueeze(-1),
        cart_dir=torch.tensor(rec["cart_dir"]),
        y=torch.tensor(rec["y"]),
        temperature=torch.tensor([rec["temperature"]]))
    torch.save(data, path)


def _crystals(n=sum(SPLITS.values()), seed=5):
    """Synthetic ADP crystals with about a third of the atoms hydrogen and
    temperatures of 100-300 K."""
    rng = np.random.default_rng(seed)
    recs = synthetic_dataset(n, mean_atoms=12, radius=5.0, adp=True,
                             seed=seed)
    for r in recs:
        h = rng.uniform(size=len(r["z"])) < 1 / 3
        r["z"] = np.where(h, 1, r["z"]).astype(np.int32)
        r["temperature"] = float(rng.uniform(100.0, 300.0))
    return recs


def write_dataset(root, recs):
    """``<root>/data/<refcode>.pt`` and ``<root>/csv/<split>_files.csv``."""
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    os.makedirs(os.path.join(root, "csv"), exist_ok=True)
    names = [f"REF{i:03d}" for i in range(len(recs))]
    for name, rec in zip(names, recs):
        save_pt(os.path.join(root, "data", name + ".pt"), rec)
    i = 0
    for split, n in SPLITS.items():
        with open(os.path.join(root, "csv", f"{split}_files.csv"), "w") as f:
            f.write("\n".join(names[i:i + n]) + "\n")
        i += n
    return root


@pytest.fixture(scope="module")
def crystals():
    return _crystals()


@pytest.fixture
def roots(tmp_path, crystals):
    """The same files under two roots, one for each package."""
    return tuple(write_dataset(str(tmp_path / k), crystals)
                 for k in ("jax", "port"))


def _same_records(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _same_batch(a, b):
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


# ------------------------------------------------------------ lattice

def _cells():
    rng = np.random.default_rng(11)
    cells = [np.eye(3) * rng.uniform(3, 8) + rng.normal(size=(3, 3)) * 2
             for _ in range(14)]
    cells += [np.diag([3.0, 4.0, 5.0]),                    # orthorhombic
              np.array([[5.0, 0, 0], [4.9, 0.5, 0], [0.1, 0.2, 6.0]]),
              np.array([[4.0, 0, 0], [-2.0, 3.4641, 0], [0, 0, 7.0]]),
              np.array([[1.0, 0, 0], [2.0, 0, 0], [0, 0, 1.0]]),  # a2 ∥ a1
              np.array([[1.0, 0, 0], [0, 1.0, 0], [1.0, 1.0, 0]]),  # flat
              np.zeros((3, 3))]                           # no lattice
    return cells


@pytest.mark.parametrize("i", range(20))
def test_optimize_lattice_bitwise(i):
    """20 cells, the last three degenerate: the same (cell, rotation) to the
    bit, or the same error."""
    cell = _cells()[i]
    try:
        want = JL.optimize_lattice(cell)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)):
            TL.optimize_lattice(cell)
        assert i >= 17
        return
    got = TL.optimize_lattice(cell)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ records

def test_record_transforms_bitwise(crystals):
    for rec in crystals[:6]:
        _same_records(TA.remove_hydrogens(rec), JA.remove_hydrogens(rec))
        for std in (True, False):
            for hyd in (True, False):
                for opt in (True, False):
                    _same_records(
                        TA.process_adp_record(rec, std, hyd, opt),
                        JA.process_adp_record(rec, std, hyd, opt))
        for k in (6, 25):
            _same_records(TA.re_edge_record(rec, 5.0, k),
                          JA.re_edge_record(rec, 5.0, k))
    assert (TA.TRAIN_TEMP_MEAN, TA.TRAIN_TEMP_STD) == (JA.TRAIN_TEMP_MEAN,
                                                      JA.TRAIN_TEMP_STD)
    h = crystals[0]["z"] == 1
    assert 0 < h.sum() < len(h)
    assert len(TA.remove_hydrogens(crystals[0])["z"]) == (~h).sum()


def test_csd_etl_bitwise():
    rng = np.random.default_rng(2)
    for params in ((5.1, 6.2, 7.3, 90.0, 90.0, 90.0),
                   (4.0, 4.0, 9.5, 90.0, 90.0, 120.0),
                   (7.3, 8.1, 6.6, 81.5, 97.2, 104.8)):
        a = TE.frac_to_cart_matrix(*params)
        b = JE.frac_to_cart_matrix(*params)
        np.testing.assert_array_equal(a, b)
        u = rng.normal(size=(5, 3, 3)) * 0.01
        u = u @ u.transpose(0, 2, 1)
        np.testing.assert_array_equal(TE.adp_cif_to_cart(u, a),
                                      JE.adp_cif_to_cart(u, b))
        np.testing.assert_array_equal(TE.adp_cif_to_cart(u[0], a),
                                      JE.adp_cif_to_cart(u[0], b))
    np.testing.assert_array_equal(TE.isotropic_adp(0.013),
                                  JE.isotropic_adp(0.013))
    pos = rng.uniform(0, 5, size=(12, 3))
    pos = np.concatenate([pos, pos[[3, 7]] + 1e-6, pos[:2]])
    keep = TE.dedup_positions(pos)
    np.testing.assert_array_equal(keep, JE.dedup_positions(pos))
    assert len(keep) == 12
    rec = _crystals(1, seed=9)[0]
    for k in (None, 8):
        _same_records(
            TE.structure_to_record(rec["z"], rec["pos"], rec["cell"],
                                   rec["y"], 250.0, 5.0, k),
            JE.structure_to_record(rec["z"], rec["pos"], rec["cell"],
                                   rec["y"], 250.0, 5.0, k))


# ------------------------------------------------------------ datasets

def _datasets(mod, root, **kw):
    return [mod.LazyRecords(mod.ADPDataset(
        os.path.join(root, "data"),
        os.path.join(root, "csv", f"{s}_files.csv"), **kw))
        for s in SPLITS]


def _files(root):
    """Every file beside the data dir (sidecars, re-edge caches)."""
    out = {}
    for dirpath, _, names in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.split(os.sep)[0] in ("data", "csv"):
            continue
        for n in names:
            out[os.path.normpath(os.path.join(rel, n))] = os.path.join(
                dirpath, n)
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(hydrogens=False, standarize_temp=False),
    dict(max_neighbors=6, optimize_cell=True),
    dict(max_neighbors=25, hydrogens=False)])
def test_datasets_and_caches_match_jax(roots, kw):
    jroot, troot = roots
    jsets, tsets = _datasets(JA, jroot, **kw), _datasets(TA, troot, **kw)
    for j, t in zip(jsets, tsets):
        assert len(j) == len(t)
        for i in range(len(t)):
            _same_records(t[i], j[i])
        for a, b in zip(t.counts(), j.counts()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        # a second read (from the caches) gives the same records
        _same_records(t[len(t) - 1], j[len(j) - 1])
    jfiles, tfiles = _files(jroot), _files(troot)
    assert jfiles.keys() == tfiles.keys() and tfiles
    assert any(n.startswith("sizes_h") for n in tfiles)
    assert any(n.startswith("data_") for n in tfiles) == bool(
        kw.get("max_neighbors"))
    for name in tfiles:
        a, b = np.load(tfiles[name]), np.load(jfiles[name])
        if name.endswith(".npz"):
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        tsets[0][len(tsets[0])]


def test_each_package_reads_the_others_sidecar(roots, monkeypatch):
    """A sidecar written by one package sizes the other's records without a
    single load."""
    jroot, troot = roots
    jtrain = _datasets(JA, jroot)[0]
    ttrain = _datasets(TA, troot)[0]
    want = jtrain.counts()  # written by the JAX package
    side = os.path.basename(ttrain.sidecar_path())
    assert os.path.isfile(os.path.join(jroot, side))
    shutil.copy(os.path.join(jroot, side), os.path.join(troot, side))
    monkeypatch.setattr(ttrain.dataset, "get", None)  # no loads allowed
    for a, b in zip(ttrain.counts(), want):
        np.testing.assert_array_equal(a, b)
    os.remove(os.path.join(jroot, side))
    ttrain2 = _datasets(TA, troot, hydrogens=False)[0]
    ttrain2.counts()  # written by the port
    side2 = os.path.basename(ttrain2.sidecar_path())
    shutil.copy(os.path.join(troot, side2), os.path.join(jroot, side2))
    jtrain2 = _datasets(JA, jroot, hydrogens=False)[0]
    monkeypatch.setattr(jtrain2.dataset, "get", None)
    for a, b in zip(jtrain2.counts(), ttrain2.counts()):
        np.testing.assert_array_equal(a, b)
    # a sidecar shorter than the split is not used
    np.save(os.path.join(troot, side), np.zeros((2, 2), np.int64))
    with pytest.raises(TypeError):
        ttrain.counts()


# ------------------------------------------------------------ pipeline

@pytest.mark.parametrize("buckets", [1, 2])
def test_fetch_pool_batches_match_jax(roots, buckets):
    """workers 0 and 2, prefetch on and off, shuffled and augmented, two
    epochs: the JAX pipeline's batches (fetch pool off), bitwise, and the
    same generator state after each epoch."""
    jroot, troot = roots
    jrecs = _datasets(JA, jroot)[0]
    trecs = _datasets(TA, troot)[0]
    for workers, prefetch in ((0, 0), (2, 0), (2, 2), (4, 1)):
        ours = BatchPipeline(trecs, 3, shuffle=True, augment=True, seed=3,
                             workers=workers, prefetch=prefetch,
                             buckets=buckets)
        ref = JPipe(jrecs, 3, shuffle=True, augment=True, seed=3,
                    prefetch=0, buckets=buckets)
        assert (ours.max_nodes, ours.max_edges, len(ours)) == (
            ref.max_nodes, ref.max_edges, len(ref))
        for _ in range(2):
            got = list(ours.iter_with_bucket())
            want = list(ref.iter_with_bucket())
            assert [g[0] for g in got] == [w[0] for w in want]
            for (_, a), (_, b) in zip(got, want):
                _same_batch(a, b)
            assert ours.rng.bit_generator.state == \
                ref._rng.bit_generator.state


# ------------------------------------------------------------ the CLI

def _rows(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


@pytest.mark.parametrize("extra,tol", [
    (["--augment", "--disable_H"], 1e-4),
    (["--model", "iComformer"], 1e-3)])
def test_cli_first_epoch_matches_jax_cli(roots, tmp_path, monkeypatch,
                                         extra, tol):
    """Both CLIs, one epoch of ``--dataset ADP`` (the default) on the same
    files from the JAX CLI's own initial weights: the same stats.json
    lines, CartNet (augmented, without H) within 1e-4 and the iComformer
    within 1e-3. The iComformer's val and test lines come after two Adam
    updates, whose first steps move each weight by about lr·sign(g): its
    f32 gradients that are rounding noise in both packages (BN-cancelled
    biases, up to 5e-4 of their layer's scale in
    tests/test_torch_port_icomformer_train.py) move weights by different
    ±lr, which read 4.2e-4 on the val MSE."""
    jroot, troot = roots
    monkeypatch.chdir(tmp_path)
    argv = ["--batch", "2", "--batch_accumulation", "2", "--epochs", "1",
            "--dim_in", str(D), "--dim_rbf", str(RBF), "--num_layers",
            str(L)] + extra
    jcfg = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    tcfg = cli.args_to_config(cli.build_parser().parse_args(argv))
    assert tcfg.data.name == jcfg.data.name == "ADP"
    for f in ("use_hydrogens", "optimize_cell", "max_neighbors", "augment",
              "standarize_temp"):
        assert getattr(tcfg.data, f) == getattr(jcfg.data, f), f
    ico = tcfg.model.name == "icomformer"
    pkey, _ = jax.random.split(jax.random.key(0))
    init = (JC.icomformer_init if ico else JM.cartnet_init)(pkey, jcfg.model)
    tree = [jax.tree.map(np.asarray, t) for t in init]
    sd = (icomformer_params_from_jax if ico else params_from_jax)(
        *tree, tcfg.model)
    torch.save(sd, tmp_path / "init.pt")
    state, test = cli.main(["--device", "cpu", "--name", "port",
                            "--dataset_path", troot, "--checkpoint_path",
                            str(tmp_path / "init.pt")] + argv)
    jcli.main(["--cpu", "--name", "jax", "--dataset_path", jroot] + argv)
    assert state.step == 2 and int(state.bad_steps) == 0
    for split in ("train", "val", "test"):
        ours = _rows(tmp_path / "results" / "port" / "0" / split /
                     "stats.json")
        ref = _rows(tmp_path / "results" / "jax" / "0" / split /
                    "stats.json")
        assert len(ours) == len(ref) == 1, split
        for a, b in zip(ours, ref):
            assert a["epoch"] == b["epoch"] and a["params"] == b["params"]
            assert set(a) == set(b) - {"fused_fraction", "gpu_memory"}
            for k in ("MAE", "MSE", "loss", "similarity_index"):
                assert abs(a[k] - b[k]) <= tol * abs(b[k]), (split, k)
    assert 0.0 <= test["iou"] <= 1.0


def test_cli_inference_and_audit_on_adp(roots, tmp_path, monkeypatch):
    """--inference on the ADP files: one entry per test structure, its
    non-H atoms only with --disable_H; two rounds of the Monte-Carlo audit
    over the lazy test split (the CLI's --montecarlo runs 100)."""
    _, troot = roots
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--dataset_path", troot, "--dim_in",
              str(D), "--dim_rbf", str(RBF), "--num_layers", str(L),
              "--inference"]
    out = cli.main(common + ["--inference_output", "a.pkl"])
    noh = cli.main(common + ["--inference_output", "b.pkl", "--disable_H"])
    assert len(out["pred"]) == len(noh["pred"]) == SPLITS["test"]
    for a, b in zip(out["atoms"], noh["atoms"]):
        assert (a != 1).all() and (b != 1).all()  # H never has a target
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(p).all() for p in out["pred"])
    cfg = cli.args_to_config(cli.build_parser().parse_args(common[2:]))
    splits = cli.load_datasets(cfg.data)
    model = create_model(cfg.model, "cpu", 0)
    stats = runner.montecarlo(cfg, model, runner.pipelines(cfg, splits)[2],
                              str(tmp_path / "mc.pkl"), iterations=2,
                              device="cpu")
    assert all(np.isfinite(v).all() for v in stats.values())
    assert (tmp_path / "mc_montecarlo_1.pkl").is_file()


def test_wandb_missing_warns_once_and_trains(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    with caplog.at_level(logging.WARNING):
        state, test = cli.main(
            ["--device", "cpu", "--dataset", "synthetic", "--limit", "4",
             "--epochs", "2", "--batch_accumulation", "1", "--dim_in",
             str(D), "--dim_rbf", str(RBF), "--num_layers", str(L),
             "--wandb", "--wandb_project", "p", "--wandb_entity", "e"])
    warned = [r for r in caplog.records if "wandb" in r.getMessage()]
    assert len(warned) == 1 and warned[0].levelno == logging.WARNING
    assert state.step == 2 and np.isfinite(test["MAE"])
    args = cli.build_parser().parse_args(["--wandb"])
    ref = jcli.build_parser().parse_args(["--wandb"])
    assert (args.wandb, args.wandb_project, args.wandb_entity) == (
        ref.wandb, ref.wandb_project, ref.wandb_entity)
