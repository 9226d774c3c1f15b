"""The port's Jarvis / megnet training path vs the JAX package: the CLI's
config for figshare argv, micro-steps at the path's batch layouts, size
buckets and prefetch in the pipeline, and two-epoch CLI runs.

Data: the committed sample (tests/fixtures/jarvis_sample.json) through
``build_dataset``: CartNet's uncapped radius graph, 64 train crystals
collated as a batch-64 step is (640 nodes, 30720 edges, unaligned, no
RCM), and the Comformers' 25-neighbour graph, 16 crystals (256 / 4608).
The scalar head on scalar targets, no temperature input, as the JAX CLI
builds it for ``--dataset jarvis``. CartNet at dim 32, 16 RBF, 2 layers;
the Comformers at dim 64. The JAX package takes its XLA paths on the CPU,
the port its kernels' plain versions; weights move across with the
interop functions. Tolerances, normalized by the reference's largest
magnitude: loss 1e-5 relative, BN stats 1e-5, f32 gradients 5e-4 (train
BN's backward cancels and amplifies summation-order differences; a few
gradients are held against their layer's largest entry, as in
tests/test_torch_port_cli_ablation.py and the Comformers' train tests).
The CLI runs start from one ``.pt`` of the JAX init and agree within 1e-4
relative on every MAE, MSE and loss line.
"""

import functools
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartnet_tpu import cli as jcli
from cartnet_tpu.config import Config as JConfig
from cartnet_tpu.config import DataConfig as JDataConfig
from cartnet_tpu.config import ModelConfig as JModelConfig
from cartnet_tpu.config import OptimConfig as JOptimConfig
from cartnet_tpu.data import jarvis as JJ
from cartnet_tpu.data.batching import collate as jcollate
from cartnet_tpu.data.pipeline import BatchPipeline as JPipe
from cartnet_tpu.data.radius_graph import radius_graph_pbc as j_graph
from cartnet_tpu.models import cartnet as M
from cartnet_tpu.models import comformer as JC
from cartnet_tpu.train import loop as jloop
from cartnet_tpu.train import schedule as jsched
from cartnet_tpu_torch import cli, interop
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data import jarvis as TJ
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.data.pipeline import BatchPipeline
from cartnet_tpu_torch.models.cartnet import CartNet
from cartnet_tpu_torch.models.comformer import EComformer, IComformer
from cartnet_tpu_torch.train import loop, schedule

SAMPLE = Path(__file__).parent / "fixtures" / "jarvis_sample.json"
TARGET = "formation_energy_peratom"
LR, PCT, STEPS = 3e-4, 0.1, 50
SMALL = ["--dim_in", "32", "--dim_rbf", "16", "--num_layers", "2"]
FIELDS = ("z", "pos", "cell", "graph_id", "node_mask", "non_h_mask",
          "edge_src", "edge_dst", "edge_mask", "cart_dist", "cart_dir",
          "y", "graph_mask")


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b, scale=None):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(b).max() if scale is None else scale
    return float(np.abs(a - b).max() / max(scale, 1e-30))


def _stage(root: Path) -> Path:
    (root / "raw").mkdir(parents=True)
    shutil.copy(SAMPLE, root / "raw" / "dft_3d_2021.json")
    return root


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """The sample's splits per radius-graph cap (numpy graphs)."""
    root = _stage(tmp_path_factory.mktemp("jarvis"))
    return {mn: TJ.build_dataset("jarvis", TARGET, str(root), 5.0, mn,
                                 backend="numpy") for mn in (-1, 25)}


# ------------------------------------------------------------ the CLI

ARGVS = {
    "jarvis_cartnet": ["--dataset", "jarvis"],
    "jarvis_cartnet_cap": ["--dataset", "jarvis", "--max_neighbours", "12",
                           "--augment"],
    "dft_3d_ecomformer": ["--dataset", "dft_3d_2021", "--model",
                          "eComformer", "--augment", "--buckets", "3"],
    "jarvis_icomformer": ["--dataset", "jarvis", "--model", "iComformer",
                          "--max_neighbours", "16", "--figshare_target",
                          "optb88vdw_bandgap"],
    "megnet_guard": ["--dataset", "megnet", "--dataset_path", "/data/mp",
                     "--figshare_target", "bulk modulus", "--no_guard",
                     "--guard_retries", "5", "--heartbeat", "hb.json",
                     "--heartbeat_interval", "3"],
}


@pytest.mark.parametrize("argv", list(ARGVS))
def test_args_to_config_matches_jax_cli(argv):
    args = ARGVS[argv] + ["--batch", "64", "--batch_accumulation", "1"]
    cfg = cli.args_to_config(cli.build_parser().parse_args(args))
    ref = jcli.args_to_config(jcli.build_parser().parse_args(args))
    for field in ("name", "path", "target", "radius", "max_neighbors",
                  "batch_size", "augment", "buckets", "standarize_temp"):
        assert getattr(cfg.data, field) == getattr(ref.data, field), field
    for field in ("name", "cholesky", "use_temperature", "invariant",
                  "use_envelope", "use_atom_types", "dim_in", "num_layers"):
        assert getattr(cfg.model, field) == getattr(ref.model, field), field
    assert (cfg.model.cholesky, cfg.model.use_temperature) == (False, False)
    for field in ("enabled", "max_bad_fraction", "max_retries",
                  "heartbeat_path", "heartbeat_interval"):
        assert getattr(cfg.guard, field) == getattr(ref.guard, field), field
    assert (cfg.optim.batch_accumulation, cfg.run_dir) == (
        ref.optim.batch_accumulation, ref.run_dir)
    assert cfg.data.max_neighbors == (-1 if cfg.model.name == "cartnet"
                                      else ref.data.max_neighbors)


# ------------------------------------------------------------ micro-steps

def _batch(splits, graphs):
    """The first ``graphs`` train crystals, padded as the run pads them
    (the worst batch over all three splits)."""
    every = [r for s in splits for r in s]
    nodes = sorted((len(r["z"]) for r in every), reverse=True)[:graphs]
    edges = sorted((len(r["edge_src"]) for r in every),
                   reverse=True)[:graphs]
    mn = -(-sum(nodes) // 128) * 128
    me = -(-sum(edges) // 512) * 512
    recs = splits[0][:graphs]
    return (jax.tree.map(jnp.asarray, jcollate(recs, mn, me, graphs)),
            collate(recs, mn, me, graphs).to("cpu"), mn, me)


def test_cartnet_micro_step_at_the_batch64_layout(splits):
    jb, tb, mn, me = _batch(splits[-1], 64)
    assert (mn, me) == (640, 30720) and tb.y.shape == (64,)
    assert (~tb.edge_mask).any() and (~tb.node_mask).any()
    kw = dict(dim_in=32, dim_rbf=16, num_layers=2, cholesky=False,
              use_temperature=False)
    jcfg = JConfig(model=JModelConfig(**kw),
                   data=JDataConfig(max_nodes=mn, max_edges=me,
                                    max_graphs=64),
                   optim=JOptimConfig(lr=LR))
    tcfg = Config(model=ModelConfig(**kw), optim=OptimConfig(lr=LR))
    opt = jsched.make_optimizer(LR, STEPS, PCT)
    jstate = jloop.init_train_state(jax.random.key(3), jcfg, M.cartnet_init,
                                    opt)
    model = CartNet(tcfg.model, device="cpu")
    model.load_state_dict(interop.params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state), tcfg.model), strict=True)
    jstate, jstats = jloop.make_steps(jcfg, M.cartnet_apply, opt)[0](jstate,
                                                                    jb)
    ref = interop.params_from_jax(jax.tree.map(np.asarray, jstate.grad_accum),
                                  jax.tree.map(np.asarray, jstate.bn_state),
                                  tcfg.model)
    state = loop.init_train_state(
        model, schedule.make_optimizer(model.parameters(), LR, STEPS, PCT))
    state, stats = loop.make_steps(tcfg)[0](state, tb)
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    for name, g in zip(names, state.grad_accum):
        # MLP_gate's last bias: train BN removes its shift (true gradient 0)
        scale = (np.abs(_np(ref[name.replace("2.bias", "2.weight")])).max()
                 if name.endswith("MLP_gate.2.bias") else None)
        assert _rel(g, ref[name], scale) <= 5e-4, (name,
                                                   _rel(g, ref[name], scale))
    for name, buf in model.named_buffers():
        if not name.endswith("num_batches_tracked"):
            assert _rel(buf, ref[name]) <= 1e-5, name
    assert int(state.accum_count) == 1 and int(state.bad_steps) == 0


COMFORMERS = {
    "ecomformer": (JC.ecomformer_init, JC.ecomformer_apply, EComformer,
                   interop.ecomformer_params_from_jax),
    "icomformer": (JC.icomformer_init, JC.icomformer_apply, IComformer,
                   interop.icomformer_params_from_jax),
}


def _layer_scales(names, ref):
    scale = {}
    for n in names:
        head = n.split(".")[0]
        scale[head] = max(scale.get(head, 0.0), np.abs(_np(ref[n])).max())
    return {n: scale[n.split(".")[0]] for n in names}


@pytest.mark.parametrize("net", list(COMFORMERS))
def test_comformer_micro_step_at_25_neighbours(splits, net):
    init, apply, cls, to_port = COMFORMERS[net]
    jb, tb, mn, me = _batch(splits[25], 16)
    assert (mn, me) == (256, 4608)
    kw = dict(name=net, dim_in=64, cholesky=False, use_temperature=False)
    jcfg = JConfig(model=JModelConfig(**kw), optim=JOptimConfig(lr=LR))
    tcfg = Config(model=ModelConfig(**kw), optim=OptimConfig(lr=LR))
    opt = jsched.make_optimizer(LR, STEPS, PCT)
    jstate = jloop.init_train_state(jax.random.key(3), jcfg, init, opt)
    port = functools.partial(to_port, cfg=tcfg.model)
    model = cls(tcfg.model, device="cpu", seed=9)
    model.load_state_dict(port(jax.tree.map(np.asarray, jstate.params),
                               jax.tree.map(np.asarray, jstate.bn_state)),
                          strict=True)
    jstate, jstats = jloop.make_steps(jcfg, apply, opt)[0](jstate, jb)
    ref = port(jax.tree.map(np.asarray, jstate.grad_accum),
               jax.tree.map(np.asarray, jstate.bn_state))
    state = loop.init_train_state(
        model, schedule.make_optimizer(model.parameters(), LR, STEPS, PCT))
    state, stats = loop.make_steps(tcfg)[0](state, tb)
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]),
                               rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    scales = _layer_scales(names, ref)
    errs = {n: _rel(g, ref[n], scales[n])
            for n, g in zip(names, state.grad_accum)}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 5e-4, (worst, errs[worst])
    for name, buf in model.named_buffers():
        if not name.endswith("num_batches_tracked"):
            assert _rel(buf, ref[name]) <= 1e-5, name
    assert int(state.bad_steps) == 0


# ------------------------------------------------------------ pipeline

def _same_batch(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def test_bucketed_pipeline_matches_jax(splits):
    """buckets=2, shuffled and augmented, two epochs: the same pad shapes
    per bucket, the same bucket visit order, batches and rng state (the
    port prefetching, the JAX pipeline not); the eval pipeline likewise."""
    recs = splits[-1][0]
    for shuffle, augment in ((True, True), (False, False)):
        ours = BatchPipeline(recs, 16, shuffle=shuffle, augment=augment,
                             rotate_targets=False, seed=3, buckets=2)
        ref = JPipe(recs, 16, shuffle=shuffle, augment=augment,
                    rotate_targets=False, seed=3, buckets=2, prefetch=0)
        assert ours._bucket_sizes == ref._bucket_sizes
        assert len(ours._bucket_sizes) == 2
        assert ours._bucket_sizes[0] != ours._bucket_sizes[1]
        assert (ours.max_nodes, ours.max_edges, len(ours)) == (
            ref.max_nodes, ref.max_edges, len(ref))
        assert ours.bucket_batch_counts() == ref.bucket_batch_counts()
        assert ours.cache == ref.cache == (not shuffle)
        for _ in range(2):
            got = list(ours.iter_with_bucket())
            want = list(ref.iter_with_bucket())
            assert [g[0] for g in got] == [w[0] for w in want]
            for (_, a), (_, b) in zip(got, want):
                _same_batch(a, b)
            assert ours.rng.bit_generator.state == \
                ref._rng.bit_generator.state
    dropped = BatchPipeline(recs, 16, buckets=3, drop_last=True)
    jdropped = JPipe(recs, 16, buckets=3, drop_last=True, prefetch=0)
    assert dropped.bucket_batch_counts() == \
        jdropped.bucket_batch_counts() == [1, 1, 1]
    assert len(dropped) == len(list(dropped)) == 3


def test_prefetch_gives_the_same_batches_and_state(splits):
    """Prefetch on and off: the same batches and, read after each epoch,
    the same generator state; a consumer that stops early stops the
    producer; a producer's error reaches the consumer."""
    recs = splits[-1][0]
    mk = lambda pf: BatchPipeline(recs, 8, shuffle=True, augment=True,
                                  rotate_targets=False, seed=5, buckets=2,
                                  prefetch=pf)
    on, off = mk(4), mk(0)
    assert on.cache is False
    for _ in range(3):
        for a, b in zip(on, off):
            _same_batch(a, b)
        assert on.rng.bit_generator.state == off.rng.bit_generator.state
    it = iter(on)
    next(it)
    it.close()  # joins the producer
    bad = mk(1)
    bad.records = list(recs)
    bad.records[9] = dict(recs[9], z=None)
    with pytest.raises(TypeError):
        list(bad)


# ------------------------------------------------------------ the CLI run

def test_two_epoch_cli_matches_jax_cli(tmp_path, monkeypatch):
    """Both CLIs, two epochs on the sample cut to 16 / 2 / 2, batch 8, from
    one .pt of the JAX init: the same stats lines within 1e-4."""
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "jarvis", "--limit", "16", "--batch", "8",
            "--batch_accumulation", "1", "--epochs", "2"] + SMALL
    jcfg = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    tcfg = cli.args_to_config(cli.build_parser().parse_args(argv))
    params, bn = M.cartnet_init(jax.random.key(3), jcfg.model)
    torch.save(interop.params_from_jax(jax.tree.map(np.asarray, params),
                                       jax.tree.map(np.asarray, bn),
                                       tcfg.model), tmp_path / "init.pt")
    common = argv + ["--checkpoint_path", str(tmp_path / "init.pt")]
    monkeypatch.setattr(JJ, "radius_graph_pbc",
                        functools.partial(j_graph, backend="numpy"))
    state, test = cli.main(["--device", "cpu", "--name", "port",
                            "--dataset_path", str(_stage(tmp_path / "t"))]
                           + common)
    jcli.main(["--cpu", "--name", "jax", "--dataset_path",
               str(_stage(tmp_path / "j"))] + common)
    assert state.step == 4 and int(state.bad_steps) == 0
    for split, n in (("train", 2), ("val", 2), ("test", 1)):
        rows = [[json.loads(x) for x in open(
            tmp_path / "results" / name / "0" / split / "stats.json")]
            for name in ("port", "jax")]
        assert len(rows[0]) == len(rows[1]) == n, split
        for a, b in zip(*rows):
            assert a["epoch"] == b["epoch"] and a["params"] == b["params"]
            for k in ("MAE", "MSE", "loss"):
                assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (split, k)
            assert "similarity_index" not in a
    assert test["epoch"] == rows[0][-1]["epoch"]
