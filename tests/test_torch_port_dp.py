"""Data parallelism over ``torch.distributed`` (gloo, two processes on the
CPU) against the JAX package's dp = 2, ep = 1 step and the port's own
single-process step on the union batch; ``ShardedPipeline``'s lengths and
members; the CLI's multi-host init over ``tcp://``.

One spawn of two ranks serves the whole file (``runs``): each rank joins a
gloo group through ``parallel.dist.initialize_distributed``, takes one
micro-step and one update of each case on its own shard through
``parallel.step.make_parallel_steps``, runs a fused chunk of four
micro-steps (``make_parallel_fused_chunk``, eager on the CPU, with pad
members) against the single-process fused chunk on the union batches,
then leaves the group, and both run
the CLI as ranks 0 and 1 of two ``--coordinator`` runs (training, and the
inference sweep gathered on rank 0). The references are computed in this
process:

  * CartNet (D = 16, 2 layers; cholesky and scalar heads, as
    tests/test_parallel.py): the JAX package's ``make_parallel_steps`` on a
    (dp = 2, ep = 1) mesh of its 8 virtual CPU devices, same weights
    (``params_from_jax``), same shards; and the port's single-process step
    on the union of the two shards.
  * CartNet under ``CARTNET_MERGED=1`` (the BN merge inside
    ``FusedEdgeSigma``, run again with its all-reduces in the backward) and
    the eComformer (D = 32): the port's single-process union step only (the
    JAX package's sharded Comformer steps fail at this tree).

Tolerances: the loss and the epoch stats, each layer's gradients (its
largest error over its largest value) and the BN running stats within
1e-5 relative of every reference. One exception against the JAX step: where
the port's own single-process step is farther from it than that (the CartNet
gate path, whose train BN takes its moments from K1's 64-edge windows where
the JAX package's XLA path below D = 128 takes two passes; equal to f32
rounding only, ROADMAP §3b: 1.2e-5 and 1.9e-5 of layers.1 here), the dp step
may be 1.5 times as far. The eComformer's volume error is left out: with
random weights its predicted ellipsoids are near singular, where that ratio
has no precision (0.12 apart for a 3e-6 difference in S12). The update is
the single-process one: both ranks hold the same weights to the bit, equal
to the port's optimizer applied to the summed gradients in this process;
against the references the updated weights agree within 1e-6 + 1e-3 lr
wherever the step's direction is determined: the reference gradient at
least 1e-6 (Adam's eps is 1e-8) and ten times its distance from the dp
gradient (over half of the weights). Adam's first step moves each weight
by lr·g / (|g| + eps), about lr·sign(g), so where a gradient is rounding
noise (all of a BN-cancelled bias) the two steps may go opposite ways.
"""

import contextlib
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cartnet_tpu_torch import cli
from cartnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                      OptimConfig)
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.data.pipeline import BatchPipeline
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.parallel import dist as pdist
from cartnet_tpu_torch.parallel.step import (make_parallel_fused_chunk,
                                             make_parallel_steps)
from cartnet_tpu_torch.runner import (ShardedPipeline, all_masked,
                                      sharded_steps_per_epoch)
from cartnet_tpu_torch.train import loop, schedule
from cartnet_tpu_torch.train.graphs import ChunkRunner

DP = 2
N_PER, E_PER, G_PER = 64, 1024, 2
LR, TOTAL = 1e-3, 4
CASES = {"cartnet_cholesky": ("cartnet", True, 16),
         "cartnet_merged": ("cartnet", True, 16),  # CARTNET_MERGED=1
         "cartnet_scalar": ("cartnet", False, 16),
         "ecomformer": ("ecomformer", True, 32)}
CLI_ARGV = ["--dataset", "synthetic", "--limit", "4",
            "--batch_accumulation", "4", "--epochs", "1", "--dim_in", "16",
            "--dim_rbf", "8", "--num_layers", "2", "--device", "cpu"]
# the sweep over the 4 test crystals of --limit 16, one batch a crystal
SWEEP_ARGV = CLI_ARGV[:2] + ["--limit", "16", "--batch", "1", "--cholesky",
                             "--inference", "--inference_output",
                             "sweep.pkl"] + CLI_ARGV[4:]


def _cfg(case) -> Config:
    name, cholesky, d = CASES[case]
    return Config(model=ModelConfig(name=name, dim_in=d, dim_rbf=8,
                                    num_layers=2, cholesky=cholesky),
                  optim=OptimConfig(lr=LR, batch_accumulation=1))


def _records(case):
    _, cholesky, _ = CASES[case]
    return synthetic_dataset(DP * G_PER, mean_atoms=10, adp=cholesky,
                             seed=0)


def _shards(case):
    recs = _records(case)
    return [collate(recs[i * G_PER:(i + 1) * G_PER], N_PER, E_PER, G_PER)
            for i in range(DP)]


def _union(case):
    return collate(_records(case), DP * N_PER, DP * E_PER, DP * G_PER)


def _state(case, sd):
    cfg = _cfg(case)
    model = create_model(cfg.model, "cpu", 0)
    model.load_state_dict(sd, strict=True)
    opt = schedule.make_optimizer(model.parameters(), LR, TOTAL, 0.01)
    return cfg, loop.init_train_state(model, opt)


@contextlib.contextmanager
def _path(case):
    """CartNet's merged backward (FusedEdgeSigma, its BN merge inside the
    Function) for the merged case, the default path otherwise."""
    kept = os.environ.get("CARTNET_MERGED")
    os.environ["CARTNET_MERGED"] = "1" if case == "cartnet_merged" else "0"
    try:
        yield
    finally:
        if kept is None:
            del os.environ["CARTNET_MERGED"]
        else:
            os.environ["CARTNET_MERGED"] = kept


def _step_result(state, stats) -> dict:
    """Loss, stats, gradients and BN buffers after the micro-step."""
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    return {"stats": {k: float(v) for k, v in stats.items()},
            "grads": {n: g.clone() for n, g in zip(names,
                                                   state.grad_accum)},
            "bn": {n: b.clone() for n, b in model.named_buffers()}}


def _after_update(state) -> dict:
    return {n: p.detach().clone()
            for n, p in state.model.named_parameters()}


def _fused_members(rank):
    """This rank's members of the fused chunk's 4 micro-steps: both ranks
    real; rank 0 real and rank 1 a pad; both pads; both real."""
    mine = _shards("cartnet_cholesky")[rank]
    return [mine, mine if rank == 0 else all_masked(mine),
            all_masked(mine), mine]


def _fused_union():
    """The single process's 4 micro-steps on the union batches: the union,
    rank 0's crystals alone at the union's pad shape, a pad, the union."""
    union = _union("cartnet_cholesky")
    alone = collate(_records("cartnet_cholesky")[:G_PER], DP * N_PER,
                    DP * E_PER, DP * G_PER)
    return [union, alone, all_masked(union), union]


def _fused_run(batches, sd, group=None, accum=2) -> dict:
    """A fused chunk over ``batches`` (data-parallel over ``group``, or in
    one process) from the state dict ``sd`` with ``batch_accumulation``
    ``accum``: its stats, accumulator, BN buffers, weights and counters."""
    cfg, state = _state("cartnet_cholesky", sd)
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, batch_accumulation=accum))
    k = len(batches)
    chunk = (loop.make_fused_chunk(cfg, k) if group is None
             else make_parallel_fused_chunk(cfg, group, k))
    with _path("cartnet_cholesky"):
        stats = ChunkRunner(chunk, k, "cpu", group)(state, batches)
    out = _step_result(state, {})
    out.update(stats={n: v.clone() for n, v in stats.items()},
               params=_after_update(state),
               counts=(int(state.accum_count), int(state.bad_steps),
                       int(state.optimizer.count_t)))
    return out


def _worker(rank, coordinator, out_dir, weights, cli_coordinators):
    """One rank: every case's dp micro-step and update on its shard, then
    the CLI as rank ``rank`` of two --coordinator runs: training, and the
    inference sweep."""
    torch.set_num_threads(1)
    group = pdist.initialize_distributed(coordinator, DP, rank, "cpu")
    assert (pdist.rank(), pdist.world(), pdist.is_main()) == (
        rank, DP, rank == 0)
    assert dist.get_backend() == "gloo"
    res = {}
    for case in CASES:
        cfg, state = _state(case, weights[case])
        micro, update, _ = make_parallel_steps(cfg, group)
        with _path(case):
            state, stats = micro(state, _shards(case)[rank].to("cpu"))
        res[case] = _step_result(state, stats)
        state = update(state)
        res[case]["params"] = _after_update(state)
    # the fused chunk, and its first two micro-steps' accumulated gradient
    sd = weights["cartnet_cholesky"]
    res["fused"] = _fused_run(_fused_members(rank), sd, group)
    res["fused_acc"] = _fused_run(_fused_members(rank)[:2], sd, group, 99)
    try:  # on the card, a gloo group cannot be captured
        ChunkRunner(None, 4, "cuda", group)
    except ValueError as err:
        res["fused_gloo_cuda"] = str(err)
    dist.destroy_process_group()
    os.chdir(out_dir)
    ranked = lambda i: ["--coordinator", cli_coordinators[i],
                        "--num_processes", str(DP), "--process_id",
                        str(rank)]
    state, test = cli.main(CLI_ARGV + ["--batch", "2", "--name", "coord"]
                           + ranked(0))
    res["cli"] = {"step": state.step, "test": test,
                  "params": _after_update(state)}
    res["sweep"] = cli.main(SWEEP_ARGV + ranked(1))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _jax_case(case):
    """The JAX package's initial weights and its dp = 2, ep = 1 micro-step
    and update on the same shards -> (port state_dict of the initial
    weights, loss, gradients, BN stats, updated params as port dicts)."""
    import jax

    from cartnet_tpu.config import Config as JConfig
    from cartnet_tpu.config import DataConfig as JDataConfig
    from cartnet_tpu.config import ModelConfig as JModelConfig
    from cartnet_tpu.config import OptimConfig as JOptimConfig
    from cartnet_tpu.data.batching import collate as jcollate
    from cartnet_tpu.models.cartnet import cartnet_apply, cartnet_init
    from cartnet_tpu.parallel.mesh import make_mesh
    from cartnet_tpu.parallel.step import (make_parallel_steps as jsteps,
                                           stack_for_shards)
    from cartnet_tpu.train import loop as jloop
    from cartnet_tpu.train import schedule as jsched
    from cartnet_tpu_torch.interop import params_from_jax

    _, cholesky, d = CASES[case]
    jcfg = JConfig(model=JModelConfig(dim_in=d, dim_rbf=8, num_layers=2,
                                      cholesky=cholesky),
                   data=JDataConfig(max_nodes=N_PER, max_edges=E_PER,
                                    max_graphs=G_PER),
                   optim=JOptimConfig(lr=LR, batch_accumulation=1))
    recs = _records(case)
    stacked = stack_for_shards(
        [jcollate(recs[i * G_PER:(i + 1) * G_PER], N_PER, E_PER, G_PER)
         for i in range(DP)], ep=1)
    opt = jsched.make_optimizer(LR, TOTAL, 0.01)
    state = jloop.init_train_state(jax.random.key(0), jcfg, cartnet_init,
                                   opt)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    mcfg = _cfg(case).model
    init = params_from_jax(np_tree(state.params), np_tree(state.bn_state),
                           mcfg)
    micro, update, _ = jsteps(jcfg, cartnet_apply, opt, make_mesh(DP, 1))
    state, stats = micro(state, stacked)
    ref = params_from_jax(np_tree(state.grad_accum), np_tree(state.bn_state),
                          mcfg)
    out = {"stats": {k: float(v) for k, v in stats.items()},
           "grads": ref, "bn": ref}
    state = update(state)
    out["params"] = params_from_jax(np_tree(state.params),
                                    np_tree(state.bn_state), mcfg)
    return init, out


def _union_case(case, sd):
    """The port's single-process micro-step and update on the union
    batch."""
    cfg, state = _state(case, sd)
    micro, update, _ = loop.make_steps(cfg)
    with _path(case):
        state, stats = micro(state, _union(case).to("cpu"))
    out = _step_result(state, stats)
    out["params"] = _after_update(update(state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results, the references and the single-process CLI run
    on the union batches."""
    out = tmp_path_factory.mktemp("dp")
    weights, refs = {}, {}
    for case in ("cartnet_cholesky", "cartnet_scalar"):
        weights[case], refs[case] = _jax_case(case)
    weights["cartnet_merged"] = weights["cartnet_cholesky"]
    weights["ecomformer"] = create_model(_cfg("ecomformer").model, "cpu",
                                         7).state_dict()
    singles = {case: _union_case(case, weights[case]) for case in CASES}
    sd = weights["cartnet_cholesky"]
    singles["fused"] = _fused_run(_fused_union(), sd)
    singles["fused_acc"] = _fused_run(_fused_union()[:2], sd, accum=99)
    pdist.spawn(_worker, DP, (str(out), weights,
                              [f"localhost:{pdist.free_port()}"
                               for _ in range(2)]))
    ranks = []
    for r in range(DP):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    single = out / "single"
    single.mkdir()
    cwd = os.getcwd()
    os.chdir(single)
    try:
        state, test = cli.main(CLI_ARGV + ["--batch", "4", "--name",
                                           "single"])
        sweep = cli.main(SWEEP_ARGV)
    finally:
        os.chdir(cwd)
    return out, ranks, weights, refs, singles, (state, test, sweep)


def _group(name: str) -> str:
    """A parameter's layer: the encoder, layers.i / conv.i, the head."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] in ("layers",) else parts[0]


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _layer_errors(got: dict, ref: dict) -> dict:
    """Each layer's largest gradient error over its largest value."""
    groups = {}
    for n in got:
        groups.setdefault(_group(n), []).append(n)
    out = {}
    for g, names in groups.items():
        a = torch.cat([got[n].reshape(-1) for n in names])
        b = torch.cat([torch.as_tensor(ref[n]).reshape(-1) for n in names])
        assert float(b.abs().max()) > 0, g
        out[g] = _rel(a, b)
    return out


def _check(got: dict, ref: dict, case: str, slack=None) -> None:
    """``got`` (a rank's step) against a reference step; ``slack``: each
    layer's allowance beyond 1e-5."""
    for k, v in ref["stats"].items():
        if case == "ecomformer" and k == "volume_percentage_error":
            continue
        assert abs(got["stats"][k] - v) <= 1e-5 * abs(v), (k, v)
    for g, err in _layer_errors(got["grads"], ref["grads"]).items():
        assert err <= max(1e-5, (slack or {}).get(g, 0.0)), (g, err)
    for n, buf in got["bn"].items():
        if n.endswith("num_batches_tracked"):
            assert int(buf) == int(ref["bn"][n]) == 1, n
        else:
            assert _rel(buf, ref["bn"][n]) <= 1e-5, n
    checked = total = 0
    for n, p in got["params"].items():
        g = torch.as_tensor(ref["grads"][n])
        sure = (g.abs() >= 1e-6) & (g.abs() >= 10 * (got["grads"][n]
                                                      - g).abs())
        diff = (p - torch.as_tensor(ref["params"][n])).abs()[sure]
        if sure.any():
            assert float(diff.max()) <= 1e-6 + 1e-3 * LR, n
        checked, total = checked + int(sure.sum()), total + g.numel()
    assert checked >= 0.5 * total, (checked, total)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_single_process_union_step(runs, case):
    _, ranks, weights, _, singles, _ = runs
    for res in ranks:
        _check(res[case], singles[case], case)
    # the ranks agree to the bit: same gradients, stats and weights
    a, b = ranks
    for k in ("grads", "bn", "params"):
        for n in a[case][k]:
            assert torch.equal(a[case][k][n], b[case][k][n]), (k, n)
    assert a[case]["stats"] == b[case]["stats"]
    # the update is the single-process one, on the summed gradients
    cfg, state = _state(case, weights[case])
    for acc, n in zip(state.grad_accum, a[case]["grads"]):
        acc.copy_(a[case]["grads"][n])
    state = loop.make_steps(cfg)[1](state)
    for n, p in _after_update(state).items():
        assert torch.equal(p, a[case]["params"][n]), n


def test_dp_fused_chunk_matches_single_process_fused_chunk(runs):
    """The fused chunk over two gloo ranks (K = 4, batch_accumulation 2:
    valid, valid with rank 1's member a pad, a pad on both, valid; one
    update on the device after the second) against the single-process
    fused chunk on the union batches: the valid flags and counters
    exactly, the per-step stats and the last step's accumulated gradients
    (each layer) within 1e-5, the BN buffers within 1e-4 (the last step
    runs on the updated weights, where Adam's direction is noise up to 2
    lr apart: 1.2e-5 here), the weights as in ``_check`` (the first two
    steps' accumulated gradients deciding where the update's direction is
    determined); both ranks to the bit. A gloo group on the card
    raises."""
    _, ranks, _, _, singles, _ = runs
    ref, ref_acc = singles["fused"], singles["fused_acc"]
    assert ref["stats"]["valid"].tolist() == [1.0, 1.0, 0.0, 1.0]
    assert ref["counts"] == (1, 0, 1)
    for res in ranks:
        got = res["fused"]
        assert got["counts"] == ref["counts"]
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=1e-5,
                                       err_msg=k)
        for g, err in _layer_errors(got["grads"], ref["grads"]).items():
            assert err <= 1e-5, (g, err)
        for n, buf in got["bn"].items():
            if n.endswith("num_batches_tracked"):
                assert int(buf) == int(ref["bn"][n]) == 3, n
            else:
                assert _rel(buf, ref["bn"][n]) <= 1e-4, n
        checked = total = 0
        for n, p in got["params"].items():
            g, mine = ref_acc["grads"][n], res["fused_acc"]["grads"][n]
            sure = (g.abs() >= 1e-6) & (g.abs() >= 10 * (mine - g).abs())
            diff = (p - ref["params"][n]).abs()[sure]
            if sure.any():
                assert float(diff.max()) <= 1e-6 + 1e-3 * LR, n
            checked, total = checked + int(sure.sum()), total + g.numel()
        assert checked >= 0.5 * total, (checked, total)
        assert "NCCL" in res["fused_gloo_cuda"]
    a, b = (r["fused"] for r in ranks)
    for k in ("grads", "bn", "params", "stats"):
        for n in a[k]:
            assert torch.equal(a[k][n], b[k][n]), (k, n)


@pytest.mark.parametrize("case", ["cartnet_cholesky", "cartnet_scalar"])
def test_dp_step_matches_jax_dp_step(runs, case):
    _, ranks, _, refs, singles, _ = runs
    own = _layer_errors(singles[case]["grads"], refs[case]["grads"])
    for res in ranks:
        _check(res[case], refs[case], case,
               slack={g: 1.5 * e for g, e in own.items()})


def test_cli_coordinator_takes_one_step(runs):
    """Two --coordinator ranks over tcp:// on the CPU: one optimizer step,
    the same weights on both ranks, one stats line per split (rank 0's),
    and the single-process run on the union batches within Adam's noise
    (as above)."""
    out, ranks, _, _, _, (state, test, _) = runs
    a, b = ranks[0]["cli"], ranks[1]["cli"]
    assert a["step"] == b["step"] == state.step == 1
    for n, p in a["params"].items():
        assert torch.equal(p, b["params"][n]), n
        ref = dict(state.model.named_parameters())[n].detach()
        assert float((p - ref).abs().max()) <= 1e-6 + 1e-3 * LR, n
    same = ("MAE", "MSE", "loss", "similarity_index",
            "volume_percentage_error", "iou", "epoch", "lr", "params")
    assert all(a["test"].get(k) == b["test"].get(k) for k in same)
    for k in ("MAE", "MSE", "loss"):
        assert abs(a["test"][k] - test[k]) <= 1e-4 * abs(test[k]), k
    for split in ("train", "val", "test"):
        with open(out / "results" / "coord" / "0" / split /
                  "stats.json") as f:
            assert len(f.readlines()) == 1, split


def test_cli_coordinator_sweep_gathers_on_rank_0(runs):
    """The inference sweep over two ranks: rank 0 returns and writes every
    structure, in the single-process order and bitwise its predictions;
    rank 1 returns None."""
    out, ranks, _, _, _, (_, _, sweep) = runs
    got = ranks[0]["sweep"]
    assert ranks[1]["sweep"] is None and len(got["pred"]) == 4
    assert got.keys() == sweep.keys()
    assert got["refcode"] == sweep["refcode"] == [0, 1, 2, 3]
    for k in ("pred", "true", "atoms", "iou", "similarity_index"):
        for a, b in zip(got[k], sweep[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert got["mae"] == sweep["mae"]
    with open(out / "sweep.pkl", "rb") as f:
        assert pickle.load(f)["refcode"] == [0, 1, 2, 3]


def test_dp_raises_for_what_is_not_ported(runs, tmp_path, monkeypatch):
    """--chunks 2, once the one layout not ported, now runs the same
    single-process run to finite test stats (tests/test_torch_port_chunked.py
    holds it against the JAX package); --halo with --ep 1 runs as plain
    data parallelism (here one process: the same run as without it);
    --dp 2 --ep 2 on the card asks for 4 cards."""
    _, _, _, _, _, (_, test, _) = runs
    monkeypatch.chdir(tmp_path)
    _, chunk_test = cli.main(CLI_ARGV + ["--name", "chunks", "--chunks",
                                         "2"])
    assert chunk_test.keys() == test.keys()
    assert all(np.isfinite(v) for v in chunk_test.values()), chunk_test
    _, halo_test = cli.main(CLI_ARGV + ["--batch", "4", "--name", "halo",
                                        "--halo"])
    for k in ("MAE", "MSE", "loss"):
        assert halo_test[k] == test[k], k
    # one card a rank, and no fall back to the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--dp 2 needs 2 CUDA devices"):
        pdist.check_cards(2, "cuda")
    pdist.check_cards(2, "cpu")
    with pytest.raises(RuntimeError,
                       match="--dp 2 --ep 2 needs 4 CUDA devices"):
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: True)
            cli.main(CLI_ARGV[:-1] + ["cuda", "--dp", "2", "--ep", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(CLI_ARGV[:-1] + ["cuda", "--dp", "2"])
    with pytest.raises(ValueError, match="--num_processes"):
        cli.main(CLI_ARGV + ["--dp", "3", "--coordinator", "localhost:1",
                             "--num_processes", "2", "--process_id", "0"])
    assert pdist.initialize_distributed(None) is None
    assert (pdist.rank(), pdist.world(), pdist.is_main()) == (0, 1, True)
    assert pdist.backend_for("cpu") == "gloo"
    assert pdist.backend_for("cuda") == "nccl"


# ------------------------------------------------------------ pipeline

class _ListPipe(list):
    pass


def _pipe(n_batches, seed=0):
    recs = synthetic_dataset(n_batches * G_PER, mean_atoms=10, adp=False,
                             seed=seed)
    return _ListPipe(collate(recs[i * G_PER:(i + 1) * G_PER], N_PER, E_PER,
                             G_PER) for i in range(n_batches))


@pytest.mark.parametrize("n,dp", [(4, 2), (5, 2), (3, 4), (7, 1)])
def test_sharded_steps_match_pipeline_length(n, dp):
    """Every rank takes sharded_steps_per_epoch steps: member r of each
    group, and an all-masked batch past a short group's end."""
    pipe = _pipe(n)
    for r in range(dp):
        got = list(ShardedPipeline(pipe, dp, r))
        assert len(got) == len(ShardedPipeline(pipe, dp, r)) == \
            sharded_steps_per_epoch(n, dp)
        for s, b in enumerate(got):
            i = s * dp + r
            if i < n:
                assert b is pipe[i]
            else:
                assert not b.node_mask.any() and not b.edge_mask.any()
                assert not b.graph_mask.any()
                np.testing.assert_array_equal(b.edge_dst, pipe[-1].edge_dst)


def test_sharded_pipeline_bucket_boundaries():
    """Groups never span a bucket boundary, and the length counts the
    groups of each bucket (the schedule is built from it)."""
    recs = synthetic_dataset(10, mean_atoms=10, adp=False, seed=9)
    pipe = BatchPipeline(recs, batch_size=2, shuffle=False, augment=False,
                         buckets=2, prefetch=0)
    assert pipe.bucket_batch_counts() == [3, 3]
    per_rank = [list(ShardedPipeline(pipe, 2, r)) for r in range(2)]
    assert len(per_rank[0]) == len(per_rank[1]) == len(
        ShardedPipeline(pipe, 2)) == 4
    flat = list(pipe.iter_with_bucket())
    # bucket 0: batches 0, 1 | 2, dummy; bucket 1: 3, 4 | 5, dummy
    want = [[flat[0], flat[2], flat[3], flat[5]],
            [flat[1], None, flat[4], None]]
    for r in range(2):
        for got, w in zip(per_rank[r], want[r]):
            if w is None:
                assert not got.node_mask.any()
            else:
                assert got is w[1]
    masked = all_masked(flat[0][1])
    assert masked.z is flat[0][1].z and not masked.non_h_mask.any()
