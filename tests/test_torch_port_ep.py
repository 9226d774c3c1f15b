"""Edge parallelism (``--ep``) over ``torch.distributed`` (gloo, four
processes on the CPU: dp 2 x ep 2) against the JAX package's (dp 2, ep 2)
step and the port's own single-process step on the union batch.

One spawn of four ranks serves the whole file (``runs``): each rank joins
a gloo group, builds its ``Groups`` (``pdist.make_groups(2, 2)``: its dp
slice's ep group, its node-stat group across dp, the world), and for each
case runs the eval forward, one micro-step and one update on its share of
its dp slice (``partition.ep_member``: its half of the slice's edges with
plans of their own, the loss mask split over the members) through
``parallel.step.make_parallel_steps``; then a fused chunk of four
micro-steps (``make_parallel_fused_chunk``, eager on the CPU, with pad
members) against the single-process fused chunk on the union batches;
then it leaves the group, and the four run the CLI as the ranks of two
``--dp 2 --ep 2 --coordinator`` runs (training, and the inference sweep
gathered on rank 0). The references are computed in this process:

  * CartNet (D = 16, 2 layers; Cholesky and scalar heads): the JAX
    package's ``make_parallel_steps`` on a (dp 2, ep 2) mesh of its 8
    virtual CPU devices, same weights (``params_from_jax``), same shards;
    and the port's single-process step on the union of the two slices;
  * CartNet under ``CARTNET_MERGED=1``, the eComformer and the iComformer
    (D = 32): the port's single-process union step only (the JAX
    package's sharded Comformer steps fail at this tree).

Tolerances are tests/test_torch_port_dp.py's: the loss and the epoch
stats, each layer's gradients (its largest error over its largest value)
and the BN running stats within 1e-5 relative of every reference; against
the JAX step, where the port's own single-process step is farther from it
than that (the gate path's window moments, ROADMAP §3b), 1.5 times as far;
against the union step, where two single-process steps on the same
crystals in another order are farther apart than that (their rounding
floor: the iComformer's edge update), 1.5 times as far;
the updated weights within 1e-6 + 1e-3 lr where Adam's direction is
determined. The eval forward's predictions (each member's, copied) within
1e-5 of the single-process eval on the union batch, and of the JAX eval.
The eComformer's and the iComformer's volume error are left out: with
random weights their predicted ellipsoids are near singular, where that
ratio has no precision.
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
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import all_masked, collate
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.parallel import dist as pdist
from cartnet_tpu_torch.parallel.partition import ep_member
from cartnet_tpu_torch.parallel.step import (make_parallel_fused_chunk,
                                             make_parallel_steps)
from cartnet_tpu_torch.train import loop, schedule
from cartnet_tpu_torch.train.graphs import ChunkRunner

DP, EP = 2, 2
N_PER, E_PER, G_PER = 64, 1024, 2
LR, TOTAL = 1e-3, 4
CASES = {"cartnet_cholesky": ("cartnet", True, 16),
         "cartnet_merged": ("cartnet", True, 16),  # CARTNET_MERGED=1
         "cartnet_scalar": ("cartnet", False, 16),
         "ecomformer": ("ecomformer", True, 32),
         "icomformer": ("icomformer", True, 32)}
CLI_ARGV = ["--dataset", "synthetic", "--limit", "4",
            "--batch_accumulation", "4", "--epochs", "1", "--dim_in", "16",
            "--dim_rbf", "8", "--num_layers", "2", "--device", "cpu"]
# the sweep over the 4 test crystals of --limit 16, one batch a crystal
SWEEP_ARGV = CLI_ARGV[:2] + ["--limit", "16", "--batch", "1", "--cholesky",
                             "--inference", "--inference_output",
                             "sweep.pkl"] + CLI_ARGV[4:]
EP_ARGV = ["--dp", str(DP), "--ep", str(EP)]


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
    """CartNet's merged backward for the merged case, the default path
    otherwise."""
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
    """This rank's members of the fused chunk's 4 micro-steps: both dp
    slices real; slice 0 real and slice 1 a pad; both pads; both real;
    each cut for the rank's ep index."""
    mine = _shards("cartnet_cholesky")[rank // EP]
    slices = [mine, mine if rank // EP == 0 else all_masked(mine),
              all_masked(mine), mine]
    return [ep_member(b, EP, rank % EP) for b in slices]


def _fused_union():
    union = _union("cartnet_cholesky")
    alone = collate(_records("cartnet_cholesky")[:G_PER], DP * N_PER,
                    DP * E_PER, DP * G_PER)
    return [union, alone, all_masked(union), union]


def _fused_run(batches, sd, group=None, accum=2) -> dict:
    cfg, state = _state("cartnet_cholesky", sd)
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, batch_accumulation=accum))
    k = len(batches)
    chunk = (loop.make_fused_chunk(cfg, k) if group is None
             else make_parallel_fused_chunk(cfg, group, k))
    world = None if group is None else group.edge
    with _path("cartnet_cholesky"):
        stats = ChunkRunner(chunk, k, "cpu", world)(state, batches)
    out = _step_result(state, {})
    out.update(stats={n: v.clone() for n, v in stats.items()},
               params=_after_update(state),
               counts=(int(state.accum_count), int(state.bad_steps),
                       int(state.optimizer.count_t)))
    return out


def _eval(state, batch, evals) -> dict:
    pred, mask, stats = evals(state, batch)
    return {"pred": pred.detach().clone(), "mask": mask.clone(),
            "stats": {k: float(v) for k, v in stats.items()}}


def _worker(rank, coordinator, out_dir, weights, cli_coordinators):
    """One rank: every case's eval, micro-step and update on its share,
    the fused chunk, then the CLI as rank ``rank`` of two --coordinator
    runs (training, and the inference sweep)."""
    torch.set_num_threads(1)
    pdist.initialize_distributed(coordinator, DP * EP, rank, "cpu")
    groups = pdist.make_groups(DP, EP)
    assert (groups.ep_size, groups.ep_rank) == (EP, rank % EP)
    res = {}
    for case in CASES:
        cfg, state = _state(case, weights[case])
        micro, update, evals = make_parallel_steps(cfg, groups)
        batch = ep_member(_shards(case)[rank // EP], EP, rank % EP).to("cpu")
        with _path(case):
            ev = _eval(state, batch, evals)
            state, stats = micro(state, batch)
        res[case] = _step_result(state, stats)
        res[case]["eval"] = ev
        state = update(state)
        res[case]["params"] = _after_update(state)
    # a bf16 partial summed over the ep group, and its cotangent
    part = torch.randn(64, generator=torch.Generator().manual_seed(rank))
    part = part.bfloat16().requires_grad_()
    total = pdist.ep_sum(part, groups)
    ct = torch.randn(64, generator=torch.Generator().manual_seed(9 + rank))
    (grad,) = torch.autograd.grad(total, part, ct.bfloat16())
    res["ep_sum"] = (part.detach(), total.detach(), grad)
    sd = weights["cartnet_cholesky"]
    res["fused"] = _fused_run(_fused_members(rank), sd, groups)
    res["fused_acc"] = _fused_run(_fused_members(rank)[:2], sd, groups, 99)
    dist.destroy_process_group()
    os.chdir(out_dir)
    ranked = lambda i: EP_ARGV + ["--coordinator", cli_coordinators[i],
                                  "--num_processes", str(DP * EP),
                                  "--process_id", str(rank)]
    state, test = cli.main(CLI_ARGV + ["--batch", "2", "--name", "coord"]
                           + ranked(0))
    res["cli"] = {"step": state.step, "test": test,
                  "params": _after_update(state)}
    res["sweep"] = cli.main(SWEEP_ARGV + ranked(1))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _jax_case(case):
    """The JAX package's initial weights, its (dp 2, ep 2) eval on them,
    then its micro-step and update on the same shards -> (port state_dict
    of the initial weights, the results as port dicts)."""
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
         for i in range(DP)], ep=EP)
    opt = jsched.make_optimizer(LR, TOTAL, 0.01)
    state = jloop.init_train_state(jax.random.key(0), jcfg, cartnet_init,
                                   opt)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    mcfg = _cfg(case).model
    init = params_from_jax(np_tree(state.params), np_tree(state.bn_state),
                           mcfg)
    micro, update, evals = jsteps(jcfg, cartnet_apply, opt,
                                  make_mesh(DP, EP))
    pred, _, _ = evals(state.params, state.bn_state, stacked)
    state, stats = micro(state, stacked)
    ref = params_from_jax(np_tree(state.grad_accum), np_tree(state.bn_state),
                          mcfg)
    out = {"stats": {k: float(v) for k, v in stats.items()},
           "grads": ref, "bn": ref, "pred": np.asarray(pred)}
    state = update(state)
    out["params"] = params_from_jax(np_tree(state.params),
                                    np_tree(state.bn_state), mcfg)
    return init, out


def _union_case(case, sd, reordered=False):
    """The port's single-process eval, micro-step and update on the union
    batch (``reordered``: with dp slice 1's crystals first)."""
    cfg, state = _state(case, sd)
    micro, update, evals = loop.make_steps(cfg)
    batch = _union(case).to("cpu")
    if reordered:
        recs = _records(case)
        batch = collate(recs[G_PER:] + recs[:G_PER], DP * N_PER, DP * E_PER,
                        DP * G_PER).to("cpu")
    with _path(case):
        ev = _eval(state, batch, evals)
        state, stats = micro(state, batch)
    out = _step_result(state, stats)
    out["eval"] = ev
    out["params"] = _after_update(update(state))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, the references and the single-process CLI
    runs on the union batches."""
    out = tmp_path_factory.mktemp("ep")
    weights, refs = {}, {}
    for case in ("cartnet_cholesky", "cartnet_scalar"):
        weights[case], refs[case] = _jax_case(case)
    weights["cartnet_merged"] = weights["cartnet_cholesky"]
    for case, seed in (("ecomformer", 7), ("icomformer", 8)):
        weights[case] = create_model(_cfg(case).model, "cpu",
                                     seed).state_dict()
    singles = {case: _union_case(case, weights[case]) for case in CASES}
    floors = {case: _layer_errors(_union_case(case, weights[case],
                                              True)["grads"],
                                  singles[case]["grads"])
              for case in CASES}
    sd = weights["cartnet_cholesky"]
    singles["fused"] = _fused_run(_fused_union(), sd)
    singles["fused_acc"] = _fused_run(_fused_union()[:2], sd, accum=99)
    pdist.spawn(_worker, DP * EP, (str(out), weights,
                                   [f"localhost:{pdist.free_port()}"
                                    for _ in range(2)]))
    ranks = []
    for r in range(DP * EP):
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
    return out, ranks, weights, refs, (singles, floors), (state, test,
                                                           sweep)


def _group(name: str) -> str:
    """A parameter's layer: the encoder, layers.i / conv.i, the head."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] in ("layers",) else parts[0]


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(x).double() for x in (a, b))
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _layer_errors(got: dict, ref: dict) -> dict:
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
        if case.endswith("comformer") and k == "volume_percentage_error":
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


def _real_rows(pred, i: int, case: str):
    """(dp slice ``i``'s real rows of a union-batch prediction, the
    number of them): the union holds the slices' nodes and graphs one
    after the other."""
    shards = _shards(case)
    if CASES[case][1]:
        counts = [int(b.node_mask.sum()) for b in shards]
    else:
        counts = [int(b.graph_mask.sum()) for b in shards]
    start = sum(counts[:i])
    return pred[start:start + counts[i]], counts[i]


@pytest.mark.parametrize("case", list(CASES))
def test_ep_step_matches_single_process_union_step(runs, case):
    """Each layer's gradients within 1e-5 of the union step's, or within
    1.5 times the distance between two single-process steps on the same
    crystals in another order, where that rounding floor is larger (the
    iComformer: 4.2e-5 in its edge update, whose [3E, d] products sum
    over every edge in plain PyTorch)."""
    _, ranks, weights, _, (singles, floors), _ = runs
    for res in ranks:
        _check(res[case], singles[case], case,
               slack={g: 1.5 * e for g, e in floors[case].items()})
    # every rank to the bit: the same gradients, stats and weights
    a = ranks[0]
    for b in ranks[1:]:
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


@pytest.mark.parametrize("case", list(CASES))
def test_ep_eval_matches_single_process_union_eval(runs, case):
    """Both ep members of a dp slice predict its rows (copied nodes),
    within 1e-5 of the union eval; the members' stats, weighted by their
    loss partitions as the loggers weight them, give the union's."""
    _, ranks, _, _, (singles, _), _ = runs
    want = singles[case]["eval"]
    sums, weight = {}, 0.0
    for r, res in enumerate(ranks):
        ev = res[case]["eval"]
        ref, n = _real_rows(want["pred"], r // EP, case)
        assert _rel(ev["pred"][:n], ref) <= 1e-5, r
        w = float(ev["mask"].sum())
        weight += w
        for k, v in ev["stats"].items():
            sums[k] = sums.get(k, 0.0) + v * w
    assert weight == float(want["mask"].sum())
    for k, v in want["stats"].items():
        if case.endswith("comformer") and k == "volume_percentage_error":
            continue
        assert abs(sums[k] / weight - v) <= 1e-5 * abs(v), k


def test_ep_fused_chunk_matches_single_process_fused_chunk(runs):
    """The fused chunk over four gloo ranks (K = 4, batch_accumulation 2:
    valid, valid with dp slice 1's members pads, a pad everywhere, valid;
    one update on the device after the second) against the single-process
    fused chunk on the union batches, as tests/test_torch_port_dp.py holds
    its dp fused chunk; every rank to the bit."""
    _, ranks, _, _, (singles, _), _ = runs
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
    a = ranks[0]["fused"]
    for res in ranks[1:]:
        for k in ("grads", "bn", "params", "stats"):
            for n in a[k]:
                assert torch.equal(a[k][n], res["fused"][k][n]), (k, n)


@pytest.mark.parametrize("case", ["cartnet_cholesky", "cartnet_scalar"])
def test_ep_step_matches_jax_ep_step(runs, case):
    """The (dp 2, ep 2) step against the JAX package's on the same mesh
    shape, and the eval forward's predictions against its eval."""
    _, ranks, _, refs, (singles, _), _ = runs
    own = _layer_errors(singles[case]["grads"], refs[case]["grads"])
    cholesky = CASES[case][1]
    for r, res in enumerate(ranks):
        _check(res[case], refs[case], case,
               slack={g: 1.5 * e for g, e in own.items()})
        want = refs[case]["pred"][(r // EP) * (N_PER if cholesky
                                               else G_PER):][
            :N_PER if cholesky else G_PER]
        assert _rel(res[case]["eval"]["pred"], want) <= 1e-5, r


def test_cli_ep_takes_one_step(runs):
    """Four --dp 2 --ep 2 --coordinator ranks over tcp:// on the CPU: one
    optimizer step, the same weights on every rank, one stats line per
    split (rank 0's), and the single-process run on the union batches
    within Adam's noise."""
    out, ranks, _, _, _, (state, test, _) = runs
    a = ranks[0]["cli"]
    for res in ranks:
        b = res["cli"]
        assert b["step"] == state.step == 1
        for n, p in a["params"].items():
            assert torch.equal(p, b["params"][n]), n
        assert all(a["test"].get(k) == b["test"].get(k)
                   for k in ("MAE", "MSE", "loss", "epoch", "lr"))
    for n, p in a["params"].items():
        ref = dict(state.model.named_parameters())[n].detach()
        assert float((p - ref).abs().max()) <= 1e-6 + 1e-3 * LR, n
    for k in ("MAE", "MSE", "loss"):
        assert abs(a["test"][k] - test[k]) <= 1e-4 * abs(test[k]), k
    for split in ("train", "val", "test"):
        with open(out / "results" / "coord" / "0" / split /
                  "stats.json") as f:
            assert len(f.readlines()) == 1, split


def test_cli_ep_sweep_gathers_on_rank_0(runs):
    """The inference sweep over dp 2 x ep 2 ranks: rank 0 returns and
    writes every structure in the single-process order, the predictions
    within 1e-5 of the single process's (the aggregates are summed over
    the members); the other ranks return None."""
    out, ranks, _, _, _, (_, _, sweep) = runs
    got = ranks[0]["sweep"]
    assert all(r["sweep"] is None for r in ranks[1:])
    assert got.keys() == sweep.keys()
    assert got["refcode"] == sweep["refcode"] == [0, 1, 2, 3]
    for k in ("true", "atoms"):
        for a, b in zip(got[k], sweep[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    for a, b in zip(got["pred"], sweep["pred"]):
        assert _rel(a, b) <= 1e-5
    np.testing.assert_allclose(got["mae"], sweep["mae"], rtol=1e-4)
    with open(out / "sweep.pkl", "rb") as f:
        assert pickle.load(f)["refcode"] == [0, 1, 2, 3]


def test_ep_sum_rounds_bf16_once(runs):
    """A bf16 partial crosses the ep group as f32 and is rounded once
    after the sum (ROADMAP §3b): both members of a dp slice hold
    bf16(f32(a) + f32(b)); the backward gives each member the sum of the
    members' cotangents, rounded once to bf16."""
    _, ranks, _, _, _, _ = runs
    for s in range(DP):
        a, b = (ranks[s * EP + m]["ep_sum"] for m in range(EP))
        want = (a[0].float() + b[0].float()).bfloat16()
        cts = [torch.randn(64, generator=torch.Generator().manual_seed(
            9 + s * EP + m)).bfloat16().float() for m in range(EP)]
        for r in (a, b):
            assert r[1].dtype == torch.bfloat16
            assert torch.equal(r[1], want)
            assert torch.equal(r[2], (cts[0] + cts[1]).bfloat16())
