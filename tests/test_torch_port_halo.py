"""Halo partitioning (``--halo``): the port's host planner against the JAX
package's, and its halo steps over four gloo ranks (dp 2 x ep 2) on the
CPU.

Host side, no processes: ``parallel/halo.to_halo`` against the JAX
package's ``to_halo`` array for array on the batches of
tests/test_halo.py (graphs that fit a member, one crystal too big for a
member, the chain crystal), at ep = 2 and 4; ``HaloInfeasible`` on the same
inputs; ``comms_bytes_per_layer`` equal. (Where its Pallas window plans
hold, the JAX planner reorders each member's windows interior-first, a TPU
overlap of the exchange with a first kernel call that the port does not
copy; on these batches they do not hold, and both keep the member's
dst-sorted order.) Then ``halo_member``'s plans: dst-sorted member edges,
``dst_rowptr`` over the member's rows, the src plan over its table.

Devices side: one spawn of four ranks serves the file (``runs``). Each
rank joins a gloo group, builds ``make_groups(2, 2, halo=True)``, and
takes one micro-step of each case on its block of its dp slice's halo
layout (``ShardedPipeline``'s cut), after one eval forward:

  * CartNet (D = 16, 2 layers, Cholesky head) on a snapped batch (two
    crystals a slice that fit whole members: an empty halo, no exchange)
    and on a split batch (one crystal a slice, cut across the members):
    against the JAX package's halo step (``make_parallel_steps(...,
    halo=True)`` on a (2, 2) mesh of its virtual CPU devices, same
    weights) and against the port's single-process step on the union
    batch;
  * the eComformer and the iComformer (D = 32, the iComformer's edge
    graph ids by gather) on the split batch: against the port's
    single-process union step only (the JAX package's halo Comformer
    steps fail at this tree, ROADMAP §3b).

Tolerances are those of tests/test_torch_port_dp.py: loss and stats, each
layer's gradients and the BN running stats within 1e-5 relative of the
reference; against the JAX step, where the port's own single-process step
is farther from it (the gate path's window moments), 1.5 times that. The
eval forward's predictions, owned rows reassembled in the slice's order,
within 1e-5 of the single-process eval on the union batch.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.parallel import dist as pdist
from cartnet_tpu_torch.parallel.halo import (HaloInfeasible,
                                             comms_bytes_per_layer, to_halo)
from cartnet_tpu_torch.parallel.partition import halo_member
from cartnet_tpu_torch.parallel.step import make_parallel_steps
from cartnet_tpu_torch.runner import ShardedPipeline
from cartnet_tpu_torch.train import loop, schedule

DP, EP = 2, 2
N_PER, E_PER, G_PER = 64, 2048, 4
LR, TOTAL = 1e-3, 4
H_MAX = 16
JAX_FIELDS = ("z", "pos", "graph_id", "node_mask", "non_h_mask", "y",
              "edge_src", "edge_dst", "cart_dist", "cart_dir", "edge_mask",
              "cell", "temperature", "graph_mask", "halo_send_idx",
              "halo_send_mask")


# ------------------------------------------------------------ host side

def _chain_graph(cholesky, n=48):
    """tests/test_halo.py's chain crystal: atoms on a line, each coupled
    to its neighbours within 2 (contiguous cuts have an O(1) boundary)."""
    rng = np.random.default_rng(7)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = np.arange(n, dtype=np.float32)
    src, dst = [], []
    for d in (1, 2):
        a = np.arange(n - d)
        src += [a, a + d]
        dst += [a + d, a]
    src = np.concatenate(src).astype(np.int64)
    dst = np.concatenate(dst).astype(np.int64)
    vec = pos[src] - pos[dst]
    dist_ = np.linalg.norm(vec, axis=1).astype(np.float32)
    rec = {"z": rng.integers(2, 60, n).astype(np.int32), "pos": pos,
           "cell": np.eye(3, dtype=np.float32) * (n + 10.0),
           "edge_src": src, "edge_dst": dst, "cart_dist": dist_,
           "cart_dir": (vec / dist_[:, None]).astype(np.float32),
           "temperature": 100.0}
    if cholesky:
        a = rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.3
        rec["y"] = np.einsum("nij,nkj->nik", a, a) + 0.2 * np.eye(
            3, dtype=np.float32)
    else:
        rec["y"] = np.float32(rng.normal())
    return rec


HOST_BATCHES = {
    # tests/test_halo.py's batches: four 8-atom crystals, one 40-atom
    # crystal, the 48-atom chain
    "separable": lambda: (synthetic_dataset(4, mean_atoms=8, adp=False,
                                            seed=0), 64, 2048),
    "one_big_graph": lambda: (synthetic_dataset(1, mean_atoms=40, adp=True,
                                                seed=1), 64, 2048),
    "chain": lambda: ([_chain_graph(False)], 64, 512),
}


def _both(name):
    """The batch collated by both packages (identical arrays)."""
    from cartnet_tpu.data.batching import collate as jcollate
    recs, n, e = HOST_BATCHES[name]()
    return collate(recs, n, e, 4), jcollate(recs, n, e, 4)


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("name", sorted(HOST_BATCHES))
def test_to_halo_matches_jax(name, ep):
    from cartnet_tpu.parallel.halo import comms_bytes_per_layer as jbytes
    from cartnet_tpu.parallel.halo import to_halo as jto_halo
    tb, jb = _both(name)
    h_max = H_MAX if ep == 4 else None  # ep 2 halves ship up to n_per rows
    got, want = to_halo(tb, ep, h_max), jto_halo(jb, ep, h_max)
    # the JAX planner kept the dst-sorted order (no Pallas plan here)
    assert not (want.edge_fuse_ok and not want.halo_empty)
    for k in JAX_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.halo_empty == want.halo_empty
    assert got.halo_empty == (name == "separable")
    for dim in (16, 256):
        assert comms_bytes_per_layer(got, dim) == jbytes(want, dim)


@pytest.mark.parametrize("name,ep,h_max", [("chain", 4, 1),
                                           ("one_big_graph", 2, 2),
                                           ("separable", 3, None)])
def test_to_halo_raises_where_jax_raises(name, ep, h_max):
    """A halo past ``h_max`` rows, and pad sizes that do not split over
    ep, raise HaloInfeasible in both planners."""
    from cartnet_tpu.parallel.halo import HaloInfeasible as JInfeasible
    from cartnet_tpu.parallel.halo import to_halo as jto_halo
    tb, jb = _both(name)
    with pytest.raises(JInfeasible):
        jto_halo(jb, ep, h_max)
    with pytest.raises(HaloInfeasible):
        to_halo(tb, ep, h_max)


def test_to_halo_raises_on_edge_caps():
    """Two crystals whose edges overflow a member's edge share, even cut
    mid-graph: no layout fits, in either planner."""
    from cartnet_tpu.data.batching import collate as jcollate
    from cartnet_tpu.parallel.halo import HaloInfeasible as JInfeasible
    from cartnet_tpu.parallel.halo import to_halo as jto_halo
    recs = synthetic_dataset(2, mean_atoms=24, adp=False, seed=4)
    e = sum(len(r["edge_src"]) for r in recs)
    e = -(-e // 4) * 4
    for planner, batch, err in ((to_halo, collate(recs, 64, e, 2),
                                 HaloInfeasible),
                                (jto_halo, jcollate(recs, 64, e, 2),
                                 JInfeasible)):
        with pytest.raises(err):
            planner(batch, 4, None)


@pytest.mark.parametrize("name", sorted(HOST_BATCHES))
def test_halo_member_plans(name):
    """Each member's block: dst-sorted local edges and ``dst_rowptr`` over
    its n_per rows; the src plan sorts its sources over the table of
    n_per + ep·H rows; ``src_degree`` counts every real edge of the slice
    out of each owned row; received slots hold the rows their owners send
    (the table an exchange would give)."""
    tb, _ = _both(name)
    hb = to_halo(tb, EP)
    n_per = tb.num_nodes // EP
    h = n_per
    table_rows = n_per + EP * h
    # the slice's rows of each member's table, by original node id
    owner_rows = [np.flatnonzero(hb.node_mask[m * n_per:(m + 1) * n_per])
                  for m in range(EP)]
    start = np.cumsum([0] + [len(r) for r in owner_rows])
    deg = np.bincount(tb.edge_src[tb.edge_mask],
                      minlength=tb.num_nodes)
    for m in range(EP):
        mb = halo_member(hb, EP, m)
        assert mb.halo and mb.num_nodes == n_per
        real = mb.edge_mask
        assert (np.diff(mb.edge_dst) >= 0).all()
        np.testing.assert_array_equal(
            mb.dst_rowptr, np.searchsorted(mb.edge_dst,
                                           np.arange(n_per + 1)))
        assert mb.src_rowptr.shape == (table_rows + 1,)
        srt = mb.edge_src[mb.edge_src_perm]
        assert (np.diff(srt) >= 0).all()
        np.testing.assert_array_equal(mb.edge_mask_src_sorted,
                                      real[mb.edge_src_perm])
        own = np.arange(start[m], start[m + 1])
        np.testing.assert_array_equal(mb.src_degree[:len(own)], deg[own])
        # a received slot's row: the owner's local row it sends
        table = np.full(table_rows, -1)
        table[:len(own)] = own
        for r in range(EP):
            o = (m + 1 + r) % EP
            idx = np.asarray(hb.halo_send_idx)[o, m]
            sent = np.asarray(hb.halo_send_mask)[o, m]
            base = n_per + r * h
            table[base:base + h][sent] = start[o] + idx[sent]
        # every real edge's src is a real row of the slice, its dst too
        dst_g = start[m] + mb.edge_dst[real]
        src_g = table[mb.edge_src[real]]
        assert (src_g >= 0).all()
        pairs = set(zip(tb.edge_dst[tb.edge_mask], tb.edge_src[tb.edge_mask]))
        assert set(zip(dst_g, src_g)) <= pairs
    assert sum(halo_member(hb, EP, m).edge_mask.sum()
               for m in range(EP)) == tb.edge_mask.sum()


# ---------------------------------------------------------- device side

CASES = {"cartnet_snapped": ("cartnet", 16, "snapped"),
         "cartnet_split": ("cartnet", 16, "split"),
         "ecomformer": ("ecomformer", 32, "split"),
         "icomformer": ("icomformer", 32, "split")}
SWEEP_ARGV = ["--dataset", "synthetic", "--limit", "16", "--batch", "2",
              "--cholesky", "--inference", "--inference_output",
              "sweep.pkl", "--dim_in", "16", "--dim_rbf", "8",
              "--num_layers", "2", "--device", "cpu"]


def _cfg(case) -> Config:
    name, d, _ = CASES[case]
    return Config(model=ModelConfig(name=name, dim_in=d, dim_rbf=8,
                                    num_layers=2, cholesky=True),
                  optim=OptimConfig(lr=LR, batch_accumulation=1))


def _slices(case):
    """Each dp slice's records: two 10-atom crystals (they fit whole
    members: an empty halo) or one 40-atom crystal (cut across the
    members)."""
    if CASES[case][2] == "snapped":
        recs = synthetic_dataset(2 * DP, mean_atoms=10, adp=True, seed=0)
        return [recs[2 * i:2 * i + 2] for i in range(DP)]
    recs = synthetic_dataset(DP, mean_atoms=40, adp=True, seed=1)
    return [[r] for r in recs]


def _shards(case):
    return [collate(s, N_PER, E_PER, G_PER) for s in _slices(case)]


def _union(case):
    recs = [r for s in _slices(case) for r in s]
    return collate(recs, DP * N_PER, DP * E_PER, DP * G_PER)


def _state(case, sd):
    cfg = _cfg(case)
    model = create_model(cfg.model, "cpu", 0)
    model.load_state_dict(sd, strict=True)
    opt = schedule.make_optimizer(model.parameters(), LR, TOTAL, 0.01)
    return cfg, loop.init_train_state(model, opt)


def _member(case, rank):
    """This rank's block of its dp slice's halo layout, as
    ``ShardedPipeline`` cuts it."""
    pipe = ShardedPipeline(_shards(case), DP, rank, EP, halo=True)
    return next(iter(pipe))


def _worker(rank, coordinator, out_dir, weights, sweep_coordinator):
    """One rank: every case's eval and micro-step on its block, then the
    halo sweep as rank ``rank`` of a --coordinator run."""
    from test_torch_port_ep import _eval, _step_result
    torch.set_num_threads(1)
    pdist.initialize_distributed(coordinator, DP * EP, rank, "cpu")
    groups = pdist.make_groups(DP, EP, halo=True)
    assert groups.node is groups.edge
    res = {}
    for case in CASES:
        cfg, state = _state(case, weights[case])
        micro, _, evals = make_parallel_steps(cfg, groups)
        batch = _member(case, rank)
        res[case] = {"empty": batch.halo_empty}
        batch = batch.to("cpu")
        ev = _eval(state, batch, evals)
        state, stats = micro(state, batch)
        res[case].update(_step_result(state, stats), eval=ev)
    dist.destroy_process_group()
    os.chdir(out_dir)
    from cartnet_tpu_torch import cli
    res["sweep"] = cli.main(SWEEP_ARGV + [
        "--dp", str(DP), "--ep", str(EP), "--halo", "--coordinator",
        sweep_coordinator, "--num_processes", str(DP * EP), "--process_id",
        str(rank)])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _jax_case(case):
    """The JAX package's initial weights and its (dp 2, ep 2) halo
    micro-step on the same slices -> (port state_dict, results as port
    dicts)."""
    import jax

    from cartnet_tpu.config import Config as JConfig
    from cartnet_tpu.config import DataConfig as JDataConfig
    from cartnet_tpu.config import ModelConfig as JModelConfig
    from cartnet_tpu.config import OptimConfig as JOptimConfig
    from cartnet_tpu.data.batching import collate as jcollate
    from cartnet_tpu.models.cartnet import cartnet_apply, cartnet_init
    from cartnet_tpu.parallel.halo import to_halo as jto_halo
    from cartnet_tpu.parallel.mesh import make_mesh
    from cartnet_tpu.parallel.step import (make_parallel_steps as jsteps,
                                           stack_for_shards)
    from cartnet_tpu.train import loop as jloop
    from cartnet_tpu.train import schedule as jsched
    from cartnet_tpu_torch.interop import params_from_jax

    d = CASES[case][1]
    jcfg = JConfig(model=JModelConfig(dim_in=d, dim_rbf=8, num_layers=2,
                                      cholesky=True),
                   data=JDataConfig(max_nodes=N_PER, max_edges=E_PER,
                                    max_graphs=G_PER),
                   optim=JOptimConfig(lr=LR, batch_accumulation=1))
    stacked = stack_for_shards(
        [jto_halo(jcollate(s, N_PER, E_PER, G_PER), EP)
         for s in _slices(case)], ep=EP)
    opt = jsched.make_optimizer(LR, TOTAL, 0.01)
    state = jloop.init_train_state(jax.random.key(0), jcfg, cartnet_init,
                                   opt)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    mcfg = _cfg(case).model
    init = params_from_jax(np_tree(state.params), np_tree(state.bn_state),
                           mcfg)
    micro, _, _ = jsteps(jcfg, cartnet_apply, opt, make_mesh(DP, EP),
                         halo=True)
    state, stats = micro(state, stacked)
    ref = params_from_jax(np_tree(state.grad_accum), np_tree(state.bn_state),
                          mcfg)
    return init, {"stats": {k: float(v) for k, v in stats.items()},
                  "grads": ref, "bn": ref}


def _union_case(case, sd):
    from test_torch_port_ep import _eval, _step_result
    cfg, state = _state(case, sd)
    micro, _, evals = loop.make_steps(cfg)
    batch = _union(case).to("cpu")
    ev = _eval(state, batch, evals)
    state, stats = micro(state, batch)
    return {**_step_result(state, stats), "eval": ev}


def _floor(case, sd, single):
    """Each layer's distance between the single-process step and the same
    step on the crystals in the other order (its rounding floor)."""
    from test_torch_port_ep import _layer_errors, _step_result
    cfg, state = _state(case, sd)
    recs = [r for s in _slices(case)[::-1] for r in s]
    batch = collate(recs, DP * N_PER, DP * E_PER, DP * G_PER).to("cpu")
    state, stats = loop.make_steps(cfg)[0](state, batch)
    return _layer_errors(_step_result(state, stats)["grads"],
                         single["grads"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results, the references, the single-process steps
    with their rounding floors, and the single-process sweep."""
    from cartnet_tpu_torch import cli
    out = tmp_path_factory.mktemp("halo")
    weights, refs = {}, {}
    for case in ("cartnet_snapped", "cartnet_split"):
        weights[case], refs[case] = _jax_case(case)
    for case, seed in (("ecomformer", 7), ("icomformer", 8)):
        weights[case] = create_model(_cfg(case).model, "cpu",
                                     seed).state_dict()
    singles = {case: _union_case(case, weights[case]) for case in CASES}
    floors = {case: _floor(case, weights[case], singles[case])
              for case in CASES}
    pdist.spawn(_worker, DP * EP, (str(out), weights,
                                   f"localhost:{pdist.free_port()}"))
    ranks = []
    for r in range(DP * EP):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    single = out / "single"
    single.mkdir()
    cwd = os.getcwd()
    os.chdir(single)
    try:
        sweep = cli.main(SWEEP_ARGV)
    finally:
        os.chdir(cwd)
    return ranks, refs, (singles, floors), sweep


def _check_step(got, ref, case, slack):
    """A rank's step against a reference: stats, each layer's gradients
    (1e-5, or ``slack`` per layer where larger), BN running stats."""
    from test_torch_port_ep import _layer_errors, _rel
    for k, v in ref["stats"].items():
        if case.endswith("comformer") and k == "volume_percentage_error":
            continue
        assert abs(got["stats"][k] - v) <= 1e-5 * abs(v), (k, v)
    for g, err in _layer_errors(got["grads"], ref["grads"]).items():
        assert err <= max(1e-5, slack.get(g, 0.0)), (g, err)
    for n, buf in got["bn"].items():
        if n.endswith("num_batches_tracked"):
            assert int(buf) == int(ref["bn"][n]) == 1, n
        else:
            assert _rel(buf, ref["bn"][n]) <= 1e-5, n


@pytest.mark.parametrize("case", list(CASES))
def test_halo_step_matches_single_process_union_step(runs, case):
    """Loss, stats, BN running stats and each layer's gradients against
    the union step (1e-5, or 1.5 times the single-process rounding floor
    where that is larger, as in tests/test_torch_port_ep.py); the snapped
    batch's halo is empty and the split one's is not; every rank to the
    bit."""
    ranks, _, (singles, floors), _ = runs
    for res in ranks:
        assert res[case]["empty"] == (CASES[case][2] == "snapped")
        _check_step(res[case], singles[case], case,
                    {g: 1.5 * e for g, e in floors[case].items()})
    a = ranks[0][case]
    for b in ranks[1:]:
        for n in a["grads"]:
            assert torch.equal(a["grads"][n], b[case]["grads"][n]), n
        assert a["stats"] == b[case]["stats"]


@pytest.mark.parametrize("case", ["cartnet_snapped", "cartnet_split"])
def test_halo_step_matches_jax_halo_step(runs, case):
    """CartNet's halo step against the JAX package's on the same mesh
    shape: where the port's single-process step is farther from the JAX
    one than 1e-5 (the gate path's window moments), 1.5 times as far."""
    from test_torch_port_ep import _layer_errors
    ranks, refs, (singles, _), _ = runs
    own = _layer_errors(singles[case]["grads"], refs[case]["grads"])
    for res in ranks:
        _check_step(res[case], refs[case], case,
                    {g: 1.5 * e for g, e in own.items()})


@pytest.mark.parametrize("case", list(CASES))
def test_halo_eval_matches_single_process_union_eval(runs, case):
    """Each member predicts its own rows; put together in the slice's
    order they are the union eval's within 1e-5."""
    from test_torch_port_ep import _rel
    ranks, _, (singles, _), _ = runs
    want = singles[case]["eval"]["pred"]
    start = 0
    for r, res in enumerate(ranks):
        batch = _member(case, r)
        n = int(batch.node_mask.sum())
        got = res[case]["eval"]["pred"][:n]
        if n:  # the snapped layout may leave a member no crystal
            assert _rel(got, want[start:start + n]) <= 1e-5, r
        start += n
    assert start == int(_union(case).node_mask.sum())


def test_cli_halo_sweep_gathers_on_rank_0(runs):
    """The inference sweep over dp 2 x ep 2 halo ranks: rank 0 returns
    every structure in the single-process order, each member's own rows
    put together, within 1e-5 of the single process's predictions; the
    other ranks return None."""
    from test_torch_port_ep import _rel
    ranks, _, _, sweep = runs
    got = ranks[0]["sweep"]
    assert all(r["sweep"] is None for r in ranks[1:])
    assert got["refcode"] == sweep["refcode"] == [0, 1, 2, 3]
    for k in ("true", "atoms"):
        for a, b in zip(got[k], sweep[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    for a, b in zip(got["pred"], sweep["pred"]):
        assert _rel(a, b) <= 1e-5
