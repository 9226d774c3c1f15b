"""Chunked single-device execution (``--chunks``): the port's chunk layout
against the JAX package's ``to_chunked``, its step against JAX
``make_chunked_steps`` and against its own flat step, and the runner's
wiring.

Data as in tests/test_chunked.py: 8 synthetic crystals of ~40 atoms in a
batch of 512 nodes and 8192 edges ("scalar", "cholesky": the cuts snap
to crystals, an empty halo) and tests/test_halo.py's 100-atom chain in
128 / 1024 ("split": one crystal cut across the chunks, h_max 16), K = 2,
CartNet D = 32, 2 layers, f32, the weights JAX ``cartnet_init`` draws
from key 0 carried over by ``interop``. The JAX side runs its XLA path
(``edge_fuse_ok=False``), one compile a case, shared by a module
fixture.

* Layout: the same node order, masks and targets, and the same edges in
  each chunk once the JAX halo slots are re-indexed to global rows;
  ``halo_empty`` alike; ``HaloInfeasible`` where the JAX search raises.
* The port's rounding floor: its flat step on the flat batch against
  the same step with every edge moved 8, 16, 32 or 48 places on (masked
  pad edges in front), the largest distance of the four: each regroups
  the real edges into other 64-edge BN moment tiles, as the chunk layout
  does. Under train BN the port's f32 step
  carries that regrouping into its gradients at ~1e-5 of a layer's
  largest (up to 1e-3 on some weights of the chain), where the JAX XLA
  path's two-pass BN does not (its chunk and flat steps agree within
  ~5e-6).
* Against the JAX chunk step: the loss and stats within 1e-5 relative,
  the BN running stats within 1e-5, each layer's gradients within 1e-5
  of its largest, each or 1.5 times the port's flat step's distance from
  the JAX chunk step plus the port's rounding floor where that is larger
  (the rule of tests/test_torch_port_dp.py, with the floor of
  tests/test_torch_port_halo.py).
* Against the port's flat step: K2's plain aggregates bitwise on the same
  edge values; the loss, stats, BN stats and each layer's gradients
  within 1e-5, or 1.5 times the rounding floor where that is larger
  (the ADP volume error, over an untrained near-singular prediction,
  moves by 1e-2 relative with the tiles); the eval's masked predictions
  within 1e-6 (eval BN reads the running stats; the chunk layout keeps
  the node order, so ADP predictions line up without a reshape).
* Runner: the pads of ``runner.pipelines`` equal the JAX ``_pipelines``'
  for the same argv; ``--chunks 2`` through the CLI trains to finite
  stats (with ``--fused_steps 2``: the JAX warning, unfused epochs);
  under dp 2 the chunks are ignored with the JAX warning; the eComformer
  raises the JAX error.
"""

import dataclasses
import json
import logging
import math

import numpy as np
import pytest
import torch

from chip_smoke import CHUNK_SHIFTS, shifted

from cartnet_tpu_torch import cli, runner
from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
from cartnet_tpu_torch.data.batching import collate
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.ops.kernels.segment_kernels import sigma_segsum_plain
from cartnet_tpu_torch.parallel.chunk import ChunkedPipeline, to_chunked
from cartnet_tpu_torch.parallel.halo import HaloInfeasible
from cartnet_tpu_torch.train import loop, schedule

K = 2
D, RBF, LAYERS = 32, 8, 2
LR, TOTAL = 1e-3, 4
NODE_FIELDS = ("z", "pos", "graph_id", "node_mask", "non_h_mask")
GRAPH_FIELDS = ("cell", "temperature", "graph_mask")
CLI_ARGV = ["--dataset", "synthetic", "--limit", "8", "--epochs", "1",
            "--batch_accumulation", "2", "--dim_in", "16", "--dim_rbf", "8",
            "--num_layers", "2", "--device", "cpu", "--chunks", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this file runs: its models are tiny, and in
    six test workers on a shared CPU torch's default of a thread a core
    slows them several times over (tests/test_torch_port_fused.py)."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def _chain(cholesky):
    from test_torch_port_halo import _chain_graph
    return _chain_graph(cholesky, n=100)


# case: (records, N, E, h_max, cholesky, empty halo)
CASES = {
    "scalar": (lambda: synthetic_dataset(8, mean_atoms=40, adp=False,
                                         seed=31), 512, 8192, None, False,
               True),
    "cholesky": (lambda: synthetic_dataset(8, mean_atoms=40, adp=True,
                                           seed=31), 512, 8192, None, True,
                 True),
    "split": (lambda: [_chain(True)], 128, 1024, 16, True, False),
}


def _batches(case):
    """(the port's flat batch, the JAX package's, the port's chunked)."""
    from cartnet_tpu.data.batching import collate as jcollate
    make, n, e, h_max, _, _ = CASES[case]
    recs = make()
    flat = collate(recs, n, e, 8)
    return flat, jcollate(recs, n, e, 8), to_chunked(flat, K, h_max)


def _jax_global_edges(jc, m):
    """Chunk ``m`` of a JAX ``to_chunked`` batch: its real edges as
    (global dst, global src, distance) rows, halo slots re-indexed to the
    owner's global row."""
    n_per = jc.z.shape[1]
    send = np.asarray(jc.halo_send_idx)
    h = send.shape[-1]
    mask = np.asarray(jc.edge_mask[m])
    src = np.asarray(jc.edge_src[m]).astype(np.int64)[mask]
    dst = np.asarray(jc.edge_dst[m]).astype(np.int64)[mask] + m * n_per
    glob = m * n_per + src
    remote = src >= n_per
    r, s = np.divmod(src[remote] - n_per, h)
    o = (m + 1 + r) % K
    glob[remote] = o * n_per + send[o, m, s]
    return np.stack([dst, glob, np.asarray(jc.cart_dist[m])[mask]], 1)


def _edge_rows(batch, m):
    n_per, e_per = batch.num_nodes // K, batch.num_edges // K
    sl = slice(m * e_per, (m + 1) * e_per)
    mask = batch.edge_mask[sl]
    return np.stack([batch.edge_dst[sl][mask], batch.edge_src[sl][mask],
                     batch.cart_dist[sl][mask]], 1)


def _sorted_rows(a):
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("case", list(CASES))
def test_to_chunked_layout_matches_jax(case):
    from cartnet_tpu.parallel.chunk import to_chunked as jto_chunked
    flat, jb, got = _batches(case)
    want = jto_chunked(jb, K, CASES[case][3])
    assert got.chunks == K and not got.halo
    assert got.halo_empty == want.halo_empty == CASES[case][5]
    for f in NODE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)).reshape(
                                          getattr(got, f).shape), err_msg=f)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.y, np.asarray(want.y).reshape(
        got.y.shape))
    for m in range(K):
        np.testing.assert_array_equal(_sorted_rows(_edge_rows(got, m)),
                                      _sorted_rows(_jax_global_edges(want,
                                                                     m)))
    # every real edge of the flat batch, once, between the same atoms
    node = np.flatnonzero(got.node_mask)  # chunk row of each flat node
    real = flat.edge_mask
    pairs = np.stack([node[flat.edge_dst[real]], node[flat.edge_src[real]],
                      flat.cart_dist[real]], 1)
    np.testing.assert_array_equal(
        _sorted_rows(np.concatenate([_edge_rows(got, m) for m in range(K)])),
        _sorted_rows(pairs))


@pytest.mark.parametrize("case", list(CASES))
def test_to_chunked_plans(case):
    """The flat plans over the chunk layout: dst sorted with each chunk's
    tail pads on its own last row, ``dst_rowptr``, the src plan over all
    N rows, ``src_degree`` the real edges out of each row."""
    _, _, b = _batches(case)
    n, e = b.num_nodes, b.num_edges
    assert (np.diff(b.edge_dst) >= 0).all()
    np.testing.assert_array_equal(
        b.dst_rowptr, np.searchsorted(b.edge_dst, np.arange(n + 1)))
    for m in range(K):  # each chunk's edges stay in its rows
        sl = slice(m * e // K, (m + 1) * e // K)
        assert (b.edge_dst[sl] // (n // K) == m).all()
    srt = b.edge_src[b.edge_src_perm]
    assert (np.diff(srt) >= 0).all() and (b.edge_src_sorted == srt).all()
    np.testing.assert_array_equal(
        b.src_rowptr, np.searchsorted(srt, np.arange(n + 1)))
    np.testing.assert_array_equal(b.edge_mask_src_sorted,
                                  b.edge_mask[b.edge_src_perm])
    np.testing.assert_array_equal(
        b.src_degree, np.bincount(b.edge_src[b.edge_mask], minlength=n))
    assert b.halo_send_idx is None and b.halo_send_mask is None


def _edge_caps_batch():
    """Two crystals whose edges overflow a chunk's share at K = 4 (the
    edge-cap batch of tests/test_torch_port_halo.py)."""
    recs = synthetic_dataset(2, mean_atoms=24, adp=False, seed=4)
    e = -(-sum(len(r["edge_src"]) for r in recs) // 4) * 4
    return recs, 64, e, 4


@pytest.mark.parametrize("which", ["edge_caps", "pads_do_not_split"])
def test_to_chunked_raises_where_jax_raises(which):
    """No h_max of the search fits (the edge caps), or the pads do not
    split over K: HaloInfeasible in both packages."""
    from cartnet_tpu.data.batching import collate as jcollate
    from cartnet_tpu.parallel.chunk import to_chunked as jto_chunked
    from cartnet_tpu.parallel.halo import HaloInfeasible as JInfeasible
    if which == "edge_caps":
        recs, n, e, k = _edge_caps_batch()
    else:
        recs, n, e, k = synthetic_dataset(8, mean_atoms=40, adp=False,
                                          seed=31), 512, 8192, 3
    with pytest.raises(JInfeasible):
        jto_chunked(jcollate(recs, n, e, 8), k)
    with pytest.raises(HaloInfeasible):
        to_chunked(collate(recs, n, e, 8), k)


# ---------------------------------------------------------------- steps

def _cfg(case) -> Config:
    return Config(model=ModelConfig(dim_in=D, dim_rbf=RBF,
                                    num_layers=LAYERS,
                                    cholesky=CASES[case][4]),
                  optim=OptimConfig(lr=LR, batch_accumulation=1))


def _jax_step(case):
    """The JAX package's initial weights (key 0) and its chunk micro-step
    on its XLA path -> (port state_dict, results as port dicts)."""
    import jax
    import jax.numpy as jnp

    from cartnet_tpu.config import Config as JConfig
    from cartnet_tpu.config import DataConfig as JDataConfig
    from cartnet_tpu.config import ModelConfig as JModelConfig
    from cartnet_tpu.config import OptimConfig as JOptimConfig
    from cartnet_tpu.models.cartnet import cartnet_apply, cartnet_init
    from cartnet_tpu.parallel.chunk import make_chunked_steps
    from cartnet_tpu.parallel.chunk import to_chunked as jto_chunked
    from cartnet_tpu.train import loop as jloop
    from cartnet_tpu.train import schedule as jsched
    from cartnet_tpu_torch.interop import params_from_jax

    _, n, e, h_max, cholesky, _ = CASES[case]
    jcfg = JConfig(model=JModelConfig(dim_in=D, dim_rbf=RBF,
                                      num_layers=LAYERS, cholesky=cholesky),
                   data=JDataConfig(max_nodes=n, max_edges=e, max_graphs=8),
                   optim=JOptimConfig(lr=LR, batch_accumulation=1))
    _, jb, _ = _batches(case)
    jc = jto_chunked(jb, K, h_max).replace(edge_fuse_ok=False)
    opt = jsched.make_optimizer(LR, TOTAL, 0.01)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    mcfg = _cfg(case).model
    state = jloop.init_train_state(jax.random.key(0), jcfg, cartnet_init,
                                   opt)
    init = params_from_jax(np_tree(state.params), np_tree(state.bn_state),
                           mcfg)
    micro = make_chunked_steps(jcfg, cartnet_apply, opt)[0]
    state, stats = micro(state, jax.tree.map(jnp.asarray, jc))
    ref = params_from_jax(np_tree(state.grad_accum), np_tree(state.bn_state),
                          mcfg)
    return init, {"stats": {k: float(v) for k, v in stats.items()},
                  "grads": ref, "bn": ref}


def _port_step(case, sd, batch):
    """The port's eval forward, then one micro-step, on ``batch``."""
    from test_torch_port_ep import _eval, _step_result
    cfg = _cfg(case)
    model = create_model(cfg.model, "cpu", 0)
    model.load_state_dict(sd, strict=True)
    state = loop.init_train_state(model, schedule.make_optimizer(
        model.parameters(), LR, TOTAL, 0.01))
    micro, _, evals = loop.make_steps(cfg)
    b = batch.to("cpu")
    ev = _eval(state, b, evals)
    state, stats = micro(state, b)
    return {**_step_result(state, stats), "eval": ev}


def _distances(got, ref) -> dict:
    """Each stat's distance relative to the reference's value, each
    layer's gradients' (``_layer_errors``), each BN buffer's (relative to
    its largest entry); BN's batch counts must agree."""
    from test_torch_port_ep import _layer_errors, _rel
    out = {k: abs(got["stats"][k] - v) / max(abs(v), 1e-30)
           for k, v in ref["stats"].items()}
    out.update(_layer_errors(got["grads"], ref["grads"]))
    for n, buf in got["bn"].items():
        if n.endswith("num_batches_tracked"):
            assert int(buf) == int(ref["bn"][n]) == 1, n
        else:
            out[n] = _rel(buf, ref["bn"][n])
    return out


@pytest.fixture(scope="module")
def steps():
    """Per case: the JAX chunk step, the port's flat and chunk steps from
    the same weights, and the port's rounding floor: the largest
    distance of its flat step on a shifted batch (``CHUNK_SHIFTS``) from its
    flat step."""
    out = {}
    for case in CASES:
        sd, ref = _jax_step(case)
        flat, _, chunked = _batches(case)
        f = _port_step(case, sd, flat)
        shifts = [_distances(_port_step(case, sd, shifted(flat, n)), f)
                  for n in CHUNK_SHIFTS]
        out[case] = dict(jax=ref, flat=f,
                         chunked=_port_step(case, sd, chunked),
                         floor={k: max(d[k] for d in shifts)
                                for k in shifts[0]})
    return out


def _check(dist: dict, allowed: dict) -> None:
    for k, err in dist.items():
        assert err <= max(1e-5, allowed[k]), (k, err, allowed[k])


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_step_matches_jax_chunked_step(steps, case):
    """The loss, stats, BN running stats and each layer's gradients
    within 1e-5 of the JAX chunk step's, or 1.5 times the port's flat
    step's distance from it plus the port's rounding floor where larger
    (the ADP volume error, over a near-singular untrained prediction, and
    some BN means and gradients)."""
    s = steps[case]
    own = _distances(s["flat"], s["jax"])
    _check(_distances(s["chunked"], s["jax"]),
           {k: 1.5 * (own[k] + s["floor"][k]) for k in own})


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_step_matches_flat_step(steps, case):
    """The same against the port's flat step: 1e-5, or 1.5 times the
    rounding floor where larger."""
    s = steps[case]
    _check(_distances(s["chunked"], s["flat"]),
           {k: 1.5 * v for k, v in s["floor"].items()})


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_eval_matches_flat_eval(steps, case):
    """Node predictions in the chunk layout's rows, graph predictions
    as they are: the flat eval's, masked alike."""
    from test_torch_port_ep import _rel
    flat, _, chunked = _batches(case)
    f, c = steps[case]["flat"]["eval"], steps[case]["chunked"]["eval"]
    if CASES[case][4]:
        f = {k: f[k][torch.as_tensor(flat.node_mask)] for k in ("pred",
                                                               "mask")}
        c = {k: c[k][torch.as_tensor(chunked.node_mask)] for k in ("pred",
                                                                  "mask")}
    assert torch.equal(f["mask"], c["mask"])
    assert _rel(c["pred"][c["mask"]], f["pred"][f["mask"]]) <= 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_aggregates_bitwise(case):
    """K2's plain version on the same per-edge values, laid out flat and
    in chunks: each atom's aggregate to the bit (each dst row sums the
    same edges in the same order)."""
    flat, _, chunked = _batches(case)
    # the layout of a copy whose distances and x coordinates are the flat
    # edge and node ids: where each chunk row came from
    ids = dataclasses.replace(
        flat, cart_dist=np.arange(flat.num_edges, dtype=np.float32),
        pos=np.repeat(np.arange(flat.num_nodes, dtype=np.float32)[:, None],
                      3, 1))
    tagged = to_chunked(ids, K, CASES[case][3])
    np.testing.assert_array_equal(tagged.edge_src, chunked.edge_src)
    eid = tagged.cart_dist[chunked.edge_mask].astype(np.int64)
    nid = tagged.pos[chunked.node_mask, 0].astype(np.int64)
    gen = torch.Generator().manual_seed(5)
    rn = lambda *s: torch.randn(*s, generator=gen)
    E, d = flat.num_edges, 24
    vals = [rn(E, d), rn(d), rn(d), rn(E, 1).abs(), rn(E, d), rn(E, d)]
    in_chunks = []
    for v in vals:
        if v.shape[0] != E:
            in_chunks.append(v)
            continue
        c = rn(chunked.num_edges, v.shape[1])  # pad edges: any value
        c[torch.as_tensor(chunked.edge_mask)] = v[torch.as_tensor(eid)]
        in_chunks.append(c)
    t = lambda a: torch.as_tensor(a)
    _, want = sigma_segsum_plain(*vals, t(flat.edge_dst).long(),
                                 t(flat.edge_mask), flat.num_nodes)
    _, got = sigma_segsum_plain(*in_chunks, t(chunked.edge_dst).long(),
                                t(chunked.edge_mask), chunked.num_nodes)
    assert torch.equal(got[t(chunked.node_mask)], want[t(nid)])
    assert not got[~t(chunked.node_mask)].any()


# --------------------------------------------------------------- runner

@pytest.mark.parametrize("extra", [["--chunks", "2"], ["--chunks", "3"],
                                   ["--chunks", "4", "--ep", "2"]])
def test_pipelines_pads_match_jax(extra):
    """The pad multiples of max(ep, K) and the chunk slack: the JAX
    ``_pipelines``' shapes for the same argv (host only), each batch laid
    out by ``to_chunked``."""
    from cartnet_tpu import cli as jcli
    from cartnet_tpu.runner import _pipelines
    argv = ["--dataset", "synthetic", "--limit", "16", "--cholesky"] + extra
    jcfg = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
    ours = runner.pipelines(cfg, cli.load_datasets(cfg.data, 16, adp=True))
    ref = _pipelines(jcfg, jcli.load_datasets(jcfg, limit=16))
    for a, b in zip(ours, ref):
        assert (a.max_nodes, a.max_edges) == (b.max_nodes, b.max_edges)
        assert len(a) == len(b)
    k = cfg.parallel.chunks
    flat = runner.pipelines(dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, chunks=1)),
        cli.load_datasets(cfg.data, 16, adp=True))[0]
    assert ours[0].max_nodes > flat.max_nodes
    assert ours[0].max_edges % (512 * max(k, cfg.parallel.ep)) == 0
    for b in ChunkedPipeline(ours[2], k):
        assert b.chunks == k and b.num_nodes == ours[2].max_nodes


def _stats_lines(split):
    with open(f"results/CartNet/0/{split}/stats.json") as f:
        return [json.loads(x) for x in f if x.strip()]


def _finite(stats):
    return all(math.isfinite(v) for v in stats.values()
               if isinstance(v, (int, float)))


def test_cli_chunked_scalar_with_fused_steps(tmp_path, monkeypatch, caplog):
    """--chunks 2 on the scalar head, with --fused_steps 2: the JAX
    warning, unfused epochs (no fused-epoch line), finite stats lines."""
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.INFO):
        state, test = cli.main(CLI_ARGV + ["--fused_steps", "2"])
    text = caplog.text
    assert "chunked execution: 2 member-major chunks per batch" in text
    assert "fused_steps with --chunks is not supported yet" in text
    assert "fused epochs: 2 micro-steps" not in text
    assert state.step == 1 and int(state.bad_steps) == 0
    assert _finite(test) and "iou" not in test
    for split in ("train", "val", "test"):
        assert all(_finite(r) for r in _stats_lines(split))


def test_cli_chunked_cholesky(tmp_path, monkeypatch):
    """--chunks 2 on the Cholesky head: finite stats, the test line with
    S12 and the 3D IoU."""
    monkeypatch.chdir(tmp_path)
    state, test = cli.main(CLI_ARGV + ["--cholesky"])
    assert state.step == 1 and int(state.bad_steps) == 0
    assert _finite(test) and {"similarity_index", "iou"} <= test.keys()
    assert {"similarity_index", "iou"} <= _stats_lines("test")[0].keys()


def test_chunks_ignored_under_dp(caplog):
    """A dp x ep world of more than one rank ignores --chunks with the JAX
    warning; its pads keep the chunk slack and multiples."""
    cfg = cli.args_to_config(cli.build_parser().parse_args(
        CLI_ARGV + ["--dp", "2"]))
    pipes = ("train", "val", "test")
    with caplog.at_level(logging.WARNING):
        assert runner.chunked(pipes, cfg) is pipes
    assert "ignored on a 2x1 mesh" in caplog.text
    assert runner.chunk_count(cfg) == 1
    single = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, dp=1))
    assert runner.chunk_count(single) == 2
    assert all(isinstance(p, ChunkedPipeline)
               for p in runner.chunked(pipes, single))


def test_chunked_comformer_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="supports model 'cartnet' only"):
        cli.main(CLI_ARGV + ["--model", "eComformer", "--cholesky"])


def test_cli_sweep_with_chunks_runs_flat_on_chunk_pads(tmp_path, monkeypatch):
    """--inference --chunks 2 sweeps the pipeline's slack-padded batches
    flat: the same structures and predictions as without --chunks."""
    from test_torch_port_ep import _rel
    monkeypatch.chdir(tmp_path)
    argv = CLI_ARGV[:-2] + ["--cholesky", "--inference",
                            "--inference_output", "sweep.pkl"]
    want = cli.main(argv)
    got = cli.main(argv + ["--chunks", "2"])
    assert got["refcode"] == want["refcode"] and len(got["pred"]) == 2
    for a, b in zip(got["pred"], want["pred"]):
        assert _rel(a, b) <= 1e-5
