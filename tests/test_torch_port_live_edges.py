"""The batch's live edge counts (``edge_kernels.live_edges``), which bound
the f32 passes of K1 and K5/K6.

On the CPU: the derivation on a tail of pads, on interior ``EDGE_ALIGN``
pads with no tail, on a full and an all-masked batch, on a count that is
not a multiple of 64, and on an ep member's slice and a halo member's
block (``parallel/partition``): each count one past the last masked-in
edge (and src-sorted position), rounded up to the 64-edge tile, never
below it; a tensor on the masks' device, also on the meta device, where a
host sync would raise; the models pass one count to every edge phase;
``kernel_ab.tail_layout`` gives the counts it is asked for; collate's
two tile counters add up across a pipeline's batches.

On the card (``card`` marker: skips without one; run there with
``python -m pytest --noconftest -m card tests/test_torch_port_live_edges.py``,
since conftest.py imports JAX): K1, K5 and K6 in f32 at the training
cell's pads (1536 nodes, 75,776 edges) with 41,472, 0 and 75,776 live
edges against the plain versions on the same inputs
(``kernel_ab.live_vs_plain``: K1's live rows, K5/K6's every output, within
chip_smoke.py's ``CHECK_TOL``) and against the same call over every edge
(``kernel_ab.live_compare``): K1's live rows bitwise and its tail zero,
K5/K6's de, dxi, dxj and bias gradients bitwise, their weight gradients
within the f32 kernels' sum tolerance, repeats bitwise; and the bf16
routes, which compute every edge, bitwise whatever the counts.

On the CPU besides: in a train micro-step of CartNet (both layer paths),
the eComformer and the iComformer the cotangents K5 and K6 get are zero on
every edge row past the count, which their skipped tiles take for granted;
and chip_smoke.py's plain contexts take the count the models pass.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cartnet_tpu_torch import tracing
from cartnet_tpu_torch.data import batching
from cartnet_tpu_torch.data.batching import EDGE_ALIGN, collate, make_batches
from cartnet_tpu_torch.data.pipeline import BatchPipeline
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
from cartnet_tpu_torch.parallel.halo import to_halo
from cartnet_tpu_torch.parallel.partition import (ep_member, halo_member,
                                                  src_plan)
from cartnet_tpu_torch.tools import kernel_ab

TILE = ek.TILE_EDGES


def _want(mask) -> int:
    """One past the last masked-in entry, rounded up to the tile."""
    real = np.flatnonzero(np.asarray(mask))
    return -(-(int(real[-1]) + 1 if real.size else 0) // TILE) * TILE


def _adp_batch():
    recs = synthetic_dataset(3, mean_atoms=40, adp=True, seed=7)
    return collate(recs, 256, 3 * 4 * EDGE_ALIGN, 3, edge_align=EDGE_ALIGN)


def _masks(case: str):
    """(edge mask, src-sorted mask or None, the counts [2] or None: the
    reference ``_want`` of each mask)."""
    E = 1024
    m = np.zeros(E, bool)
    if case == "tail":
        m[:300] = True
        return m, None, (320, E)
    if case == "interior_pads":  # EDGE_ALIGN-style gaps, no tail
        m[:] = True
        m[200:512] = False
        m[700:900] = False
        return m, None, (E, E)
    if case == "full":
        return np.ones(E, bool), None, (E, E)
    if case == "all_masked":
        return m, m, (0, 0)
    if case == "unaligned":
        m[:10] = m[100] = True
        return m, m, (128, 128)
    if case == "collated":
        b = _adp_batch()
        return b.edge_mask, b.edge_mask_src_sorted, None
    if case.startswith("ep_member"):
        b = ep_member(_adp_batch(), 2, int(case[-1]))
        return b.edge_mask, b.edge_mask_src_sorted, None
    if case.startswith("halo_member"):
        hb = to_halo(_adp_batch(), 2)
        b = halo_member(hb, 2, int(case[-1]))
        return b.edge_mask, b.edge_mask_src_sorted, None
    raise KeyError(case)


CASES = ["tail", "interior_pads", "full", "all_masked", "unaligned",
         "collated", "ep_member_0", "ep_member_1", "halo_member_0",
         "halo_member_1"]


@pytest.mark.parametrize("case", CASES)
def test_live_edges(case):
    mask, ss, want = _masks(case)
    E = len(mask)
    live = ek.live_edges(torch.as_tensor(mask),
                         None if ss is None else torch.as_tensor(ss))
    assert isinstance(live, torch.Tensor)
    assert live.dtype == torch.int32 and tuple(live.shape) == (2,)
    got = [int(v) for v in live]
    if want is not None:
        assert got == list(want)
    assert got == [_want(mask), E if ss is None else _want(ss)]
    # conservative: every entry at or past a count is a pad, and the
    # last masked-in one lies before it
    for n, m in zip(got, (mask, mask if ss is None else ss)):
        m = np.asarray(m)
        assert n % TILE == 0 and 0 <= n <= max(E, TILE)
        assert not m[n:].any()
        if m.any():
            assert n > np.flatnonzero(m)[-1]


def test_live_edges_stays_on_the_device():
    """No host sync hides in the derivation: it runs on the meta device,
    where reading a value back raises, and returns a tensor there."""
    mask = torch.zeros(512, dtype=torch.bool, device="meta")
    live = ek.live_edges(mask, mask)
    assert isinstance(live, torch.Tensor) and live.device.type == "meta"
    assert live.dtype == torch.int32 and tuple(live.shape) == (2,)
    with pytest.raises(Exception):
        int(live[0])


def test_live_edges_rejects_a_malformed_count():
    x = torch.zeros(64, 4)
    with pytest.raises(ValueError):
        ek._check_live(torch.zeros(2, dtype=torch.int64), x)
    with pytest.raises(ValueError):
        ek._check_live(torch.zeros(1, dtype=torch.int32), x)
    ek._check_live(None, x)
    ek._check_live(torch.zeros(2, dtype=torch.int32), x)


@pytest.mark.parametrize("count", kernel_ab.LIVE_COUNTS + (0,))
def test_tail_layout_gives_its_count(count):
    lay = kernel_ab.tail_layout(count, "cpu", n_nodes=64, n_edges=
                                kernel_ab.LIVE_PADS[1], real_nodes=40)
    live = ek.live_edges(lay.edge_mask, lay.edge_mask_src_sorted)
    assert int(live[0]) == -(-count // TILE) * TILE
    dst = lay.edge_dst.numpy()
    assert (np.diff(dst) >= 0).all() and (dst[count:] == 63).all()
    assert not lay.edge_mask[count:].any()
    want = src_plan(lay.edge_src.numpy(), lay.edge_mask.numpy(), 64)
    assert np.array_equal(lay.src_rowptr.numpy(), want["src_rowptr"])


def test_the_tile_is_the_kernels():
    assert batching.EDGE_TILE == ek.TILE_EDGES


@pytest.mark.parametrize("model", ["cartnet", "ecomformer"])
def test_models_pass_one_count_to_every_edge_phase(model, monkeypatch):
    """Every edge-phase call of a train forward gets the same count
    tensor, the batch's ``live_edges``."""
    from cartnet_tpu_torch.config import ModelConfig
    from cartnet_tpu_torch.models.factory import create_model
    recs = synthetic_dataset(2, mean_atoms=12, adp=True, seed=3,
                             max_neighbors=25)
    batch = make_batches(recs, 2)[0].to("cpu")
    m = create_model(ModelConfig(name=model, dim_in=32, dim_rbf=16,
                                 num_layers=2), "cpu", 0)
    seen = []
    fwd = ek.edge_phase_fwd

    def spy(*a, live=None, **kw):
        seen.append(live)
        return fwd(*a, live=live, **kw)

    monkeypatch.setattr(ek, "edge_phase_fwd", spy)
    m.train()
    m(batch)
    assert len(seen) == (2 if model == "cartnet" else 3)
    assert all(s is seen[0] for s in seen)
    assert [int(v) for v in seen[0]] == [
        _want(batch.edge_mask), _want(batch.edge_mask_src_sorted)]


def test_collate_counts_tiles_across_a_pipeline():
    recs = synthetic_dataset(7, mean_atoms=120, adp=True, seed=2)
    pipe = BatchPipeline(recs, 2, shuffle=True, seed=5)
    assert pipe.edge_align and pipe.prefetch > 0
    with profile(activities=[ProfilerActivity.CPU]):
        batches = list(pipe)
    counters = tracing.table()["counters"]
    assert len(batches) == 4
    tiles = sum(-(-b.num_edges // TILE) for b in batches)
    live = sum(_want(b.edge_mask) // TILE for b in batches)
    assert counters["batch.edge_tiles"] == tiles
    assert counters["batch.edge_tiles_live"] == live
    assert 0 < live < tiles


def _train_case(model: str, monkeypatch):
    """A model at a narrow width and one batch of two ADP crystals collated
    with a tail of pads (1,024 edges past the last live tile), as the
    cells' pipelines lay them out -> (config, model, batch)."""
    from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
    from cartnet_tpu_torch.models.factory import create_model
    monkeypatch.setenv("CARTNET_MERGED", "1" if model == "merged" else "0")
    recs = synthetic_dataset(2, mean_atoms=12, adp=True, seed=3,
                             max_neighbors=25)
    batch = collate(recs, 64, 4 * EDGE_ALIGN, 2,
                    edge_align=EDGE_ALIGN).to("cpu")
    assert _want(batch.edge_mask) <= batch.num_edges - 2 * EDGE_ALIGN
    name = "cartnet" if model == "merged" else model
    cfg = Config(model=ModelConfig(name=name, dim_in=32, dim_rbf=16,
                                   num_layers=2, cholesky=True),
                 optim=OptimConfig(max_epoch=1))
    return cfg, create_model(cfg.model, "cpu", 0), batch


def _micro(cfg, model, sd, batch):
    """One train micro-step from the state dict ``sd`` -> (loss,
    gradients)."""
    from cartnet_tpu_torch.train import loop
    model.load_state_dict(sd)
    opt = loop.build_optimizer(cfg, model.parameters(), 1)
    st, stats = loop.make_steps(cfg)[0](loop.init_train_state(model, opt),
                                        batch)
    return stats["loss"].clone(), [g.clone() for g in st.grad_accum]


TRAIN_MODELS = ["cartnet", "merged", "ecomformer", "icomformer"]


@pytest.mark.parametrize("model", TRAIN_MODELS)
def test_pad_cotangents_are_zero_past_the_count(model, monkeypatch):
    """What K5 and K6 take for granted when they skip the tiles past the
    count: in a train micro-step the cotangents they get (K5's dgate,
    dsender and deres; K6's deout, beside its node rows daggr) are exactly
    zero on every edge row at or past the live count, so the plain
    version's sums over every edge add only zeros there."""
    cfg, m, batch = _train_case(model, monkeypatch)
    seen = []

    def spy(real, rows):
        def call(*a, live=None):
            seen.append((live, [a[i] for i in rows]))
            return real(*a, live=live)
        return call

    monkeypatch.setattr(ek, "edge_phase_bwd", spy(ek.edge_phase_bwd,
                                                  (9, 10, 11)))
    monkeypatch.setattr(ek, "merged_bwd", spy(ek.merged_bwd, (13, 14)))
    _micro(cfg, m, m.state_dict(), batch)
    layers = {"cartnet": 2, "merged": 2, "ecomformer": 3, "icomformer": 4}
    assert len(seen) == layers[model]
    for live, cots in seen:
        n = int(live[0])
        assert n == _want(batch.edge_mask) < batch.num_edges
        assert all(t is not None for t in cots)
        assert any(bool(t[:n].ne(0).any()) for t in cots)  # not vacuous
        assert all(bool(t[n:].eq(0).all()) for t in cots
                   if t.shape[0] == batch.num_edges)


@pytest.mark.parametrize("model", TRAIN_MODELS)
def test_plain_contexts_take_the_count(model, monkeypatch):
    """chip_smoke.py's plain contexts, which route the kernel wrappers to
    the plain versions, take the ``live`` keyword the models pass: a
    micro-step in them is bitwise the CPU wrappers' (which run the same
    plain versions), and one in ``plain_k1_permuted`` (K1's sums in
    another order) is close to it; CartNet's eval forward likewise under
    ``plain_cartnet_forward``."""
    import chip_smoke as cs
    cfg, m, batch = _train_case(model, monkeypatch)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    plain = (cs.plain_kernels if model in ("cartnet", "merged")
             else cs.plain_ecomformer_kernels)
    loss, grads = _micro(cfg, m, sd, batch)
    with plain():
        p_loss, p_grads = _micro(cfg, m, sd, batch)
        with cs.plain_k1_permuted():
            q_loss, q_grads = _micro(cfg, m, sd, batch)
    assert torch.equal(loss, p_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, p_grads))
    torch.testing.assert_close(q_loss, loss, rtol=1e-4, atol=1e-6)
    assert all(bool(g.isfinite().all()) for g in q_grads)
    if model == "cartnet":
        m.load_state_dict(sd)
        m.eval()
        with torch.no_grad():
            want = m(batch)[0]
            with cs.plain_cartnet_forward():
                got = m(batch)[0]
        assert torch.equal(got, want)


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("count", [41472, 0, kernel_ab.LIVE_PADS[1]])
def test_f32_kernels_bounded_by_the_live_count(cuda, count):
    import chip_smoke as cs
    lay = kernel_ab.tail_layout(count, cuda)
    live = ek.live_edges(lay.edge_mask, lay.edge_mask_src_sorted)
    assert int(live[0]) == count
    calls = kernel_ab.live_calls(lay, torch.Generator().manual_seed(count))
    for name, (_, _, fn, plain) in calls.items():
        want, got, again = fn(None), fn(live), fn(live)
        torch.cuda.synchronize()
        assert kernel_ab.live_repeats(name, got, again, count), name
        for oname, row in kernel_ab.live_vs_plain(name, plain(), got,
                                                  count).items():
            assert row["rel_err"] <= row["tol"], (name, oname, row)
        out = kernel_ab.live_compare(name, want, got, count)
        for oname, row in out.items():
            if oname in kernel_ab.LIVE_SPLIT:
                assert row["rel_err"] <= cs.CHECK_TOL["sum"], (name, oname)
            else:
                assert row["bitwise"], (name, oname)
            assert row["tail_zero"] in (None, True), (name, oname)


@pytest.mark.card
def test_bf16_routes_compute_every_edge(cuda):
    import chip_smoke as cs
    bf = torch.bfloat16
    lay = kernel_ab.tail_layout(41472, cuda)
    live = ek.live_edges(lay.edge_mask, lay.edge_mask_src_sorted)
    gen = torch.Generator().manual_seed(1)
    idx = (lay.edge_dst, lay.edge_src, lay.edge_mask)
    args = cs.edge_inputs(lay, bf, bf, 256, gen, cuda)
    eargs, _ = cs.backward_inputs(lay, bf, 256, gen, cuda)
    margs, _ = cs.merged_inputs(lay, bf, 256, gen, cuda)
    for fn in (lambda lv: ek.edge_phase_fwd(*args, *idx, saved=True,
                                            moments=True, live=lv),
               lambda lv: ek.edge_phase_bwd(*eargs, live=lv),
               lambda lv: ek.merged_bwd(*margs, live=lv)):
        want, got = fn(None), fn(live)
        for x, y in zip(got, want):
            assert x is None or torch.equal(x, y)
