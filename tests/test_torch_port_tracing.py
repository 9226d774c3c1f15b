"""The port's tracer (``cartnet_tpu_torch/tracing.py``) on the CPU: off it
records nothing; under ``torch.profiler`` its spans nest, their self
times add up, a thread started before the profiler is seen, counters
add up across threads, a new session clears the last, and its clock is
the profiler's. The instrumented layers: a traced pipeline emits the same
batches and draws as an untraced one, ``CrystalBatch.to`` counts its
copies and bytes, and the model and fused-chunk spans nest as the
module docstring says.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cartnet_tpu_torch import tracing
from cartnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                      OptimConfig)
from cartnet_tpu_torch.data.pipeline import BatchPipeline
from cartnet_tpu_torch.data.schema import array_fields
from cartnet_tpu_torch.data.synthetic import synthetic_dataset
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.train import graphs, loop


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _parents(name: str) -> set:
    return {p for n, _, p, _, _ in tracing.table()["raw"] if n == name}


def test_off_records_nothing():
    assert not tracing.recording()
    before = tracing.table()
    first, second = tracing.span("a"), tracing.span("b")
    assert first is second is tracing.NO_SPAN
    with first:
        tracing.count("c", 5)
    assert tracing.table() == before


def test_nesting_and_self_time():
    with _profiler():
        assert tracing.recording()
        with tracing.span("outer"):
            with tracing.span("inner"):
                time.sleep(0.003)
            with tracing.span("inner"):
                time.sleep(0.002)
            time.sleep(0.002)
    t = tracing.table()["spans"]
    n_out, tot_out, self_out = t["outer"]
    n_in, tot_in, self_in = t["inner"]
    assert (n_out, n_in) == (1, 2)
    assert tot_in >= 0.005 and self_in == tot_in  # no children
    assert tot_out >= tot_in + 0.002
    assert self_out == pytest.approx(tot_out - tot_in, abs=1e-8)
    assert self_out >= 0.002
    assert _parents("inner") == {"outer"} and _parents("outer") == {None}
    raw = {n: (a, b) for n, _, _, a, b in tracing.table()["raw"]}
    assert raw["outer"][0] <= raw["inner"][0] <= raw["inner"][1] \
        <= raw["outer"][1]


def test_thread_started_before_the_profiler_is_recorded():
    go, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        go.wait(10)
        with tracing.span("worker.span"):
            tracing.count("worker.count", 2)
        seen["ident"] = threading.get_ident()
        done.set()

    t = threading.Thread(target=worker, daemon=True)
    t.start()  # before the profiler
    with _profiler():
        go.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    tab = tracing.table()
    assert tab["spans"]["worker.span"][0] == 1
    assert tab["counters"]["worker.count"] == 2
    assert [r[1] for r in tab["raw"]] == [seen["ident"]]


def test_counters_and_spans_add_up_across_threads():
    """More threads than cores, a short switch interval: no lost update
    in the shared tables."""
    threads, each = 12, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler():
            def work():
                for _ in range(each):
                    with tracing.span("stress"):
                        tracing.count("stress.n")
                        tracing.count("stress.bytes", 3)
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for p in pool:
                p.start()
            for p in pool:
                p.join(60)
            assert not any(p.is_alive() for p in pool)
    finally:
        sys.setswitchinterval(old)
    tab = tracing.table()
    assert tab["spans"]["stress"][0] == threads * each
    assert tab["counters"] == {"stress.n": threads * each,
                               "stress.bytes": 3 * threads * each}
    assert len(tab["raw"]) == threads * each


def test_a_new_session_clears_the_last():
    with _profiler():
        with tracing.span("first"):
            tracing.count("first.n")
    assert "first" in tracing.table()["spans"]
    with tracing.span("between"):  # off: nothing
        pass
    assert set(tracing.table()["spans"]) == {"first"}  # kept after stop
    with _profiler():
        with tracing.span("second"):
            pass
    tab = tracing.table()
    assert set(tab["spans"]) == {"second"} and tab["counters"] == {}


def test_span_start_is_on_the_profilers_clock():
    with _profiler() as prof:
        with tracing.span("clocked"):
            time.sleep(0.002)
    mine = [r for r in tracing.table()["raw"] if r[0] == "clocked"]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "clocked"]
    assert len(mine) == 1 and len(events) == 1
    start = (events[0].start_ns() if hasattr(events[0], "start_ns")
             else events[0].start_us() * 1000)
    assert abs(mine[0][3] - start) < 1_000_000  # 1 ms


def _epochs(pipe, n=2):
    return [[{k: np.asarray(a).copy() for k, a in array_fields(b).items()}
             for b in pipe] for _ in range(n)]


def test_traced_pipeline_emits_the_same_batches_and_draws():
    """Shuffled, augmented and RCM-relabelled, with the prefetch thread:
    tracing changes no batch and no draw, and sees one ``data.batch`` a
    batch with its four parts inside."""
    recs = synthetic_dataset(7, mean_atoms=120, adp=True, seed=2)
    plain = BatchPipeline(recs, 2, shuffle=True, augment=True, seed=5)
    traced = BatchPipeline(recs, 2, shuffle=True, augment=True, seed=5)
    assert traced.edge_align and traced.prefetch > 0
    want = _epochs(plain)
    with _profiler():
        got = _epochs(traced)
    assert len(got[0]) == len(want[0]) == 4
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert (traced.rng.bit_generator.state
            == plain.rng.bit_generator.state)
    spans = tracing.table()["spans"]
    assert spans["data.batch"][0] == 8
    for part in ("data.fetch", "data.augment", "data.reorder",
                 "data.collate"):
        assert spans[part][0] == 8
        assert _parents(part) == {"data.batch"}
    # the consumer's waits: one a batch and one for the end of each pass
    assert spans["data.wait"][0] == 10
    assert spans["data.batch"][2] >= 0.0


def test_to_device_counts_each_array_field():
    recs = synthetic_dataset(3, mean_atoms=30, adp=True, seed=4)
    batch = next(iter(BatchPipeline(recs, 3, prefetch=0)))
    fields = array_fields(batch)
    with _profiler():
        moved = batch.to("cpu")
        moved.to("cpu")  # tensors already: each still counts
    tab = tracing.table()
    assert tab["spans"]["batch.to_device"][0] == 2
    assert tab["counters"]["batch.to_device.copies"] == 2 * len(fields)
    assert tab["counters"]["batch.to_device.bytes"] == 2 * sum(
        np.asarray(a).nbytes for a in fields.values())
    assert all(isinstance(a, torch.Tensor)
               for a in array_fields(moved).values())


def test_model_spans_nest_in_the_fused_chunk():
    """A CPU fused chunk of two micro-steps: ``chunk.run`` holds the stack,
    the hand-off and one ``model.forward`` a micro-step, each with its
    encoder, a ``model.layer`` a CartNet layer and the head."""
    cfg = Config(model=ModelConfig(dim_in=32, dim_rbf=16, num_layers=2),
                 data=DataConfig(batch_size=2),
                 optim=OptimConfig(batch_accumulation=2, fused_steps=2))
    recs = synthetic_dataset(4, mean_atoms=20, adp=True, seed=1)
    batches = list(BatchPipeline(recs, 2, prefetch=0))
    model = create_model(cfg.model, "cpu", 0)
    opt = loop.build_optimizer(cfg, model.parameters(), len(batches))
    state = loop.init_train_state(model, opt)
    runner = graphs.ChunkRunner(loop.make_fused_chunk(cfg, 2), 2, "cpu")
    with _profiler():
        runner(state, batches)
    spans = tracing.table()["spans"]
    assert spans["chunk.run"][0] == 1
    assert spans["model.forward"][0] == 2
    assert spans["model.layer"][0] == 4
    assert spans["model.encoder"][0] == spans["model.head"][0] == 2
    assert _parents("chunk.stack") == _parents("batch.to_device") == \
        _parents("model.forward") == {"chunk.run"}
    assert _parents("model.layer") == _parents("model.head") == \
        {"model.forward"}
    assert "chunk.wait" not in spans  # no pinned copy on the CPU


def test_ecomformer_spans():
    cfg = ModelConfig(name="ecomformer", dim_in=32)
    recs = synthetic_dataset(2, mean_atoms=12, adp=True, seed=3,
                             max_neighbors=25)
    batch = next(iter(BatchPipeline(recs, 2, prefetch=0))).to("cpu")
    model = create_model(cfg, "cpu", 0)
    with _profiler(), torch.no_grad():
        model(batch)
    spans = tracing.table()["spans"]
    assert spans["model.forward"][0] == 1
    assert spans["model.layer"][0] == 3 and spans["model.equivariant"][0] == 1
    assert _parents("model.equivariant") == {"model.forward"}
