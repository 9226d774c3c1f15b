"""Mix driver ``train_fused``: the training job a fused epoch runs.

The pool goes through the program's own pipeline (the train split of
``runner.pipelines``: shuffle, augmentation per the configuration, RCM
relabelling, collation, a prefetch thread) into
``train.loop.train_epoch_fused`` with a ``train.graphs.ChunkRunner`` over
``loop.make_fused_chunk``: ``fused_steps`` micro-steps a CUDA-graph
replay. The batches come from one iterator that chains passes over the
pool, reshuffled and re-augmented each pass, as epochs are.

Set-up builds the training state and drives it through the first
``compare_updates`` optimizer updates with one call of
``train_epoch_fused`` (the first replay warms up and captures the graph);
the window is one more call over the same iterator, stopping at the first
chunk boundary after ``seconds``. Once the window has closed the plain
reference redoes the set-up's updates from the same records, weights and
seed, and the two are compared (``compare.train_numbers``)."""

from __future__ import annotations

import gc
import itertools
import time

import torch

from bench_h100 import flops
from bench_h100.harness import cells, compare, crystals
from bench_h100.harness.readings import (Clock, Readings, Window,
                                           batch_counts, log)
from bench_h100.harness.spans import Spans
from bench_h100.harness.trace import Stretch
from bench_h100.harness.weights import make_weights
from bench_h100.reference import common as ref_common
from bench_h100.reference.train import bn_state, schedule, train_updates


class Feed:
    """Endless passes of a pipeline, each ``__next__`` inside a
    ``data_wait`` span (the wait for a pass's first batch, which starts
    the pipeline's prefetch thread anew, also as ``data_wait.pass_start``);
    ``window(...)`` stops at the first chunk boundary after the deadline.
    Records each batch's counts."""

    def __init__(self, pipe, spans: Spans):
        self.pipe, self.spans = pipe, spans
        self.passes = self._passes()
        self.counts = []

    def _passes(self):
        while True:
            for i, batch in enumerate(self.pipe):
                yield i == 0, batch

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        with self.spans.span("data_wait"):
            first, batch = next(self.passes)
        if first:
            self.spans.add("data_wait.pass_start", time.perf_counter() - t)
        self.counts.append(batch_counts(batch))
        return batch

    def window(self, deadline: float, chunk: int):
        for i in itertools.count():
            if i % chunk == 0 and time.perf_counter() >= deadline:
                return
            yield next(self)

    def close(self) -> None:
        """Stops the pipeline's prefetch thread of the current pass."""
        self.passes.close()


def _named(params, tensors) -> dict:
    return {n: t.detach().clone() for (n, _), t in zip(params, tensors)}


def run(r) -> tuple:
    """One run of a training cell (``r``: a ``run.Run``) -> (window
    metrics' readings, port and reference numbers, attempted, failed)."""
    from cartnet_tpu_torch import runner
    from cartnet_tpu_torch.models.factory import create_model
    from cartnet_tpu_torch.train import graphs, loop

    dev = r.device
    mix, conf = r.mix, r.config
    cfg = cells.port_config(conf, mix, r.job_seed)
    k = cfg.optim.fused_steps
    accum = cfg.optim.batch_accumulation
    updates = mix["compare_updates"]
    if k <= 1 or accum % k:
        raise ValueError(f"fused_steps {k} must divide the accumulation "
                         f"{accum}")
    clock = Clock()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the CUDA context
        clock.lap("cuda")
    records = crystals.make_pool(mix["pool"], cfg.data.radius,
                                 cfg.data.max_neighbors, r.seed, r.cache_dir)
    clock.lap("pool")
    pipe = runner.pipelines(cfg, (records, [], []))[0]
    clock.lap("pipeline")
    ref_cls = cells.reference_model(conf)
    weights = make_weights(ref_cls(**conf["model"]), r.weight_seed, dev)
    clock.lap("weights")
    model = create_model(cfg.model, dev, 0)
    model.load_state_dict(weights, strict=True)
    clock.lap("model")
    # the schedule of the real job: its epochs, not the pool's
    opt = loop.build_optimizer(cfg, model.parameters(),
                               conf["epoch_micro_steps"])
    state = loop.init_train_state(model, opt, cfg.seed)
    _, update, _ = loop.make_steps(cfg)
    chunks = graphs.ChunkRunner(loop.make_fused_chunk(cfg, k), k, dev)
    names = list(model.named_parameters())
    clock.lap("optimizer")
    spans = Spans(traced=r.trace)
    feed = Feed(pipe, spans)
    port, calls = {}, [0]
    stretch, steps_in = Stretch(dev), []
    window_open = [None]

    def run_chunk(state_, batches):
        t = window_open[0]
        if (r.trace and t is not None and not stretch.active
                and time.perf_counter() - t >= r.seconds - mix["stretch_s"]):
            stretch.start()
            steps_in.append(len(feed.counts) - k)
        with spans.span("chunk_feed"):
            out = chunks(state_, batches)
        calls[0] += 1
        if t is None and calls[0] * k == accum:  # the first update is in
            port["m1"] = _named(names, [
                opt.adam.state[p].get("exp_avg", torch.zeros_like(p))
                for p in opt.params])
            port["bn1"] = bn_state(model)
        return out

    # set-up: the first updates, through the window's own call and feed
    _, rows = loop.train_epoch_fused(
        state, itertools.islice(feed, updates * accum), run_chunk, k,
        update, accum, dev)
    params3 = _named(names, opt.params)
    bn3 = bn_state(model)
    setup_counts = len(feed.counts)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    clock.lap("first_updates")
    log(f"setup: {clock.laps}; pads {pipe.max_nodes} / {pipe.max_edges}; "
        f"captures {chunks.captures}; allocated "
        f"{torch.cuda.memory_allocated(dev) if dev.type == 'cuda' else 0}")
    if r.trace:
        stretch.prime()
    spans.reset()
    bad0 = int(state.bad_steps)

    window_open[0] = t0 = time.perf_counter()
    r.window_opened()
    _, wrows = loop.train_epoch_fused(
        state, feed.window(t0 + r.seconds, k), run_chunk, k, update, accum,
        dev)
    seconds = time.perf_counter() - t0
    trace = None
    if stretch.active:
        trace = stretch.stop(feed.counts[steps_in[0]:])
    feed.close()
    counts = feed.counts[setup_counts:]
    failed = int(state.bad_steps) - bad0
    window = Window(
        kind="train", seconds=seconds, steps=len(wrows),
        replays=len(counts) // k, structures=sum(c["graphs"] for c in counts),
        flops=sum(flops.train_step(conf["model"], c["nodes"], c["edges"],
                                   c["graphs"]) for c in counts),
        spans=spans.table())
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the program's state goes before the reference runs on the device
    beta1 = schedule(conf["optim"], conf["epoch_micro_steps"])(0)[1]
    bn_port, tracked_port = bn3
    bn1_port, tracked1_port = port["bn1"]
    port_side = {
        "stats": [row for row, _ in rows],
        "grad1": {n: m / (1.0 - beta1) for n, m in port["m1"].items()},
        "change": {n: params3[n] - weights[n] for n in params3},
        "bn": {n: bn_port[n] - weights[n] for n in bn_port},
        "tracked": tracked_port,
        "bn1": {n: bn1_port[n] - weights[n] for n in bn1_port},
        "tracked1": tracked1_port}
    del state, opt, chunks, model, update, run_chunk, names
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare.train_numbers(
        port_side, reference_side(r, records, weights), accum)
    return (Readings(config=conf, window=window, trace=trace), numbers,
            len(wrows), failed, memory)


def reference_side(r, records, weights, tf32: bool = False,
                   keep_graphs=None, dtype=torch.float32) -> dict:
    """The reference's set-up updates from the same records, weights and
    seed: per micro-step stats, the first update's gradient, the
    parameters' and the BatchNorm statistics' change and update counts
    (``tf32``: the control's precision; ``keep_graphs``: the half-batch
    fault; ``dtype``: float64 for calibrate.py's witness)."""
    conf = r.config
    ref_common.plain_precision(tf32)
    try:
        ref = cells.reference_model(conf)(**conf["model"]).to(r.device,
                                                               dtype)
        ref.load_state_dict(weights, strict=True)
        got = train_updates(
            ref, records, seed=r.job_seed, batch=conf["data"]["batch_size"],
            optim=conf["optim"],
            epoch_micro_steps=conf["epoch_micro_steps"],
            updates=r.mix["compare_updates"],
            augment=conf["data"]["augment"], device=r.device,
            keep_graphs=keep_graphs)
    finally:
        ref_common.plain_precision(False)
    bn, tracked = bn_state(ref)
    bn1, tracked1 = got["bn1"]
    return {"stats": got["stats"], "grad1": got["grad1"],
            "bn1": {n: b - weights[n] for n, b in bn1.items()},
            "tracked1": tracked1,
            "change": {n: p.detach() - weights[n]
                       for n, p in ref.named_parameters()},
            "bn": {n: b - weights[n] for n, b in bn.items()},
            "tracked": tracked}
