"""Mix driver ``infer_sweep``: the prediction sweep.

The pool is the test split of the program's ``runner.pipelines`` at the
mix's batch size (no shuffle, no augmentation; the pipeline collates its
batches once and keeps them). The window sweeps those batches again and
again, closed loop with one batch in flight, through the eval forward as
``runner.inference`` calls it: ``model(batch.to(device))`` under
``torch.inference_mode()``, the predictions copied to the host each batch.
A batch fails where a real atom's prediction is not finite. Set-up
runs ``warm_passes`` sweeps. Once the window has closed, a sample of the
window's answers drawn from the seed (with every batch of the first pass
and the last answer) is compared with the plain reference's eval forward
on the same crystals."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench_h100 import flops
from bench_h100.harness import cells, compare, crystals
from bench_h100.harness.readings import (Clock, Readings, Window,
                                           batch_counts, log)
from bench_h100.harness.spans import Spans
from bench_h100.harness.trace import Stretch
from bench_h100.harness.weights import make_weights
from bench_h100.reference import common as ref_common


def run(r) -> tuple:
    from cartnet_tpu_torch import runner
    from cartnet_tpu_torch.models.factory import create_model

    dev, mix, conf = r.device, r.mix, r.config
    cfg = cells.port_config(conf, mix, r.job_seed)
    clock = Clock()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the CUDA context
        clock.lap("cuda")
    records = crystals.make_pool(mix["pool"], cfg.data.radius,
                                 cfg.data.max_neighbors, r.seed, r.cache_dir)
    clock.lap("pool")
    pipe = runner.pipelines(cfg, ([], [], records))[2]
    clock.lap("pipeline")
    ref_cls = cells.reference_model(conf)
    weights = make_weights(ref_cls(**conf["model"]), r.weight_seed, dev)
    clock.lap("weights")
    model = create_model(cfg.model, dev, 0)
    model.load_state_dict(weights, strict=True)
    model.eval()
    spans = Spans(traced=r.trace)
    clock.lap("model")

    def predict(batch):
        with spans.span("handoff"):
            with torch.inference_mode():
                pred, _ = model(batch.to(dev))
        with spans.span("readback"):
            return pred.float().cpu().numpy()

    for _ in range(mix["warm_passes"]):
        t = time.perf_counter()
        for b in pipe:
            predict(b)
        per_batch = (time.perf_counter() - t) / len(pipe)
    n_batches = len(pipe)
    clock.lap("warm_passes")
    log(f"setup: {clock.laps}; pads {pipe.max_nodes} / {pipe.max_edges}; "
        f"allocated "
        f"{torch.cuda.memory_allocated(dev) if dev.type == 'cuda' else 0}")
    # the sample: every batch of the first pass and, drawn from the seed,
    # ``sample`` answers among those the window should reach
    due = max(n_batches, int(r.seconds / max(per_batch, 1e-6)))
    rng = np.random.default_rng([r.seed, 2])
    keep = set(range(n_batches)) | set(rng.choice(
        due, min(mix["sample"], due), replace=False).tolist())
    stretch, steps_in = Stretch(dev), []
    if r.trace:
        stretch.prime()
    spans.reset()
    kept, counts, failed = {}, [], 0
    t0 = time.perf_counter()
    r.window_opened()
    deadline = t0 + r.seconds
    i, last = 0, None
    while time.perf_counter() < deadline:
        for pos, b in enumerate(pipe):
            now = time.perf_counter()
            if now >= deadline:
                break
            if (r.trace and not stretch.active
                    and now - t0 >= r.seconds - mix["stretch_s"]):
                stretch.start()
                steps_in.append(len(counts))
            pred = predict(b)
            counts.append(batch_counts(b))
            failed += not np.isfinite(pred[np.asarray(b.node_mask)]).all()
            if i in keep:
                kept[i] = (pos, pred)
            last = (i, pos, pred)
            i += 1
    seconds = time.perf_counter() - t0
    trace = stretch.stop(counts[steps_in[0]:]) if stretch.active else None
    if last is not None:
        kept[last[0]] = last[1:]
    window = Window(
        kind="infer", seconds=seconds, steps=len(counts), replays=0,
        structures=sum(c["graphs"] for c in counts),
        flops=sum(flops.forward(conf["model"], c["nodes"], c["edges"],
                                c["graphs"]) for c in counts),
        spans=spans.table())
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"answers compared: {len(kept)} of {len(counts)}")
    batches = list(pipe)
    del model, predict
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = {"pred_gap": reference_gap(r, records, weights, batches,
                                         kept.values())}
    return (Readings(config=conf, window=window, trace=trace), numbers,
            len(counts), failed, memory)


def align(batch, records, first: int, pred: np.ndarray) -> list:
    """The program's per-atom predictions of a host batch, per crystal in
    the records' own atom order (atoms matched by their positions; the
    pipeline relabels atoms within each crystal)."""
    out = []
    gid, mask = np.asarray(batch.graph_id), np.asarray(batch.node_mask)
    pos = np.asarray(batch.pos)
    for s in np.flatnonzero(np.asarray(batch.graph_mask)):
        rows = np.flatnonzero(mask & (gid == s))
        rec_pos = np.asarray(records[first + s]["pos"], np.float32)
        mine = rows[np.lexsort(pos[rows].T[::-1])]
        theirs = np.lexsort(rec_pos.T[::-1])
        if not np.array_equal(pos[mine], rec_pos[theirs]):
            raise ValueError(f"crystal {first + s}: the batch's atoms are "
                             "not the record's")
        got = np.empty((len(rows), 3, 3), np.float32)
        got[theirs] = pred[mine]
        out.append(got)
    return out


def reference_predictions(r, records, weights, positions,
                          tf32: bool = False) -> dict:
    """The reference's eval forward of the sweep's batches at
    ``positions`` -> {position: [atoms, 3, 3] in the records' order}
    (``tf32``: the control's precision)."""
    conf, size = r.config, r.mix["batch_size"]
    ref_common.plain_precision(tf32)
    try:
        ref = cells.reference_model(conf)(**conf["model"]).to(r.device)
        ref.load_state_dict(weights, strict=True)
        ref.eval()
        want = {}
        for pos in sorted(set(positions)):
            recs = records[pos * size:(pos + 1) * size]
            with torch.no_grad():
                want[pos] = ref(ref_common.graphs(recs, r.device)).cpu(
                    ).numpy()
    finally:
        ref_common.plain_precision(False)
    return want


def non_h(records, pos: int, size: int) -> np.ndarray:
    return np.concatenate([np.asarray(x["z"]) != 1
                           for x in records[pos * size:(pos + 1) * size]])


def reference_gap(r, records, weights, batches, answers) -> float:
    """The widest gap of the kept answers ((position, host predictions)
    pairs) against the reference's eval forward."""
    size = r.mix["batch_size"]
    answers = list(answers)
    want = reference_predictions(r, records, weights,
                                 [p for p, _ in answers])
    worst = 0.0
    for pos, pred in answers:
        got = np.concatenate(align(batches[pos], records, pos * size, pred))
        keep = non_h(records, pos, size)
        worst = max(worst, compare.pred_gap(got[keep], want[pos][keep]))
    return worst
