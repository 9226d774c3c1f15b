"""Run orchestration: training, the ADP inference sweep and the
Monte-Carlo rotation audit (port of cartnet_tpu/runner.py::run, ::train,
::inference and ::montecarlo). Every mode serves any ported model
(CartNet, eComformer, iComformer).

``train`` runs the JAX package's epoch loop: a train epoch (SO(3)
augmentation where the config asks for it), a val pass, one ``stats.json``
line per split and epoch under ``cfg.run_dir/{train,val,test}``,
``ckpt/best.ckpt`` when the val MAE improves and ``ckpt/last.ckpt`` every
epoch, then the final test from ``best.ckpt`` with the 3D IoU stat on
Cholesky heads. ``resume`` continues from ``last.ckpt``: the state, the
epoch, the best val MAE and the train pipeline's random state, so a
resumed run ends as the unbroken one would (the JAX package re-seeds its
pipeline on resume instead). The guard (train/guard.py) beats the
heartbeat file at startup, every epoch, on a rollback and at the end
("stopped"); with ``cfg.guard.enabled`` it reports each epoch to a
``GuardMonitor`` and, when that asks, rolls the state back to
``last.ckpt`` (to the starting state before the first one) and retries
the epoch with the shuffle the train pipeline's generator gives next;
past ``max_retries`` rollbacks it raises. ``profile`` traces the first
train epoch with ``torch.profiler`` (host and, on the card, CUDA
activities) into ``cfg.run_dir/profile`` and logs the port's host spans
and counters of that epoch (``tracing.format_table``). ``wandb`` logs
each epoch's stats and the test stats to a wandb run
(``train/logger.WandbLogger``).

Data and edge parallelism (a ``torch.distributed`` world of
``cfg.parallel.dp`` x ``cfg.parallel.ep`` ranks, one card each, dp-major;
parallel/): every rank iterates the same seeded pipelines and takes dp
member ``r // ep`` of each group of dp consecutive batches
(``ShardedPipeline``; a short last group gives the ranks past its end an
all-masked batch, so that every rank reaches each collective), and of
that batch ep member ``r % ep``'s share: its edge slice, or under
``cfg.parallel.halo`` its block of the halo layout
(parallel/partition.py, parallel/halo.py), with the loss mask split over
the ep members. An epoch has ``sharded_steps_per_epoch`` optimizer
micro-steps on every rank and the OneCycle schedule is built from that
count, as in the JAX package. The steps are
``parallel/step.make_parallel_steps`` over the rank's ``dist.Groups``
(``pdist.make_groups``); the loggers sum the epoch's stats over the world.
Rank 0 alone writes ``stats.json``, the checkpoints, the heartbeat, the
profile and the inference pickle; ``resume`` and a rollback restore every
rank from the same file.

Chunked execution (``--chunks K`` > 1 in one process, the JAX runner's
wiring): the pads take the chunk slack (``pipelines``), and the train,
val and test batches are laid out in K member-major chunks as they are
reached (parallel/chunk.py), then run through the single-process steps.
Under dp·ep > 1 chunks are ignored with the JAX warning (the pads keep
their multiples); with ``--fused_steps`` the epochs run unfused, with the
JAX warning; a model other than CartNet raises the JAX error.

Fused epochs (``cfg.optim.fused_steps`` K > 1, the JAX runner's wiring):
each train epoch runs ``loop.train_epoch_fused`` over K micro-steps a
device launch (``loop.make_fused_chunk``, under data parallelism
``parallel/step.make_parallel_fused_chunk``), each chunk one CUDA-graph
replay on the card (``train/graphs.ChunkRunner``; NCCL under data
parallelism) and run eagerly on the CPU. The optimizer steps on the device
once ``batch_accumulation`` valid micro-steps are in; the host update count
is read back once an epoch, before the checkpoints are written, so the
guard, the heartbeat, the rollback, the checkpoints, ``resume`` and
``profile`` work as they do around unfused epochs, and a run may resume
with ``fused_steps`` on or off.

``inference`` runs the eval forward batch by batch and writes one entry per
structure: pred/true of its non-H atoms, cell, temperature, positions, atom
types, its index as ``refcode``, and its MAE, per-atom 3D IoU and per-atom
S12 (under data parallelism each rank sweeps its member batches and rank 0
gathers the entries in the single-process order; under edge parallelism
the ep members' predictions, copied or, under halo, owned, are put
together on the slice's first member). ``montecarlo`` repeats the sweep
under random rotations of the edge
directions, against the unrotated prediction rotated as Rᵀ U R. The pickle
layouts and the log lines are the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import logging
import os
import pickle
import time
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from cartnet_tpu_torch import tracing
from cartnet_tpu_torch.config import Config, resolve_device
from cartnet_tpu_torch.data.batching import all_masked
from cartnet_tpu_torch.data.pipeline import (BatchPipeline,
                                             choose_pad_sizes_from_counts,
                                             edge_align_for, record_counts)
from cartnet_tpu_torch.data.schema import CrystalBatch
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.ops.rotations import random_rotation
from cartnet_tpu_torch.parallel import dist as pdist
from cartnet_tpu_torch.parallel.chunk import ChunkedPipeline
from cartnet_tpu_torch.parallel.halo import to_halo
from cartnet_tpu_torch.parallel.partition import (ep_member, halo_member,
                                                  pad_multiples)
from cartnet_tpu_torch.parallel.step import (make_parallel_fused_chunk,
                                             make_parallel_steps)
from cartnet_tpu_torch.train import checkpoint as ckpt
from cartnet_tpu_torch.train.graphs import ChunkRunner
from cartnet_tpu_torch.train.guard import GuardMonitor, Heartbeat
from cartnet_tpu_torch.train.logger import WandbLogger, create_loggers
from cartnet_tpu_torch.train.loop import (build_lr_fn, build_optimizer,
                                          eval_epoch, init_train_state,
                                          make_fused_chunk, make_steps,
                                          train_epoch, train_epoch_fused)
from cartnet_tpu_torch.train.metrics import (compute_3d_iou,
                                             get_similarity_index)


def sharded_steps_per_epoch(unsharded_len: int, dp: int) -> int:
    """Micro-steps per epoch of ``dp`` ranks over a pipeline of
    ``unsharded_len`` batches (one bucket)."""
    return -(-unsharded_len // max(dp, 1))


class ShardedPipeline:
    """Rank ``rank``'s view of a pipeline under ``dp`` data-parallel ranks
    of ``ep`` members each (host batches, dp-major ranks): dp member
    ``rank // ep`` of each group of ``dp`` consecutive batches, cut for ep
    member ``rank % ep`` (its edge slice, or with ``halo`` its block of
    the halo layout, ``halo_max`` rows from an owner at most;
    parallel/partition.py). A group never spans a bucket boundary, and a
    rank past the end of a short group gets that group's last batch with
    every mask off (``all_masked``), so that every rank takes the same
    number of steps. Every rank iterates (and collates) the whole
    pipeline, as the JAX package's single controller does, so the shuffle
    and the augmentation draws stay those of one process."""

    def __init__(self, pipe, dp: int, rank: int = 0, ep: int = 1,
                 halo: bool = False, halo_max: Optional[int] = None):
        self.pipe = pipe
        self.dp = max(dp, 1)
        self.ep = max(ep, 1)
        self.rank = rank
        self.halo = halo and self.ep > 1
        self.halo_max = halo_max

    @property
    def rng(self):
        return self.pipe.rng

    def __len__(self):
        if hasattr(self.pipe, "bucket_batch_counts"):
            return sum(sharded_steps_per_epoch(c, self.dp)
                       for c in self.pipe.bucket_batch_counts())
        return sharded_steps_per_epoch(len(self.pipe), self.dp)

    def _pairs(self):
        if hasattr(self.pipe, "iter_with_bucket"):
            yield from self.pipe.iter_with_bucket()
        else:
            for b in self.pipe:
                yield 0, b

    def _slice(self, group: list) -> CrystalBatch:
        i = self.rank // self.ep
        return group[i] if i < len(group) else all_masked(group[-1])

    def slices(self):
        """(this rank's dp-slice batch as the sweep reads it: the halo
        layout's under ``halo``, the ep member's batch) per step."""
        group, cur = [], None
        for bid, b in self._pairs():
            if group and bid != cur:
                yield self._cut(self._slice(group))
                group = []
            cur = bid
            group.append(b)
            if len(group) == self.dp:
                yield self._cut(self._slice(group))
                group = []
        if group:
            yield self._cut(self._slice(group))

    def _cut(self, batch: CrystalBatch) -> tuple:
        m = self.rank % self.ep
        if self.halo:
            hb = to_halo(batch, self.ep, self.halo_max)
            return hb, halo_member(hb, self.ep, m)
        return batch, ep_member(batch, self.ep, m)

    def __iter__(self):
        return (mine for _, mine in self.slices())


def chunk_count(cfg: Config) -> int:
    """The chunks a batch is laid out in: ``cfg.parallel.chunks``, or 1
    on a dp x ep world of more than one rank, where chunked execution,
    a single-device mode, is ignored."""
    par = cfg.parallel
    return 1 if par.dp * max(par.ep, 1) > 1 else max(par.chunks, 1)


def chunked(pipes, cfg: Config):
    """The pipelines of chunked execution (``ChunkedPipeline`` each) when
    ``cfg.parallel.chunks`` > 1 applies; else ``pipes``, with the JAX
    runner's warning where a dp x ep world ignores the chunks. Chunked
    execution supports CartNet only, as in the JAX package."""
    par, k = cfg.parallel, chunk_count(cfg)
    if par.chunks > 1 and k == 1:
        logging.warning("--chunks is a single-device execution mode and is "
                        "ignored on a %dx%d mesh (the halo layout already "
                        "bounds per-device kernel tables)", par.dp,
                        max(par.ep, 1))
    if k == 1:
        return pipes
    if cfg.model.name != "cartnet":
        raise ValueError("chunked execution supports model 'cartnet' only "
                         "(the chunk re-layout is the halo layout)")
    logging.info("chunked execution: %d member-major chunks per batch", k)
    return tuple(ChunkedPipeline(p, k) for p in pipes)


def world_of(group):
    """The world process group of ``group`` (a ``dist.Groups``), None in
    one process."""
    return None if group is None else group.edge


def sharded(pipes, cfg: Config, group):
    """Each pipeline as this rank's ``ShardedPipeline`` (``pipes`` as they
    are in one process)."""
    if group is None:
        return pipes
    par, world = cfg.parallel, world_of(group)
    ep = group.ep_size
    return tuple(ShardedPipeline(p, pdist.world(world) // ep,
                                 pdist.rank(world), ep, par.halo,
                                 par.halo_max) for p in pipes)


def rank0_first(group, fn):
    """``fn()`` on rank 0, then on the other ranks (what it writes beside
    the data, caches and sidecars, is written once)."""
    if group is None:
        return fn()
    if pdist.is_main(group):
        out = fn()
        dist.barrier(group)
        return out
    dist.barrier(group)
    return fn()


def pipelines(cfg: Config, splits):
    """(train, val, test) pipelines with one pad shape for all three
    splits (with ``cfg.data.buckets`` > 1, one a bucket of each split);
    train shuffles (seeded) and, with ``cfg.data.augment``, rotates
    (targets too on Cholesky heads); val/test do neither. Lazy sources
    (the ADP ``LazyRecords``) are fetched by a pool of 4 threads. Under
    edge parallelism the pad multiples are the JAX runner's
    (``partition.pad_multiples``), so that each member holds whole edge
    tiles and 8-aligned node blocks; with ``cfg.parallel.chunks`` K > 1
    they are those of max(ep, K), and the pads get the JAX runner's chunk
    slack, about K half crystals (a chunk packs whole crystals and wastes
    up to half of one), in every run mode and whether or not the chunks
    are then ignored (``chunk_count``)."""
    counts = [record_counts(s) for s in splits]
    nodes = np.concatenate([c[0] for c in counts])
    edges = np.concatenate([c[1] for c in counts])
    align = edge_align_for(edges)
    k = cfg.parallel.chunks
    node_mult, edge_mult = pad_multiples(max(cfg.parallel.ep, 1, k))
    mn, me = choose_pad_sizes_from_counts(nodes, edges, cfg.data.batch_size,
                                          node_mult, edge_mult,
                                          edge_align=align)
    if k > 1:
        slack = lambda mean, mult: -(-int(k * mean / 2 + mult) // mult) * mult
        mn += slack(np.mean(nodes), node_mult)
        me += slack(np.mean(edges), edge_mult)
    workers = 0 if isinstance(splits[0], list) else 4
    return tuple(BatchPipeline(recs, cfg.data.batch_size, mn, me,
                               shuffle=train, augment=train and
                               cfg.data.augment,
                               rotate_targets=cfg.model.cholesky,
                               seed=cfg.seed, workers=workers,
                               buckets=cfg.data.buckets, edge_align=align,
                               node_multiple=node_mult,
                               edge_multiple=edge_mult)
                 for recs, train in zip(splits, (True, False, False)))


def run(cfg: Config, splits, device="cuda", state_dict=None,
        resume: bool = False, profile: bool = False, group=None,
        wandb: Optional[dict] = None):
    """Build pipelines, model (random from ``cfg.seed``, or ``state_dict``)
    and optimizer, then ``train``; ``group``: this rank's ``dist.Groups``
    (``pdist.make_groups``; None in one process); ``wandb``: the wandb
    project and entity to log to (None: no wandb)."""
    device = resolve_device(device)
    pipes = rank0_first(world_of(group), lambda: pipelines(cfg, splits))
    model = create_model(cfg.model, device, cfg.seed)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    logging.info("model %s: %.3fM params", cfg.model.name, n_params / 1e6)
    steps = len(sharded(pipes, cfg, group)[0])
    optimizer = build_optimizer(cfg, model.parameters(), steps)
    return train(cfg, init_train_state(model, optimizer, cfg.seed), pipes,
                 device, resume, profile, group, wandb)


def checkpoint_paths(run_dir: str):
    """(best, last) checkpoint files of a run."""
    d = os.path.join(run_dir, "ckpt")
    return os.path.join(d, "best.ckpt"), os.path.join(d, "last.ckpt")


def _snapshot(state) -> bytes:
    """The whole train state, serialized (the epoch-0 rollback target)."""
    buf = io.BytesIO()
    torch.save(state.state_dict(), buf)
    return buf.getvalue()


def _profiled(run_dir: str, device):
    """A ``torch.profiler`` context writing a trace into
    ``<run_dir>/profile``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    trace_dir = os.path.join(run_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir))


def train(cfg: Config, state, pipes, device="cuda", resume: bool = False,
          profile: bool = False, group=None, wandb: Optional[dict] = None):
    """Epoch loop -> (state with the best weights, test stats); in
    parallel (``group``, as in ``run``) on this rank's member batches."""
    device = resolve_device(device)
    world = world_of(group)
    main = pdist.is_main(world)
    pipes = sharded(pipes, cfg, group)
    if group is not None:
        p = pipes[0]
        logging.info("parallel: rank %d, dp %d x ep %d%s", p.rank, p.dp,
                     p.ep, " (halo)" if p.halo else "")
    pipes = chunked(pipes, cfg)
    train_pipe, val_pipe, test_pipe = pipes
    loggers = create_loggers(cfg.run_dir, device, world)
    n_params = sum(p.numel() for p in state.model.parameters())
    for lg in loggers:
        lg.params = n_params
    wb = WandbLogger(**(wandb or {}), name=cfg.name,
                     config=dataclasses.asdict(cfg),
                     enabled=main and wandb is not None)
    best_path, last_path = checkpoint_paths(cfg.run_dir)
    start_epoch, best = 0, (float("inf"), -1)
    if resume and ckpt.latest_step(last_path) is not None:
        state, meta = ckpt.restore_checkpoint(last_path, state)
        start_epoch = meta["epoch"] + 1
        best = (meta["best_val"], meta["best_epoch"])
        train_pipe.rng.bit_generator.state = meta["pipeline_rng"]
        logging.info("resumed at epoch %d (best %.5f @ %d)", start_epoch,
                     *best)
    hb = Heartbeat(cfg.guard.heartbeat_path if main else None,
                   cfg.guard.heartbeat_interval)
    hb.start()
    hb.beat(status="startup", epoch=start_epoch, name=cfg.name)
    try:
        state, best = _epochs(cfg, state, pipes, device, loggers, hb,
                              start_epoch, best, profile and main, group, wb)
        if os.path.isfile(best_path):
            state, _ = ckpt.restore_checkpoint(best_path, state)
        evals = (make_steps(cfg)[2] if group is None
                 else make_parallel_steps(cfg, group)[2])
        eval_epoch(state, test_pipe, evals, device,
                   iou=cfg.model.cholesky, logger=loggers[2])
        test_stats = loggers[2].write_epoch(best[1])
        wb.log({f"test/{k}": v for k, v in test_stats.items()})
        wb.finish()
    except BaseException:
        hb.stop(status="failed")
        raise
    hb.stop()
    return state, test_stats


def _epochs(cfg: Config, state, pipes, device, loggers, hb, epoch: int,
            best: tuple, profile: bool, group=None, wb=None):
    """Epochs ``epoch`` .. max_epoch - 1, with the guard's rollbacks ->
    (state, (best val MAE, its epoch))."""
    train_pipe, val_pipe, _ = pipes
    micro, update, evals = (make_steps(cfg) if group is None
                            else make_parallel_steps(cfg, group))
    world = world_of(group)
    main = pdist.is_main(world)
    lr_fn = build_lr_fn(cfg, len(train_pipe))
    k = cfg.optim.fused_steps
    run_chunk = None
    if k > 1 and chunk_count(cfg) > 1:
        logging.warning("fused_steps with --chunks is not supported yet; "
                        "running unfused epochs")
    elif k > 1:
        run_chunk = ChunkRunner(
            make_fused_chunk(cfg, k) if group is None
            else make_parallel_fused_chunk(cfg, group, k), k, device, world)
        logging.info("fused epochs: %d micro-steps per device launch", k)

    def train_pass(state):
        if run_chunk is not None:
            return train_epoch_fused(state, train_pipe, run_chunk, k, update,
                                     cfg.optim.batch_accumulation, device,
                                     loggers[0], lr_fn)
        return train_epoch(state, train_pipe, micro, update,
                           cfg.optim.batch_accumulation, device, loggers[0],
                           lr_fn)

    best_path, last_path = checkpoint_paths(cfg.run_dir)
    monitor, state0 = None, None
    if cfg.guard.enabled:
        monitor = GuardMonitor(cfg.guard.max_bad_fraction,
                               cfg.guard.max_retries,
                               initial_bad_steps=int(state.bad_steps))
        state0 = _snapshot(state)
    first, epoch_times = epoch, []
    while epoch < cfg.optim.max_epoch:
        t0 = time.perf_counter()
        profiled = profile and epoch == first
        with (_profiled(cfg.run_dir, device) if profiled
              else contextlib.nullcontext()):
            state, _ = train_pass(state)
        if profiled:
            logging.info("host spans of the profiled epoch:\n%s",
                         tracing.format_table())
        train_stats = loggers[0].write_epoch(epoch)
        eval_epoch(state, val_pipe, evals, device, logger=loggers[1])
        val_stats = loggers[1].write_epoch(epoch)
        val_mae = val_stats["MAE"]
        epoch_times.append(time.perf_counter() - t0)
        if monitor is not None and monitor.epoch_report(
                int(state.bad_steps), max(len(train_pipe), 1),
                float(val_mae)):
            logging.warning("epoch %d diverged (bad steps %d, val MAE %s); "
                            "rolling back to the last checkpoint (retry "
                            "%d/%d)", epoch, int(state.bad_steps), val_mae,
                            monitor.retries, cfg.guard.max_retries)
            if ckpt.latest_step(last_path) is not None:
                state, _ = ckpt.restore_checkpoint(last_path, state)
            else:
                state.load_state_dict(torch.load(io.BytesIO(state0),
                                                 weights_only=True))
            monitor.note_rollback(int(state.bad_steps))
            hb.beat(status="rollback", epoch=epoch)
            continue  # the same epoch, on the shuffle the generator gives
        if val_mae < best[0]:
            best = (val_mae, epoch)
            if main:
                ckpt.save_checkpoint(best_path, state)
                logging.info("best checkpoint saved (epoch %d, val MAE "
                             "%.5f)", epoch, val_mae)
        if main:
            ckpt.save_checkpoint(last_path, state, {
                "epoch": epoch, "best_val": best[0], "best_epoch": best[1],
                "pipeline_rng": train_pipe.rng.bit_generator.state})
        if world is not None:  # the files are there before any rank reads
            dist.barrier(world)
        if wb is not None:
            wb.log({**{f"train/{k}": v for k, v in train_stats.items()},
                    **{f"val/{k}": v for k, v in val_stats.items()},
                    "best/epoch": best[1], "best/val_MAE": best[0]},
                   step=epoch)
        logging.info("> Epoch %d: %.1fs (avg %.1fs) | best epoch %d val_MAE "
                     "%.5f | optimizer steps %d, bad steps %d", epoch,
                     epoch_times[-1], np.mean(epoch_times), best[1],
                     best[0], state.step, int(state.bad_steps))
        hb.beat(status="training", epoch=epoch, step=state.step,
                best_val=float(best[0]))
        epoch += 1
    return state, best


def _per_structure_rows(batch: CrystalBatch, pred, mask):
    """Split a padded host batch into per-structure entries (graph_id)."""
    m = np.asarray(mask)
    gid = np.asarray(batch.graph_id)
    for g in np.flatnonzero(np.asarray(batch.graph_mask)):
        sel = m & (gid == g)
        yield {"pred": pred[sel], "true": np.asarray(batch.y)[sel],
               "cell": np.asarray(batch.cell)[g],
               "temp": float(np.asarray(batch.temperature)[g]),
               "pos": np.asarray(batch.pos)[sel],
               "atoms": np.asarray(batch.z)[sel]}


def _entries(batch: CrystalBatch, pred, mask, device) -> list:
    """One entry per structure of a host batch, with the per-structure MAE
    and the per-atom IoU and S12 computed on ``device``."""
    rows = []
    for row in _per_structure_rows(batch, pred, mask):
        p, t = row["pred"], row["true"]
        pt = torch.as_tensor(p, device=device)
        tt = torch.as_tensor(t, device=device)
        rows.append({**row, "mae": float(np.abs(p - t).mean()),
                     "iou": compute_3d_iou(pt, tt).cpu().numpy(),
                     "similarity_index":
                         get_similarity_index(pt, tt).cpu().numpy()})
    return rows


def _append(out: dict, rows: list) -> None:
    """Appends entries to ``out`` (its keys pick the fields; ``temp`` only
    where ``out`` has it), each with its running index as ``refcode``."""
    for row in rows:
        for k in ("pred", "true", "cell", "temp", "pos", "atoms", "mae",
                  "iou", "similarity_index"):
            if k in out:
                out[k].append(row[k])
        out["refcode"].append(len(out["refcode"]))


def _add_rows(out: dict, batch: CrystalBatch, pred, mask, device) -> None:
    """Appends one entry per structure of a host batch to ``out``."""
    _append(out, _entries(batch, pred, mask, device))


def _gathered(per_batch: list, group):
    """Each rank's per-batch entry lists -> on rank 0, every entry in the
    single-process order (step by step, rank by rank); None elsewhere."""
    if group is None:
        return [r for rows in per_batch for r in rows]
    main = pdist.is_main(group)
    everyone = [None] * pdist.world(group) if main else None
    dist.gather_object(per_batch, everyone,
                       dst=dist.get_global_rank(group, 0), group=group)
    if not main:
        return None
    return [r for step in zip(*everyone) for rows in step for r in rows]


def inference(model, batches: Iterable[CrystalBatch], output_path: str,
              device="cuda", group=None, halo: bool = False,
              halo_max: Optional[int] = None):
    """Per-structure test sweep with ADP metrics on ``device`` (the card
    unless the caller passes ``device="cpu"``).

    ``batches`` are host (numpy) batches; each is moved to the device, run
    through ``model`` (pred [N, 3, 3]) and split per structure. Returns the
    dict that is pickled to ``output_path``. In parallel (``group``, as in
    ``run``) each rank sweeps its member batches of ``batches``
    (``ShardedPipeline``, with ``halo`` partitioning over ``halo_max``
    rows an owner); the ep members' predictions (copied, or under halo
    each member's own rows, gathered) are split per structure on the dp
    slice's first member, and rank 0 gathers, writes and returns the
    entries; the other ranks return None."""
    if not model.cfg.cholesky:
        raise ValueError("the inference sweep needs the Cholesky ADP head")
    device = resolve_device(device)
    model = model.to(device)
    groups, world = pdist.SINGLE, None
    slices = ((b, b) for b in batches)
    if group is not None:
        groups, world = group, world_of(group)
        ep = groups.ep_size
        slices = ShardedPipeline(batches, pdist.world(world) // ep,
                                 pdist.rank(world), ep, halo,
                                 halo_max).slices()
    per_batch = []
    for full, mine in slices:
        with torch.inference_mode():
            pred, _ = model(mine.to(device), groups)
            if mine.halo:  # the members' own rows, member-major
                parts = [torch.empty_like(pred)
                         for _ in range(groups.ep_size)]
                dist.all_gather(parts, pred.contiguous(), group=groups.ep)
                pred = torch.cat(parts)
        per_batch.append(
            _entries(full, pred.float().cpu().numpy(),
                     np.asarray(full.non_h_mask), device)
            if groups.ep_rank == 0 else [])
    rows = _gathered(per_batch, world)
    if rows is None:
        return None
    out = {"pred": [], "true": [], "temp": [], "cell": [], "refcode": [],
           "pos": [], "atoms": [], "iou": [], "mae": [],
           "similarity_index": []}
    _append(out, rows)
    for k in ("iou", "similarity_index"):
        v = np.concatenate(out[k]) if out[k] else np.zeros(0)
        logging.info("Mean %s: %s +/- %s", k, v.mean(), v.std())
    mae = np.asarray(out["mae"])
    logging.info("Mean mae: %s +/- %s", mae.mean(), mae.std())
    with open(output_path, "wb") as f:
        pickle.dump(out, f)
    return out


def montecarlo_round(model, batches: Iterable[CrystalBatch], R,
                     device="cuda") -> dict:
    """One round of the audit: for each host batch, the eval prediction U
    on the batch as is (the pseudo-truth) and the prediction on the batch
    with ``cart_dir @ R``, which must match Rᵀ U R -> the per-structure
    entries (the inference sweep's, without ``temp``)."""
    out = {"pred": [], "true": [], "cell": [], "refcode": [], "pos": [],
           "atoms": [], "mae": [], "iou": [], "similarity_index": []}
    Rn = R.float().cpu().numpy()
    Rd = R.to(device=device, dtype=torch.float32)
    for batch in batches:
        b = batch.to(device)
        with torch.inference_mode():
            pseudo, mask = model(b)
            pred, _ = model(dataclasses.replace(b, cart_dir=b.cart_dir @ Rd))
        target = dataclasses.replace(batch, y=np.einsum(
            "ji,njk,kl->nil", Rn, pseudo.float().cpu().numpy(), Rn))
        _add_rows(out, target, pred.float().cpu().numpy(),
                  mask.cpu().numpy(), device)
    return out


def montecarlo(cfg: Config, model, test_pipe, output_path: str,
               iterations: int = 100, device="cuda"):
    """SO(3) robustness audit: ``iterations`` rounds, each under one
    rotation from ``random_rotation`` on a torch.Generator seeded with
    ``cfg.seed`` (the JAX package draws its rotations from jax.random, so
    the two audits see different rotations). Each round writes
    ``<output>_montecarlo_<i>.pkl`` and logs its means over the per-atom
    metrics; the final stats (mean, std) over every round's per-atom
    metrics are logged and pickled to ``output_path`` -> that dict."""
    if not model.cfg.cholesky:
        raise ValueError("the Monte-Carlo audit needs the Cholesky ADP head")
    device = resolve_device(device)
    model = model.to(device).eval()
    gen = torch.Generator().manual_seed(cfg.seed)
    base = output_path[:-4] if output_path.endswith(".pkl") else output_path
    all_iou, all_mae, all_sim = [], [], []
    for it in range(iterations):
        out = montecarlo_round(model, test_pipe, random_rotation(gen),
                               device)
        with open(f"{base}_montecarlo_{it}.pkl", "wb") as f:
            pickle.dump(out, f)
        iou_i = np.concatenate(out["iou"])
        sim_i = np.concatenate(out["similarity_index"])
        mae_i = np.asarray(out["mae"])
        logging.info("Montecarlo %d: IoU %.4f MAE %.6f S12 %.4f", it,
                     iou_i.mean(), mae_i.mean(), sim_i.mean())
        all_iou.append(iou_i)
        all_mae.append(mae_i)
        all_sim.append(sim_i)
    iou = np.concatenate(all_iou)
    mae = np.concatenate(all_mae)
    sim = np.concatenate(all_sim)
    stats = {"iou": (iou.mean(), iou.std()),
             "mae": (mae.mean(), mae.std()),
             "similarity_index": (sim.mean(), sim.std())}
    logging.info("Montecarlo: %s", stats)
    with open(output_path, "wb") as f:
        pickle.dump(stats, f)
    return stats
