"""Training/eval steps and the epoch loops (port of cartnet_tpu/train/loop.py).

Reference semantics:
  * per micro-batch: train forward, loss (MAE or MSE), gradients SUMMED into
    an accumulator (never averaged);
  * an optimizer update every ``batch_accumulation`` micro-batches and at
    epoch end (the epoch-end flush);
  * BN running stats advance every train micro-batch;
  * the device-side guard skips non-finite micro-steps (train/guard.py).
The steps keep everything on the device: stats stay tensors until the epoch
means are read (``epoch_means``, or an ``EpochLogger``'s ``write_epoch``:
one copy to the host per epoch). A logger passed to ``train_epoch`` gets
each micro-batch's stats, weight, lr and real edges, and the epoch's time
closed by a device synchronize; one passed to ``eval_epoch`` also gets the
masked true/pred values for r2 and Spearman.

Fused epochs (``--fused_steps K``, the JAX ``make_fused_chunk`` /
``train_epoch_fused``): a chunk runs K micro-steps with everything on the
device, the accumulation cadence included. Gradients are summed per
valid micro-batch (one holding a real graph that the guard passes), the
optimizer steps where the device count reaches ``batch_accumulation``
(``OneCycleAdam.step_where``), and fully masked pad batches fill a ragged
chunk without advancing the cadence; unlike ``train_epoch``, which counts
iterations on the host, as the JAX package's two loops differ. The host
reads the update count and ``accum_count`` once an epoch (the flush) and
the stats once for the logger, stamping each micro-step with the lr after
it. ``make_fused_steps`` is the accumulation-1 variant. On the card a
chunk is one CUDA-graph replay (train/graphs.py).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from cartnet_tpu_torch.config import Config
from cartnet_tpu_torch.data.batching import all_masked
from cartnet_tpu_torch.data.schema import CrystalBatch, array_fields
from cartnet_tpu_torch.parallel.dist import SINGLE
from cartnet_tpu_torch.train.guard import select_step, step_finite
from cartnet_tpu_torch.train.metrics import (adp_stat_sums, compute_3d_iou,
                                             masked_mae_mse)
from cartnet_tpu_torch.train.schedule import (make_optimizer, onecycle_lr,
                                              reference_total_steps)
from cartnet_tpu_torch.train.state import TrainState

Stats = Dict[str, torch.Tensor]


def loss_fn(model, batch: CrystalBatch, cfg: Config, groups=SINGLE):
    """Forward in the model's current mode (over ``groups``: the eval step
    of a parallel run) -> (loss, (mae, mse, pred, mask))."""
    pred, mask = model(batch, groups)
    mae, mse = masked_mae_mse(pred, batch.y, mask)
    loss = mae if cfg.optim.loss == "MAE" else mse
    return loss, (mae, mse, pred, mask)


def _stats_with_adp(cfg: Config, base: Stats, pred, y, mask) -> Stats:
    """Adds the per-epoch ADP stats (volume error, S12) for Cholesky runs."""
    if not cfg.model.cholesky:
        return base
    vol, sim, n = adp_stat_sums(pred.detach(), y, mask)
    n = torch.clamp(n, min=1.0)
    return {**base, "volume_percentage_error": vol / n,
            "similarity_index": sim / n}


def target_weight(batch: CrystalBatch):
    """Logger weight of a batch: non-H atoms for ADP targets, graphs for
    scalar targets (a float for a host batch, a tensor for a device one)."""
    mask = batch.non_h_mask if batch.y.ndim >= 3 else batch.graph_mask
    if isinstance(mask, torch.Tensor):
        return mask.sum()
    return float(np.sum(mask))


def bn_buffers(model) -> List[torch.Tensor]:
    """Every BatchNorm running-stat buffer of the model, in a fixed order."""
    return [b for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)
            for b in (m.running_mean, m.running_var, m.num_batches_tracked)]


def init_train_state(model, optimizer, seed: int = 0) -> TrainState:
    dev = optimizer.params[0].device
    return TrainState(
        model=model, optimizer=optimizer,
        grad_accum=[torch.zeros_like(p) for p in optimizer.params],
        accum_count=torch.zeros((), dtype=torch.int32, device=dev), step=0,
        bad_steps=torch.zeros((), dtype=torch.int32, device=dev),
        generator=torch.Generator().manual_seed(seed))


def param_grads(loss, params) -> List[torch.Tensor]:
    """d loss / d params, zeros for parameters the loss does not use."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def accumulate(state: TrainState, cfg: Config, loss, grads, bufs,
               old_bn, live=None) -> torch.Tensor:
    """The micro-step's tail: with the guard on, a non-finite step adds
    nothing and puts back the BN buffers ``bufs`` had (``old_bn``); the
    gradients are summed into the accumulator and the counters advance.
    ``live`` (a fused chunk's micro-step): a device bool, False on a fully
    masked pad batch, which then adds nothing either and counts neither as
    accumulated nor as bad. -> the device bool: the step was accumulated."""
    ok = torch.ones((), dtype=torch.bool, device=loss.device)
    if cfg.guard.enabled:
        ok = step_finite(loss.detach(), grads)
    keep, bad = (ok, ~ok) if live is None else (ok & live, ~ok & live)
    if cfg.guard.enabled or live is not None:
        grads, bn = select_step(keep, grads, bufs, old_bn)
        with torch.no_grad():
            for b, v in zip(bufs, bn):
                b.copy_(v)
    with torch.no_grad():
        torch._foreach_add_(state.grad_accum, grads)
    state.accum_count += keep.int()
    state.bad_steps += bad.int()
    return keep


def train_forward(cfg: Config, state: TrainState, batch: CrystalBatch):
    """The train forward and backward of one device micro-batch -> (loss,
    stats, gradients aligned with the optimizer's params, live: a device
    bool, the batch holds a real graph)."""
    model = state.model
    model.train()
    loss, (mae, mse, pred, mask) = loss_fn(model, batch, cfg)
    grads = param_grads(loss, state.optimizer.params)
    stats = _stats_with_adp(cfg, {"loss": loss.detach(), "MAE": mae.detach(),
                                  "MSE": mse.detach()}, pred, batch.y, mask)
    return loss, stats, grads, batch.graph_mask.any()


def make_steps(cfg: Config, forward=None, groups=SINGLE):
    """-> (micro_step, update_step, eval_step); batches are on the device.
    ``forward(state, batch)``: the micro-step's forward and backward
    (``train_forward`` by default, or the parallel one); ``groups``: the
    eval forward's (parallel/dist.py)."""
    forward = forward or functools.partial(train_forward, cfg)

    def micro_step(state: TrainState, batch: CrystalBatch):
        bufs = bn_buffers(state.model)
        old_bn = [b.clone() for b in bufs] if cfg.guard.enabled else None
        loss, stats, grads, _ = forward(state, batch)
        accumulate(state, cfg, loss, grads, bufs, old_bn)
        return state, stats

    def update_step(state: TrainState):
        state.optimizer.step(state.grad_accum)
        for g in state.grad_accum:
            g.zero_()
        state.accum_count.zero_()
        state.step += 1
        return state

    def eval_step(state: TrainState, batch: CrystalBatch):
        model = state.model
        model.eval()
        with torch.no_grad():
            loss, (mae, mse, pred, mask) = loss_fn(model, batch, cfg,
                                                   groups)
            stats = _stats_with_adp(cfg, {"loss": loss, "MAE": mae,
                                          "MSE": mse}, pred, batch.y, mask)
        return pred, mask, stats

    return micro_step, update_step, eval_step


def real_edges(batch: CrystalBatch) -> float:
    """Masked-in edges of a host batch."""
    return float(np.sum(np.asarray(batch.edge_mask)))


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_epoch(state: TrainState, batches: Iterable[CrystalBatch],
                micro_step, update_step, batch_accumulation: int,
                device="cuda", logger=None,
                lr_fn: Optional[Callable[[int], float]] = None
                ) -> Tuple[TrainState, List[tuple]]:
    """One epoch: an update every ``batch_accumulation`` micro-batches and a
    flush of a partial accumulation at epoch end. Returns the state and
    (stats, weight) per micro-batch, still on the device; ``logger`` gets
    each micro-batch with the lr after it (``lr_fn`` of the update count)
    and the epoch's seconds."""
    t0 = time.perf_counter()
    rows = []
    count = 0
    for i, batch in enumerate(batches):
        state, stats = micro_step(state, batch.to(device))
        rows.append((stats, target_weight(batch)))
        count += 1
        if (i + 1) % batch_accumulation == 0:
            state = update_step(state)
        if logger is not None:
            logger.update(stats, weight=rows[-1][1],
                          lr=float(lr_fn(state.step)) if lr_fn else 0.0,
                          edges=real_edges(batch))
    if count % batch_accumulation != 0:  # epoch-end flush
        state = update_step(state)
    if logger is not None:
        _synchronize(device)
        logger.note_time(time.perf_counter() - t0)
    return state, rows


# ------------------------------------------------------------ fused epochs

def update_where(state: TrainState, pred) -> None:
    """``update_step`` where the device bool ``pred`` holds (the JAX
    chunk's ``lax.cond``), with no host sync: Adam from the device count
    (``OneCycleAdam.step_where``), the accumulator and its count zeroed.
    The host ``state.step`` follows at the epoch's end (``sync_step``)."""
    state.optimizer.step_where(state.grad_accum, pred)
    with torch.no_grad():
        torch._foreach_mul_(state.grad_accum,
                            (~pred).to(state.grad_accum[0].dtype))
    state.accum_count.masked_fill_(pred, 0)


def sync_step(state: TrainState) -> int:
    """The host update count from the device one (one host read)."""
    state.step = state.optimizer.sync_count()
    return state.step


def member(stacked: CrystalBatch, k: int) -> CrystalBatch:
    """Micro-batch ``k`` of a stacked batch (views of its fields)."""
    return dataclasses.replace(stacked, **{
        k_: a[k] for k_, a in array_fields(stacked).items()})


def stack_batches(batches: List[CrystalBatch]) -> CrystalBatch:
    """Host batches of one pad shape -> one host batch whose fields carry
    a leading K axis. (The JAX package's flag normalisation for its TPU
    kernels has no counterpart: the Hopper kernels take every batch.)
    Under halo partitioning the chunk exchanges rows unless every batch's
    halo is empty (the JAX package's ``stack_for_shards`` flag rule)."""
    return dataclasses.replace(
        batches[0], halo_empty=all(b.halo_empty for b in batches), **{
            k: np.stack([np.asarray(getattr(b, k)) for b in batches])
            for k in array_fields(batches[0])})


def fused_micro_step(cfg: Config, state: TrainState, batch: CrystalBatch,
                     forward) -> Stats:
    """One micro-step of a fused chunk (the JAX ``make_fused_chunk``'s
    ``one``), all on the device: the forward and backward, the guard, a
    micro-step that is valid (its batch holds a real graph, and the guard
    passes) accumulates and advances the cadence, an invalid one adds
    nothing and puts back the BN buffers (a pad step is not counted bad);
    then the update where the count reaches ``batch_accumulation`` ->
    the step's stats times valid, and valid."""
    bufs = bn_buffers(state.model)
    old_bn = [b.clone() for b in bufs]
    loss, stats, grads, live = forward(state, batch)
    valid = accumulate(state, cfg, loss, grads, bufs, old_bn, live)
    update_where(state, state.accum_count >= cfg.optim.batch_accumulation)
    v = valid.float()
    return {**{k: s * v for k, s in stats.items()}, "valid": v}


def make_fused_chunk(cfg: Config, num_steps: int, forward=None):
    """-> chunk(state, stacked): ``num_steps`` micro-steps over a stacked
    device batch (``stack_batches``) with the reference cadence of the JAX
    ``make_fused_chunk``: gradients summed per valid micro-batch, the
    optimizer stepping on the device once ``batch_accumulation`` of them
    are in, fully masked pad batches and guard-rejected steps leaving the
    cadence where it was -> the per-step stats, [num_steps] each
    (``fused_micro_step``). ``forward``: as in ``make_steps``. On the
    card a ``graphs.ChunkRunner`` captures it in one CUDA graph."""
    forward = forward or functools.partial(train_forward, cfg)

    def chunk(state: TrainState, stacked: CrystalBatch) -> Stats:
        rows = [fused_micro_step(cfg, state, member(stacked, k), forward)
                for k in range(num_steps)]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return chunk


def make_fused_steps(cfg: Config, num_steps: int):
    """-> fused(state, stacked): ``num_steps`` micro-steps, each followed by
    its own optimizer update (batch_accumulation 1, the JAX
    ``make_fused_steps``), from the micro-steps' gradients (the
    accumulator is not touched). With the guard on, a non-finite step
    updates nothing, puts back the BN buffers and adds to ``bad_steps``
    -> {"loss", "MAE"}, [num_steps] each. The host ``state.step`` follows
    with ``sync_step``."""
    forward = functools.partial(train_forward, cfg)

    def one(state: TrainState, batch: CrystalBatch) -> Stats:
        bufs = bn_buffers(state.model)
        old_bn = [b.clone() for b in bufs] if cfg.guard.enabled else None
        loss, stats, grads, _ = forward(state, batch)
        ok = torch.ones((), dtype=torch.bool, device=loss.device)
        if cfg.guard.enabled:
            ok = step_finite(loss.detach(), grads)
            grads, bn = select_step(ok, grads, bufs, old_bn)
            with torch.no_grad():
                for b, v in zip(bufs, bn):
                    b.copy_(v)
            state.bad_steps += (~ok).int()
        state.optimizer.step_where(grads, ok)
        return {"loss": stats["loss"], "MAE": stats["MAE"]}

    def fused(state: TrainState, stacked: CrystalBatch) -> Stats:
        rows = [one(state, member(stacked, k)) for k in range(num_steps)]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return fused


def train_epoch_fused(state: TrainState, batches: Iterable[CrystalBatch],
                      run_chunk, chunk_size: int, update_step,
                      batch_accumulation: int, device="cuda", logger=None,
                      lr_fn: Optional[Callable[[int], float]] = None
                      ) -> Tuple[TrainState, List[tuple]]:
    """One epoch of fused chunks (the JAX ``train_epoch_fused``): host
    batches go ``chunk_size`` at a time to ``run_chunk(state, batches)``
    (a ``graphs.ChunkRunner``: one CUDA-graph replay on the card), a chunk
    closes early at a pad-shape boundary, and a short chunk is padded with
    fully masked copies of its last batch. At the end, one host read of
    the device update count and one of ``accum_count`` (the epoch-end
    flush through ``update_step``), then one copy of every micro-step's
    stats for the logger, each stamped with the lr after it: the
    optimizer has stepped ``(valid micro-steps so far) //
    batch_accumulation`` times. Returns the state and (stats, weight) per
    micro-batch, as ``train_epoch`` does, on the host."""
    t0 = time.perf_counter()
    step0 = state.step
    pending, meta, group = [], [], []

    def flush():
        pad = [all_masked(group[-1])] * (chunk_size - len(group))
        pending.append((run_chunk(state, group + pad), len(group)))
        group.clear()

    for batch in batches:
        if group and (batch.z.shape != group[0].z.shape  # a new pad shape
                      or batch.edge_src.shape != group[0].edge_src.shape):
            flush()
        group.append(batch)
        meta.append((target_weight(batch), real_edges(batch)))
        if len(group) == chunk_size:
            flush()
    if group:
        flush()
    sync_step(state)
    if int(state.accum_count) > 0:  # epoch-end flush
        state = update_step(state)
    keys = list(pending[0][0]) if pending else []
    host = (torch.stack([torch.cat([s[k][:n] for s, n in pending])
                         for k in keys]).cpu().numpy() if keys else None)
    rows, valid_seen = [], 0
    for j, (w, edges) in enumerate(meta):
        row = {k: float(host[i, j]) for i, k in enumerate(keys)
               if k != "valid"}
        valid_seen += int(host[keys.index("valid"), j])
        rows.append((row, w))
        if logger is not None:
            lr = lr_fn(step0 + valid_seen // max(batch_accumulation, 1)) \
                if lr_fn else 0.0
            logger.update(row, weight=w, lr=float(lr), edges=edges)
    if logger is not None:
        _synchronize(device)
        logger.note_time(time.perf_counter() - t0)
    return state, rows


def masked_iou_mean(pred, y, mask, chunk: int = 128):
    """Mean voxelized 3D IoU over the masked rows, ``chunk`` atoms at a time
    (a 64^3 grid per atom)."""
    p, t = pred[mask], y[mask]
    if p.shape[0] == 0:
        return torch.zeros((), device=pred.device)
    s = sum(compute_3d_iou(p[i:i + chunk], t[i:i + chunk]).sum()
            for i in range(0, p.shape[0], chunk))
    return s / p.shape[0]


def eval_epoch(state: TrainState, batches: Iterable[CrystalBatch], eval_step,
               device="cuda", iou: bool = False, logger=None) -> List[tuple]:
    """Eval pass -> (stats, weight) per batch; ``iou`` adds the test-time
    3D IoU stat (ADP targets). ``logger`` gets each batch with its masked
    true/pred values, copied to the host after every batch is queued."""
    t0 = time.perf_counter()
    rows, pending = [], []
    for batch in batches:
        b = batch.to(device)
        pred, mask, stats = eval_step(state, b)
        if iou:
            stats = {**stats, "iou": masked_iou_mean(pred.float(), b.y, mask)}
        rows.append((stats, target_weight(batch)))
        if logger is not None:
            pending.append((pred, mask, b.y, real_edges(batch)))
    if logger is not None:
        for (stats, w), (pred, mask, y, edges) in zip(rows, pending):
            logger.update(stats, weight=w, true=y[mask].float().cpu().numpy(),
                          pred=pred[mask].float().cpu().numpy(), edges=edges)
        logger.note_time(time.perf_counter() - t0)
    return rows


def epoch_means(rows: List[tuple]) -> Dict[str, float]:
    """Weighted means of the per-batch stats (one device sync)."""
    if not rows:
        return {}
    total = sum(float(w) for _, w in rows)
    keys = rows[0][0].keys()
    sums = {k: sum(s[k].float() * float(w) for s, w in rows) for k in keys}
    return {k: float(v) / max(total, 1e-12) for k, v in sums.items()}


def build_optimizer(cfg: Config, params, steps_per_epoch: int):
    total = reference_total_steps(cfg.optim.max_epoch, steps_per_epoch,
                                  cfg.optim.batch_accumulation)
    o = cfg.optim
    return make_optimizer(params, o.lr, total, o.warmup, o.div_factor,
                          o.final_div_factor, o.cycle_momentum,
                          o.base_momentum, o.max_momentum, o.grad_clip)


def build_lr_fn(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    total = reference_total_steps(cfg.optim.max_epoch, steps_per_epoch,
                                  cfg.optim.batch_accumulation)
    return onecycle_lr(cfg.optim.lr, total, cfg.optim.warmup,
                       cfg.optim.div_factor, cfg.optim.final_div_factor)
