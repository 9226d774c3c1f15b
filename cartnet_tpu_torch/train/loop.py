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
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from cartnet_tpu_torch.config import Config
from cartnet_tpu_torch.data.schema import CrystalBatch
from cartnet_tpu_torch.train.guard import guard_contribution
from cartnet_tpu_torch.train.metrics import (adp_stat_sums, compute_3d_iou,
                                             masked_mae_mse)
from cartnet_tpu_torch.train.schedule import (make_optimizer, onecycle_lr,
                                              reference_total_steps)
from cartnet_tpu_torch.train.state import TrainState

Stats = Dict[str, torch.Tensor]


def loss_fn(model, batch: CrystalBatch, cfg: Config):
    """Forward in the model's current mode -> (loss, (mae, mse, pred, mask))."""
    pred, mask = model(batch)
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
               old_bn) -> None:
    """The micro-step's tail: with the guard on, a non-finite step adds
    nothing and puts back the BN buffers ``bufs`` had (``old_bn``); the
    gradients are summed into the accumulator and the counters advance."""
    ok = torch.ones((), dtype=torch.bool, device=loss.device)
    if cfg.guard.enabled:
        ok, grads, bn = guard_contribution(loss.detach(), grads, bufs,
                                           old_bn)
        with torch.no_grad():
            for b, v in zip(bufs, bn):
                b.copy_(v)
    with torch.no_grad():
        for a, g in zip(state.grad_accum, grads):
            a.add_(g)
    state.accum_count += ok.int()
    state.bad_steps += (~ok).int()


def make_steps(cfg: Config):
    """-> (micro_step, update_step, eval_step); batches are on the device."""

    def micro_step(state: TrainState, batch: CrystalBatch):
        model = state.model
        model.train()
        bufs = bn_buffers(model)
        old_bn = [b.clone() for b in bufs] if cfg.guard.enabled else None
        loss, (mae, mse, pred, mask) = loss_fn(model, batch, cfg)
        grads = param_grads(loss, state.optimizer.params)
        accumulate(state, cfg, loss, grads, bufs, old_bn)
        stats = _stats_with_adp(cfg, {"loss": loss.detach(),
                                      "MAE": mae.detach(),
                                      "MSE": mse.detach()},
                                pred, batch.y, mask)
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
            loss, (mae, mse, pred, mask) = loss_fn(model, batch, cfg)
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
