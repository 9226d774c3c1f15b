"""Data- and edge-parallel training steps over ``torch.distributed``
groups (port of cartnet_tpu/parallel/step.py's ``make_parallel_steps`` and
``make_parallel_fused_chunk``).

Each rank holds the whole model and its share of the batch: member
``r // ep`` of each group of dp consecutive batches, and within that dp
slice ep member ``r % ep``'s edge slice (or, under halo partitioning, its
node and edge block), with the loss mask partitioned over the ep members
(``runner.ShardedPipeline``, parallel/partition.py). The model reduces over
the rank's ``dist.Groups``: the partial aggregates over its ep group (or
the halo exchanges), edge BN moments over the world, node BN moments over
the ranks with its ep index (under halo, the world). A micro-step on every
rank:

  * the train forward with sync BN: every rank normalizes with the union
    batch's moments and advances the same running stats;
  * the masked loss sums and count (and, on Cholesky heads, the ADP stat
    sums) summed over the world in one all-reduce: the loss is the global
    sum over the global count, its value the same on every rank, its
    gradient flowing through this rank's own sums only;
  * the backward (the BNs' and the aggregates' all-reduces sum their
    cotangents over their groups), then one all-reduce (sum) of the
    flattened gradients over the world: every rank holds the gradient of
    the union batch, with no factor of the group's size (the JAX package's
    loss is likewise global);
  * the step guard on the global loss and the summed gradients, so its
    decision, and the accumulation count, agree on every rank.

The update is the single-process one: every rank applies the same
gradients to the same weights. The eval step runs the eval forward with
the groups (the aggregates' sums and the halo exchanges; eval BN reads the
running stats, which agree) and returns each rank's own partition's
stats, which the loggers sum over the world. The fused chunk
(``--fused_steps``) runs the same forward inside the single-process chunk;
a micro-step is valid where any rank's batch holds a real graph; on the
card its collectives are captured in the chunk's CUDA graph, which needs
NCCL (train/graphs.py). Chunked execution (``--chunks``) is a
single-device mode and runs the single-process steps (parallel/chunk.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cartnet_tpu_torch.config import Config
from cartnet_tpu_torch.data.schema import CrystalBatch
from cartnet_tpu_torch.parallel.dist import Groups
from cartnet_tpu_torch.train.loop import (make_fused_chunk, make_steps,
                                          param_grads)
from cartnet_tpu_torch.train.metrics import adp_stat_sums, masked_sums
from cartnet_tpu_torch.train.state import TrainState


def all_reduce_flat(tensors, group) -> None:
    """Sums same-dtype ``tensors`` over the ranks of ``group`` in place,
    in one all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def as_groups(group) -> Groups:
    """``group`` as the models' ``Groups``: a plain process group is data
    parallelism alone."""
    return group if isinstance(group, Groups) else \
        Groups.data_parallel(group)


def parallel_forward(cfg: Config, groups: Groups):
    """The micro-step's forward and backward over ``groups`` (a forward
    for ``loop.make_steps``) -> (loss, stats, summed gradients, live: a
    device bool, some rank's batch holds a real graph)."""
    group = groups.edge

    def forward(state: TrainState, batch: CrystalBatch):
        model = state.model
        model.train()
        pred, mask = model(batch, groups)
        sums = list(masked_sums(pred, batch.y, mask))
        if cfg.model.cholesky:
            sums += list(adp_stat_sums(pred.detach(), batch.y, mask))
        # the live flag rides on the loss sums' all-reduce
        tot = torch.stack([s.detach() for s in sums]
                          + [batch.graph_mask.any().float()])
        dist.all_reduce(tot, group=group)
        cnt = torch.clamp(tot[2], min=1.0)
        # the global sums' values, with the gradient of this rank's own
        sa = tot[0] + (sums[0] - sums[0].detach())
        sq = tot[1] + (sums[1] - sums[1].detach())
        mae, mse = sa / cnt, sq / cnt
        loss = mae if cfg.optim.loss == "MAE" else mse
        grads = param_grads(loss, state.optimizer.params)
        all_reduce_flat(grads, group)
        stats = {"loss": loss.detach(), "MAE": mae.detach(),
                 "MSE": mse.detach()}
        if cfg.model.cholesky:
            n = torch.clamp(tot[5], min=1.0)
            stats["volume_percentage_error"] = tot[3] / n
            stats["similarity_index"] = tot[4] / n
        return loss, stats, grads, tot[-1] > 0

    return forward


def make_parallel_steps(cfg: Config, group):
    """-> (micro_step, update_step, eval_step) over ``group`` (a
    ``dist.Groups``, or a process group for data parallelism alone); each
    rank calls them on its own device batch."""
    groups = as_groups(group)
    return make_steps(cfg, parallel_forward(cfg, groups), groups)


def make_parallel_fused_chunk(cfg: Config, group, num_steps: int):
    """The fused chunk (``loop.make_fused_chunk``) over ``group`` (as in
    ``make_parallel_steps``): each rank runs ``num_steps`` micro-steps on
    its own stacked member batches, with the parallel forward; a
    micro-step is valid where any rank's batch holds a real graph (the
    flag crosses the world with the loss sums: a short group's ranks past
    its end, and an ep member whose loss partition is empty, hold no
    graph of their own) and the guard passes the summed gradients, so the
    accumulation cadence agrees on every rank."""
    return make_fused_chunk(cfg, num_steps,
                            parallel_forward(cfg, as_groups(group)))
