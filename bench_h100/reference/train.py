"""The reference's first optimizer updates of a training job: plain
forward and backward of each micro-batch, gradients summed over the
accumulation, Adam under the OneCycle schedules."""

from __future__ import annotations

from typing import Optional

import torch

from bench_h100.reference.common import (Adam, graphs, mae_mse, onecycle,
                                         total_steps, training_batches)


def schedule(optim: dict, epoch_micro_steps: int):
    total = total_steps(optim["max_epoch"], epoch_micro_steps,
                        optim["batch_accumulation"])
    return onecycle(optim["lr"], total, optim["warmup"],
                    optim["div_factor"], optim["final_div_factor"],
                    optim["base_momentum"], optim["max_momentum"])


def train_updates(model: torch.nn.Module, records, *, seed: int, batch: int,
                  optim: dict, epoch_micro_steps: int, updates: int,
                  augment: bool, device,
                  keep_graphs: Optional[int] = None) -> dict:
    """``updates`` optimizer updates of ``model`` (in place) from the first
    micro-batches of a job seeded ``seed`` whose OneCycle schedule spans
    ``optim["max_epoch"]`` epochs of ``epoch_micro_steps`` -> {"stats": per micro-step
    loss and MSE, "grad1": the first update's summed gradient by name,
    "bn1": ``bn_state`` once its micro-steps are in}; the batches take the
    model's dtype.
    ``keep_graphs``: only that many crystals of each batch enter the loss
    (the half-batch fault)."""
    accum = optim["batch_accumulation"]
    sched = schedule(optim, epoch_micro_steps)
    batches = training_batches(records, seed, batch, updates * accum,
                               augment)
    params = dict(model.named_parameters())
    dtype = next(iter(params.values())).dtype
    adam = Adam(params, sched)
    model.train()
    stats, grad1 = [], None
    for u in range(updates):
        acc = {k: torch.zeros_like(p) for k, p in params.items()}
        for recs in batches[u * accum:(u + 1) * accum]:
            g = graphs(recs, device, dtype)
            if keep_graphs is not None:
                g.non_h = g.non_h & (g.graph < keep_graphs)
            mae, mse = mae_mse(model(g), g)
            loss = mae if optim["loss"] == "MAE" else mse
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            for (k, a), gr in zip(acc.items(), grads):
                if gr is not None:
                    a.add_(gr)
            stats.append({"loss": float(loss.detach()),
                          "MSE": float(mse.detach())})
        if u == 0:
            grad1 = {k: a.clone() for k, a in acc.items()}
            bn1 = bn_state(model)
        adam.step(acc)
    return {"stats": stats, "grad1": grad1, "bn1": bn1}


def bn_state(model: torch.nn.Module) -> tuple:
    """({name: running mean or var}, [update counts]) of every BatchNorm."""
    stats, counts = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            stats[f"{name}.running_mean"] = m.running_mean.detach().clone()
            stats[f"{name}.running_var"] = m.running_var.detach().clone()
            counts.append(int(m.num_batches_tracked))
    return stats, counts
