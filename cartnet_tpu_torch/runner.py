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
activities) into ``cfg.run_dir/profile``. wandb, meshes, chunks and fused
epochs are not ported.

``inference`` runs the eval forward batch by batch and writes one entry per
structure: pred/true of its non-H atoms, cell, temperature, positions, atom
types, its index as ``refcode``, and its MAE, per-atom 3D IoU and per-atom
S12. ``montecarlo`` repeats the sweep under random rotations of the edge
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
from typing import Iterable

import numpy as np
import torch

from cartnet_tpu_torch.config import Config, resolve_device
from cartnet_tpu_torch.data.pipeline import (BatchPipeline,
                                             choose_pad_sizes_from_counts,
                                             edge_align_for, record_counts)
from cartnet_tpu_torch.data.schema import CrystalBatch
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.ops.rotations import random_rotation
from cartnet_tpu_torch.train import checkpoint as ckpt
from cartnet_tpu_torch.train.guard import GuardMonitor, Heartbeat
from cartnet_tpu_torch.train.logger import create_loggers
from cartnet_tpu_torch.train.loop import (build_lr_fn, build_optimizer,
                                          eval_epoch, init_train_state,
                                          make_steps, train_epoch)
from cartnet_tpu_torch.train.metrics import (compute_3d_iou,
                                             get_similarity_index)


def pipelines(cfg: Config, splits):
    """(train, val, test) pipelines with one pad shape for all three
    splits (with ``cfg.data.buckets`` > 1, one a bucket of each split);
    train shuffles (seeded) and, with ``cfg.data.augment``, rotates
    (targets too on Cholesky heads); val/test do neither."""
    counts = [record_counts(s) for s in splits]
    nodes = np.concatenate([c[0] for c in counts])
    edges = np.concatenate([c[1] for c in counts])
    align = edge_align_for(edges)
    mn, me = choose_pad_sizes_from_counts(nodes, edges, cfg.data.batch_size,
                                          edge_align=align)
    return tuple(BatchPipeline(recs, cfg.data.batch_size, mn, me,
                               shuffle=train, augment=train and
                               cfg.data.augment,
                               rotate_targets=cfg.model.cholesky,
                               seed=cfg.seed, buckets=cfg.data.buckets,
                               edge_align=align)
                 for recs, train in zip(splits, (True, False, False)))


def run(cfg: Config, splits, device="cuda", state_dict=None,
        resume: bool = False, profile: bool = False):
    """Build pipelines, model (random from ``cfg.seed``, or ``state_dict``)
    and optimizer, then ``train``."""
    device = resolve_device(device)
    pipes = pipelines(cfg, splits)
    model = create_model(cfg.model, device, cfg.seed)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    logging.info("model %s: %.3fM params", cfg.model.name, n_params / 1e6)
    optimizer = build_optimizer(cfg, model.parameters(), len(pipes[0]))
    return train(cfg, init_train_state(model, optimizer, cfg.seed), pipes,
                 device, resume, profile)


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
          profile: bool = False):
    """Epoch loop -> (state with the best weights, test stats)."""
    device = resolve_device(device)
    train_pipe, val_pipe, test_pipe = pipes
    loggers = create_loggers(cfg.run_dir, device)
    n_params = sum(p.numel() for p in state.model.parameters())
    for lg in loggers:
        lg.params = n_params
    best_path, last_path = checkpoint_paths(cfg.run_dir)
    start_epoch, best = 0, (float("inf"), -1)
    if resume and ckpt.latest_step(last_path) is not None:
        state, meta = ckpt.restore_checkpoint(last_path, state)
        start_epoch = meta["epoch"] + 1
        best = (meta["best_val"], meta["best_epoch"])
        train_pipe.rng.bit_generator.state = meta["pipeline_rng"]
        logging.info("resumed at epoch %d (best %.5f @ %d)", start_epoch,
                     *best)
    hb = Heartbeat(cfg.guard.heartbeat_path, cfg.guard.heartbeat_interval)
    hb.start()
    hb.beat(status="startup", epoch=start_epoch, name=cfg.name)
    try:
        state, best = _epochs(cfg, state, pipes, device, loggers, hb,
                              start_epoch, best, profile)
        if os.path.isfile(best_path):
            state, _ = ckpt.restore_checkpoint(best_path, state)
        eval_epoch(state, test_pipe, make_steps(cfg)[2], device,
                   iou=cfg.model.cholesky, logger=loggers[2])
        test_stats = loggers[2].write_epoch(best[1])
    except BaseException:
        hb.stop(status="failed")
        raise
    hb.stop()
    return state, test_stats


def _epochs(cfg: Config, state, pipes, device, loggers, hb, epoch: int,
            best: tuple, profile: bool):
    """Epochs ``epoch`` .. max_epoch - 1, with the guard's rollbacks ->
    (state, (best val MAE, its epoch))."""
    train_pipe, val_pipe, _ = pipes
    micro, update, evals = make_steps(cfg)
    lr_fn = build_lr_fn(cfg, len(train_pipe))
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
        with (_profiled(cfg.run_dir, device) if profile and epoch == first
              else contextlib.nullcontext()):
            state, _ = train_epoch(state, train_pipe, micro, update,
                                   cfg.optim.batch_accumulation, device,
                                   loggers[0], lr_fn)
        loggers[0].write_epoch(epoch)
        eval_epoch(state, val_pipe, evals, device, logger=loggers[1])
        val_mae = loggers[1].write_epoch(epoch)["MAE"]
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
            ckpt.save_checkpoint(best_path, state)
            logging.info("best checkpoint saved (epoch %d, val MAE %.5f)",
                         epoch, val_mae)
        ckpt.save_checkpoint(last_path, state, {
            "epoch": epoch, "best_val": best[0], "best_epoch": best[1],
            "pipeline_rng": train_pipe.rng.bit_generator.state})
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


def _add_rows(out: dict, batch: CrystalBatch, pred, mask, device) -> None:
    """Appends one entry per structure of a host batch to ``out`` (its
    keys pick the fields; ``temp`` only where ``out`` has it), with the
    per-structure MAE and the per-atom IoU and S12 computed on
    ``device``."""
    for row in _per_structure_rows(batch, pred, mask):
        p, t = row["pred"], row["true"]
        for k in ("pred", "true", "cell", "temp", "pos", "atoms"):
            if k in out:
                out[k].append(row[k])
        out["refcode"].append(len(out["refcode"]))
        out["mae"].append(float(np.abs(p - t).mean()))
        pt = torch.as_tensor(p, device=device)
        tt = torch.as_tensor(t, device=device)
        out["iou"].append(compute_3d_iou(pt, tt).cpu().numpy())
        out["similarity_index"].append(
            get_similarity_index(pt, tt).cpu().numpy())


def inference(model, batches: Iterable[CrystalBatch], output_path: str,
              device="cuda"):
    """Per-structure test sweep with ADP metrics on ``device`` (the card
    unless the caller passes ``device="cpu"``).

    ``batches`` are host (numpy) batches; each is moved to the device, run
    through ``model`` (pred [N, 3, 3]) and split per structure. Returns the
    dict that is pickled to ``output_path``."""
    if not model.cfg.cholesky:
        raise ValueError("the inference sweep needs the Cholesky ADP head")
    device = resolve_device(device)
    model = model.to(device)
    out = {"pred": [], "true": [], "temp": [], "cell": [], "refcode": [],
           "pos": [], "atoms": [], "iou": [], "mae": [],
           "similarity_index": []}
    for batch in batches:
        with torch.inference_mode():
            pred, mask = model(batch.to(device))
        _add_rows(out, batch, pred.float().cpu().numpy(),
                  mask.cpu().numpy(), device)
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
