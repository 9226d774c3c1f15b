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
pipeline on resume instead). wandb, the heartbeat and rollback guard,
meshes, chunks, fused epochs and the profiler are not ported yet.

``inference`` runs the eval forward batch by batch and writes one entry per
structure: pred/true of its non-H atoms, cell, temperature, positions, atom
types, its index as ``refcode``, and its MAE, per-atom 3D IoU and per-atom
S12. ``montecarlo`` repeats the sweep under random rotations of the edge
directions, against the unrotated prediction rotated as Rᵀ U R. The pickle
layouts and the log lines are the reference's.
"""

from __future__ import annotations

import dataclasses
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
from cartnet_tpu_torch.train.logger import create_loggers
from cartnet_tpu_torch.train.loop import (build_lr_fn, build_optimizer,
                                          eval_epoch, init_train_state,
                                          make_steps, train_epoch)
from cartnet_tpu_torch.train.metrics import (compute_3d_iou,
                                             get_similarity_index)


def pipelines(cfg: Config, splits):
    """(train, val, test) pipelines with one pad shape for all three
    splits; train shuffles (seeded) and, with ``cfg.data.augment``,
    rotates (targets too on Cholesky heads); val/test do neither."""
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
                               seed=cfg.seed, edge_align=align)
                 for recs, train in zip(splits, (True, False, False)))


def run(cfg: Config, splits, device="cuda", state_dict=None,
        resume: bool = False):
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
                 device, resume)


def checkpoint_paths(run_dir: str):
    """(best, last) checkpoint files of a run."""
    d = os.path.join(run_dir, "ckpt")
    return os.path.join(d, "best.ckpt"), os.path.join(d, "last.ckpt")


def train(cfg: Config, state, pipes, device="cuda", resume: bool = False):
    """Epoch loop -> (state with the best weights, test stats)."""
    device = resolve_device(device)
    train_pipe, val_pipe, test_pipe = pipes
    micro, update, evals = make_steps(cfg)
    lr_fn = build_lr_fn(cfg, len(train_pipe))
    loggers = create_loggers(cfg.run_dir, device)
    n_params = sum(p.numel() for p in state.model.parameters())
    for lg in loggers:
        lg.params = n_params
    best_path, last_path = checkpoint_paths(cfg.run_dir)
    start_epoch, best_val, best_epoch = 0, float("inf"), -1
    if resume and ckpt.latest_step(last_path) is not None:
        state, meta = ckpt.restore_checkpoint(last_path, state)
        start_epoch = meta["epoch"] + 1
        best_val, best_epoch = meta["best_val"], meta["best_epoch"]
        train_pipe.rng.bit_generator.state = meta["pipeline_rng"]
        logging.info("resumed at epoch %d (best %.5f @ %d)", start_epoch,
                     best_val, best_epoch)
    epoch_times = []
    for epoch in range(start_epoch, cfg.optim.max_epoch):
        t0 = time.perf_counter()
        state, _ = train_epoch(state, train_pipe, micro, update,
                               cfg.optim.batch_accumulation, device,
                               loggers[0], lr_fn)
        loggers[0].write_epoch(epoch)
        eval_epoch(state, val_pipe, evals, device, logger=loggers[1])
        val_mae = loggers[1].write_epoch(epoch)["MAE"]
        epoch_times.append(time.perf_counter() - t0)
        if val_mae < best_val:
            best_val, best_epoch = val_mae, epoch
            ckpt.save_checkpoint(best_path, state)
            logging.info("best checkpoint saved (epoch %d, val MAE %.5f)",
                         epoch, val_mae)
        ckpt.save_checkpoint(last_path, state, {
            "epoch": epoch, "best_val": best_val, "best_epoch": best_epoch,
            "pipeline_rng": train_pipe.rng.bit_generator.state})
        logging.info("> Epoch %d: %.1fs (avg %.1fs) | best epoch %d val_MAE "
                     "%.5f | optimizer steps %d, bad steps %d", epoch,
                     epoch_times[-1], np.mean(epoch_times), best_epoch,
                     best_val, state.step, int(state.bad_steps))
    if os.path.isfile(best_path):
        state, _ = ckpt.restore_checkpoint(best_path, state)
    eval_epoch(state, test_pipe, evals, device, iou=cfg.model.cholesky,
               logger=loggers[2])
    return state, loggers[2].write_epoch(best_epoch)


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
