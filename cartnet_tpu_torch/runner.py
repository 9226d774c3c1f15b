"""Run orchestration: training and the ADP inference sweep (port of
cartnet_tpu/runner.py::run, ::train and ::inference). The sweep and the
training serve any ported model (CartNet, eComformer, iComformer).

``train`` runs the epochs: a train epoch, a val pass, best-epoch tracking by
val MAE with the best weights kept in memory, then the final test pass with
the best weights and the 3D IoU stat. Checkpoints and resume, the per-epoch
stats files, wandb, the heartbeat and meshes are not ported yet.

``inference`` runs the eval forward batch by batch and writes one entry per
structure: pred/true of its non-H atoms, cell, temperature, positions, atom
types, its index as ``refcode``, and its MAE, per-atom 3D IoU and per-atom
S12. The pickle layout and the closing log lines are the reference's.
"""

from __future__ import annotations

import logging
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
from cartnet_tpu_torch.train.loop import (build_lr_fn, build_optimizer,
                                          epoch_means, eval_epoch,
                                          init_train_state, make_steps,
                                          train_epoch)
from cartnet_tpu_torch.train.metrics import (compute_3d_iou,
                                             get_similarity_index)


def pipelines(cfg: Config, splits):
    """(train, val, test) pipelines with one pad shape for all three
    splits; train shuffles (seeded), val/test do not."""
    counts = [record_counts(s) for s in splits]
    nodes = np.concatenate([c[0] for c in counts])
    edges = np.concatenate([c[1] for c in counts])
    align = edge_align_for(edges)
    mn, me = choose_pad_sizes_from_counts(nodes, edges, cfg.data.batch_size,
                                          edge_align=align)
    return tuple(BatchPipeline(recs, cfg.data.batch_size, mn, me,
                               shuffle=shuffle, seed=cfg.seed,
                               edge_align=align)
                 for recs, shuffle in zip(splits, (True, False, False)))


def run(cfg: Config, splits, device="cuda", state_dict=None):
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
                 device)


def train(cfg: Config, state, pipes, device="cuda"):
    """Epoch loop -> (state with the best weights, test stats)."""
    device = resolve_device(device)
    train_pipe, val_pipe, test_pipe = pipes
    micro, update, evals = make_steps(cfg)
    lr_fn = build_lr_fn(cfg, len(train_pipe))
    best_val, best_epoch, best_sd = float("inf"), -1, None
    for epoch in range(cfg.optim.max_epoch):
        t0 = time.perf_counter()
        state, rows = train_epoch(state, train_pipe, micro, update,
                                  cfg.optim.batch_accumulation, device)
        tr = epoch_means(rows)
        val = epoch_means(eval_epoch(state, val_pipe, evals, device))
        logging.info("epoch %d train: %s", epoch, tr)
        logging.info("epoch %d val: %s", epoch, val)
        if val["MAE"] < best_val:
            best_val, best_epoch = val["MAE"], epoch
            best_sd = {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()}
        logging.info("> Epoch %d: %.1fs | best epoch %d val_MAE %.5f | "
                     "optimizer steps %d (lr %.3g), bad steps %d", epoch,
                     time.perf_counter() - t0, best_epoch, best_val,
                     state.step, lr_fn(state.step), int(state.bad_steps))
    if best_sd is not None:
        state.model.load_state_dict(best_sd)
    test = epoch_means(eval_epoch(state, test_pipe, evals, device,
                                  iou=cfg.model.cholesky))
    logging.info("test (best epoch %d): %s", best_epoch, test)
    return state, test


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
    idx = 0
    for batch in batches:
        with torch.inference_mode():
            pred, mask = model(batch.to(device))
        pred = pred.float().cpu().numpy()
        for row in _per_structure_rows(batch, pred, mask.cpu().numpy()):
            p, t = row["pred"], row["true"]
            out["pred"].append(p)
            out["true"].append(t)
            out["cell"].append(row["cell"])
            out["temp"].append(row["temp"])
            out["pos"].append(row["pos"])
            out["atoms"].append(row["atoms"])
            out["refcode"].append(idx)
            out["mae"].append(float(np.abs(p - t).mean()))
            pt = torch.as_tensor(p, device=device)
            tt = torch.as_tensor(t, device=device)
            out["iou"].append(compute_3d_iou(pt, tt).cpu().numpy())
            out["similarity_index"].append(
                get_similarity_index(pt, tt).cpu().numpy())
            idx += 1
    for k in ("iou", "similarity_index"):
        v = np.concatenate(out[k]) if out[k] else np.zeros(0)
        logging.info("Mean %s: %s +/- %s", k, v.mean(), v.std())
    mae = np.asarray(out["mae"])
    logging.info("Mean mae: %s +/- %s", mae.mean(), mae.std())
    with open(output_path, "wb") as f:
        pickle.dump(out, f)
    return out
