"""The ADP inference sweep (port of cartnet_tpu/runner.py::inference).

Runs the eval forward batch by batch and writes one entry per structure:
pred/true of its non-H atoms, cell, temperature, positions, atom types, its
index as ``refcode``, and its MAE, per-atom 3D IoU and per-atom S12. The
pickle layout and the closing log lines are the reference's.
"""

from __future__ import annotations

import logging
import pickle
from typing import Iterable

import numpy as np
import torch

from cartnet_tpu_torch.config import resolve_device
from cartnet_tpu_torch.data.schema import CrystalBatch
from cartnet_tpu_torch.train.metrics import (compute_3d_iou,
                                             get_similarity_index)


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
