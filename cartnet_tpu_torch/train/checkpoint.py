"""Checkpoints as ``torch.save`` files (port of cartnet_tpu/train/checkpoint.py).

A run keeps two files under ``<run_dir>/ckpt/``:

  * ``best.ckpt``, written when the val MAE improves, in the reference
    layout ``{"model_state": state_dict, "optimizer_state": Adam's
    state_dict}`` that ``interop.load_reference_checkpoint`` and the JAX
    package's ``load_torch_checkpoint`` read;
  * ``last.ckpt``, written every epoch, which adds everything a resumed run
    needs to continue bitwise as an unbroken one: the gradient
    accumulator, the accumulation and bad-step counts, the update count
    (``step``) and the OneCycle count, the torch generator, and ``meta``
    (the epoch, the best val MAE and its epoch, and the train pipeline's
    numpy bit-generator state).

Each file is written to a temporary name beside it and moved into place
with ``os.replace``, so an interrupted write leaves the previous file.
Files load with ``weights_only=True``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from cartnet_tpu_torch.train.state import TrainState


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState,
                    meta: Optional[Dict] = None) -> None:
    """Without ``meta``: the reference layout (model and optimizer).
    With it: the resumable layout, ``state.state_dict()`` plus ``meta``."""
    if meta is None:
        obj = {"model_state": state.model.state_dict(),
               "optimizer_state": state.optimizer.adam.state_dict()}
    else:
        obj = {**state.state_dict(), "meta": meta}
    _atomic_save(obj, path)


def _load(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState
                       ) -> Tuple[TrainState, Dict]:
    """Loads ``path`` into ``state`` in place -> (state, meta). A
    reference-layout file restores the model and Adam's moments; a
    resumable one restores the whole state and returns its meta."""
    obj = _load(path)
    if "meta" not in obj:
        state.model.load_state_dict(obj["model_state"], strict=True)
        state.optimizer.adam.load_state_dict(obj["optimizer_state"])
        return state, {}
    state.load_state_dict(obj)
    return state, obj["meta"]


def latest_step(path: str) -> Optional[int]:
    """The update count a resumable checkpoint holds; None without one."""
    if not os.path.isfile(path):
        return None
    return _load(path).get("step")
