"""Model factory: name -> model (port of cartnet_tpu/models/factory.py).

``create_model(cfg, device, seed)`` builds the ported model named by
``cfg.name`` (case-insensitive) with random weights from ``seed``.
"""

from __future__ import annotations

import dataclasses

from cartnet_tpu_torch.config import ModelConfig
from cartnet_tpu_torch.models.cartnet import CartNet
from cartnet_tpu_torch.models.comformer import EComformer, IComformer

_REGISTRY = {"cartnet": CartNet, "ecomformer": EComformer,
             "icomformer": IComformer}


def create_model(cfg: ModelConfig, device="cuda", seed: int = 0):
    name = cfg.name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"model {cfg.name!r} not implemented; available: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](dataclasses.replace(cfg, name=name), device=device,
                           seed=seed)
