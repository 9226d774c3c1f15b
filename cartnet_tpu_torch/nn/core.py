"""Linear layers, MLPs and embeddings (port of cartnet_tpu/nn/core.py).

Weights keep torch's nn.Linear layout [out, in]. Initializers follow PyTorch's
defaults with an explicit ``torch.Generator``: U(+-1/sqrt(fan_in)) for Linear
weight and bias, xavier-uniform for the atom embedding.

Mixed dtypes promote like the JAX package: an f32 activation times a bf16
weight is an f32 product; the bias is added after the product (no fused
addmm), so bf16 results round where the reference's do.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def torch_linear_init_(lin: torch.nn.Linear, generator: torch.Generator):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, in place."""
    bound = 1.0 / math.sqrt(lin.in_features)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        if lin.bias is not None:
            lin.bias.uniform_(-bound, bound, generator=generator)


def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator):
    """Xavier-uniform over a [num, dim] table (fan_in = num, fan_out = dim,
    the reference embedding's convention), in place."""
    bound = math.sqrt(6.0 / (weight.shape[0] + weight.shape[1]))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T (+ b) for a torch-layout weight w [out, in]."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(dt), w.to(dt).t())
    if b is not None:
        y = y + b
    return y


def mlp_silu(x: torch.Tensor,
             layers: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
             final_act: bool = False) -> torch.Tensor:
    """Linear -> SiLU -> ... -> Linear [-> SiLU] over (w, b) pairs."""
    for i, (w, b) in enumerate(layers):
        x = linear(x, w, b)
        if i < len(layers) - 1 or final_act:
            x = F.silu(x)
    return x


def embedding(weight: torch.Tensor, idx: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """Row lookup weight[idx] in ``dtype``: the exact row copies that the
    reference's one-hot embedding and per-graph gathers produce
    (``embedding_onehot`` and ``gather_rows_onehot`` there)."""
    return weight.to(dtype).index_select(0, idx)


def cast_params(module: torch.nn.Module, compute_dtype: torch.dtype,
                param_dtype: torch.dtype,
                skip: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Every parameter of ``module`` by name (but those under a prefix in
    ``skip``), the ones in ``param_dtype`` cast to ``compute_dtype``: the
    reference's cast of the whole params pytree once at the top of a model
    apply. Buffers (BN running stats) are not parameters and are not
    cast."""
    return {name: p.to(compute_dtype) if p.dtype == param_dtype else p
            for name, p in module.named_parameters()
            if not name.startswith(skip)}


class Params:
    """A view of a ``cast_params`` table under a submodule's name prefix:
    ``p["lin.weight"]`` is ``table[prefix + "lin.weight"]``."""

    def __init__(self, table: Dict[str, torch.Tensor], prefix: str = ""):
        self.table, self.prefix = table, prefix

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.table[self.prefix + name]

    def sub(self, name: str) -> "Params":
        return Params(self.table, f"{self.prefix}{name}.")
