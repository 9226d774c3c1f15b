"""Weights into the port: JAX-package pytrees and reference checkpoints.

The port's CartNet modules already use the reference's state_dict key
space, so a reference ``best.ckpt`` (``{"model_state": state_dict, ...}``)
loads as is, and so does a state_dict the port saved (any model).
``params_from_jax`` is the port's own copy of the mapping that
cartnet_tpu/interop.py::export_state_dict applies to the JAX package's
CartNet (params, bn_state) pytrees, taken as nested dicts of numpy arrays;
``ecomformer_params_from_jax`` and ``icomformer_params_from_jax`` do the
same for the two Comformers, whose state_dict names follow the JAX pytree:

  * JAX ``w`` is [in, out]; torch ``nn.Linear.weight`` is [out, in];
  * embeddings are [num, dim] on both sides;
  * BN ``gamma/beta`` -> ``weight/bias``; ``mean/var/count`` ->
    ``running_mean/running_var/num_batches_tracked``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from cartnet_tpu_torch.config import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))  # a writable copy


def _lin(prefix: str, p: Dict[str, Any], sd: Dict[str, torch.Tensor]):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _bn(prefix: str, p, s, sd: Dict[str, torch.Tensor]):
    sd[f"{prefix}.weight"] = _t(p["gamma"])
    sd[f"{prefix}.bias"] = _t(p["beta"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = _t(np.asarray(s["count"],
                                                        np.int64))


def params_from_jax(params_np, bn_state_np,
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX-package (params, bn_state) as numpy dicts -> the port's
    state_dict (CPU tensors; ``load_state_dict`` moves them)."""
    if cfg.name != "cartnet":
        raise ValueError(f"only CartNet is ported, got {cfg.name!r}")
    sd: Dict[str, torch.Tensor] = {}
    enc = params_np["encoder"]
    if "embedding" in enc:
        sd["encoder.embedding.weight"] = _t(enc["embedding"]["w"])
    if "temp_proj" in enc:
        _lin("encoder.temperature_proj_atom", enc["temp_proj"], sd)
    if "bias" in enc:
        sd["encoder.bias"] = _t(enc["bias"])
    if "atom_mlp" in enc:
        # reference Sequential(SiLU, Linear, SiLU): the Linear is index 1
        _lin("encoder.encoder_atom.1", enc["atom_mlp"], sd)
    _lin("encoder.encoder_edge.0", enc["edge_mlp"]["lin0"], sd)
    _lin("encoder.encoder_edge.2", enc["edge_mlp"]["lin1"], sd)
    sd["encoder.rbf.means"] = _t(enc["rbf_means"])
    sd["encoder.rbf.betas"] = _t(enc["rbf_betas"])
    for i in range(cfg.num_layers):
        lp, ls = params_np[f"layer{i}"], bn_state_np[f"layer{i}"]
        for ours, theirs in (("mlp_gate", "MLP_gate"),
                             ("mlp_aggr", "MLP_aggr")):
            _lin(f"layers.{i}.{theirs}.0", lp[ours]["lin0"], sd)
            _lin(f"layers.{i}.{theirs}.2", lp[ours]["lin1"], sd)
        for ours, theirs in (("bn", "norm"), ("bn2", "norm2")):
            _bn(f"layers.{i}.{theirs}", lp[ours], ls[ours], sd)
    _lin("head.MLP.0", params_np["head"]["mlp"]["lin0"], sd)
    _lin("head.MLP.2", params_np["head"]["mlp"]["lin1"], sd)
    return sd


def ecomformer_params_from_jax(params_np, bn_state_np,
                               cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ecomformer_init`` (params, bn_state) as numpy
    dicts -> the port's EComformer state_dict (CPU tensors). The JAX
    package exports no Comformer checkpoint, so this is the only way in
    for Comformer weights. A gradient pytree (``grad_accum``) has the
    params' structure and maps the same way: gradients land under the
    parameters' names, ``bn_state_np`` under the BN buffers'."""
    if cfg.name != "ecomformer":
        raise ValueError(f"expected an eComformer config, got {cfg.name!r}")
    p, s = params_np, bn_state_np
    sd = _comformer_common(p, s, 3)
    ep = p["equi"]
    for name in ("node_linear", "skip_linear", "node_linear_2"):
        _lin(f"equi.{name}", ep[name], sd)
    for tp in ("tp1", "tp2"):
        for lin in ("lin0", "lin1"):
            _lin(f"equi.{tp}.{lin}", ep[tp]["fc"][lin], sd)
    _bn("equi.bn", ep["bn"], s["equi"]["bn"], sd)
    return sd


def icomformer_params_from_jax(params_np, bn_state_np,
                               cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's ``icomformer_init`` (params, bn_state) as numpy
    dicts, or a gradient pytree of the same structure -> the port's
    IComformer state_dict (CPU tensors), as ``ecomformer_params_from_jax``:
    four convs, the edge update (``edge_update.*``, whose ``lin_edge`` has
    no bias), the angle head ``rbf_angle.lin`` and its ``rbfa_*``."""
    if cfg.name != "icomformer":
        raise ValueError(f"expected an iComformer config, got {cfg.name!r}")
    p, s = params_np, bn_state_np
    sd = _comformer_common(p, s, 4)
    sd["rbfa_centers"] = _t(p["rbfa_centers"])
    sd["rbfa_gamma"] = _t(np.asarray(p["rbfa_gamma"]).reshape(()))
    _lin("rbf_angle.lin", p["rbf_angle"]["lin"], sd)
    _conv("edge_update", p["edge_update"], s["edge_update"], sd,
          ("key_e1", "key_e2", "key_e3", "value_e1", "value_e2",
           "value_e3"))
    return sd


def _conv(prefix: str, cp, cs, sd: Dict[str, torch.Tensor], extra=()):
    for name in ("lin_key", "lin_query", "lin_value", "lin_edge",
                 "lin_concate") + extra:
        _lin(f"{prefix}.{name}", cp[name], sd)
    for mlp in ("key_update", "msg_update"):
        _lin(f"{prefix}.{mlp}.0", cp[mlp]["lin0"], sd)
        _lin(f"{prefix}.{mlp}.2", cp[mlp]["lin1"], sd)
    for bn in ("bn", "bn_att"):
        _bn(f"{prefix}.{bn}", cp[bn], cs[bn], sd)


def _comformer_common(p, s, n_conv: int) -> Dict[str, torch.Tensor]:
    """What both Comformers hold: the embedding, the temperature
    projection, the RBF head and its centers, the convs and the head."""
    sd: Dict[str, torch.Tensor] = {
        "embedding.weight": _t(p["embedding"]["w"]),
        "rbf_centers": _t(p["rbf_centers"]),
        "rbf_gamma": _t(np.asarray(p["rbf_gamma"]).reshape(())),
    }
    _lin("temp_proj", p["temp_proj"], sd)
    _lin("rbf.lin", p["rbf"]["lin"], sd)
    for i in range(n_conv):
        _conv(f"conv{i}", p[f"conv{i}"], s[f"conv{i}"], sd)
    _lin("head.MLP.0", p["head"]["mlp"]["lin0"], sd)
    _lin("head.MLP.2", p["head"]["mlp"]["lin1"], sd)
    return sd


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a reference ``best.ckpt`` (or a bare state_dict
    ``.pt``), on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj.get("model_state", obj) if isinstance(obj, dict) else obj
