"""eComformer forward, eval and train (port of
cartnet_tpu/models/comformer.py:42-204, 287-347).

``ComformerConv`` is the gated single-head attention conv on the JAX
package's fused branch: the key/msg MLPs over [x_dst | x_src | e] have
CartNet's edge-phase shape, so K1 computes both,

    xi = [k @ Wk_i | v @ Wm_i], xj = [k @ Wk_j | v @ Wm_j], we = [Wk_e | Wm_e]
    (gate, sender) of K1 == (key_j, msg)

and the gated aggregation sum_dst sigmoid(BN(q_dst * key_j / sqrt(d))) * msg
runs through K2 with env = 1 and e_in = 0 (its e_out is unused). Then
lin_concate, the node BN and softplus(x + out).

``EComformer``: atom embedding + the temperature projection gathered per
graph (applied whatever ``use_temperature`` says, as in the JAX package),
the RBF head over -0.75 / dist, conv0, the equivariant block, conv1, conv2,
and the Cholesky (or scalar) head. Parameters are stored in ``param_dtype``
and cast once per forward (``nn.core.cast_params``); BN running stats are
not cast, so with bf16 compute eval BN promotes x to f32 after conv0 while
the edge features stay bf16 (ROADMAP §3 has the whole dtype contract).

In training (``model.train()``) the conv runs the edge phase as the
``EdgePhase`` Function without BN moments (K1 forward, K5 backward), the q
gather through ``gather_sorted`` (K3 backward), two-pass train BN on alpha
into ``SigmaSegsum`` (K2 forward, K4 backward), and train BN on the nodes;
each train forward advances the BN running stats in place. Train BN keeps
x's dtype, so with bf16 compute every kernel sees bf16 operands (ROADMAP §3).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from cartnet_tpu_torch.config import ModelConfig, resolve_device
from cartnet_tpu_torch.data.schema import CrystalBatch
from cartnet_tpu_torch.models.cartnet import CholeskyHead, ScalarHead
from cartnet_tpu_torch.models.equivariant import EquiBlock
from cartnet_tpu_torch.nn.core import (Params, cast_params, embedding, linear,
                                       torch_linear_init_)
from cartnet_tpu_torch.nn.norm import (bn_state_update, masked_batch_norm,
                                       masked_batch_norm_train,
                                       masked_bn_scale_shift,
                                       masked_bn_scale_shift_train)
from cartnet_tpu_torch.ops import rbf as rbf_ops
from cartnet_tpu_torch.ops.kernels.edge_kernels import (EdgePhase,
                                                        edge_phase_fwd)
from cartnet_tpu_torch.ops.kernels.segment_kernels import (SigmaSegsum,
                                                           sigma_segsum)
from cartnet_tpu_torch.ops.segment import gather_sorted


def _lin(p: Params, name: str, x):
    return linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _mlp2(d: int, dt, gen: torch.Generator) -> nn.Sequential:
    """Linear(3d, d) -> SiLU -> Linear(d, d)."""
    seq = nn.Sequential(nn.Linear(3 * d, d, dtype=dt), nn.SiLU(),
                        nn.Linear(d, d, dtype=dt))
    torch_linear_init_(seq[0], gen)
    torch_linear_init_(seq[2], gen)
    return seq


class ComformerConv(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, dt = cfg.dim_in, cfg.param_dtype
        self.cfg = cfg
        for name in ("lin_key", "lin_query", "lin_value", "lin_edge",
                     "lin_concate"):
            lin = nn.Linear(d, d, dtype=dt)
            torch_linear_init_(lin, gen)
            setattr(self, name, lin)
        self.key_update = _mlp2(d, dt, gen)
        self.msg_update = _mlp2(d, dt, gen)
        self.bn = nn.BatchNorm1d(d, eps=cfg.bn_eps, momentum=cfg.bn_momentum,
                                 dtype=dt)
        self.bn_att = nn.BatchNorm1d(d, eps=cfg.bn_eps,
                                     momentum=cfg.bn_momentum, dtype=dt)

    def forward(self, x, edge_attr, batch: CrystalBatch, p: Params):
        """x [N, d], edge_attr [E, d] -> x [N, d]; train mode when
        ``self.training`` (advances bn/bn_att's running stats)."""
        d, eps, mom = x.shape[1], self.cfg.bn_eps, self.cfg.bn_momentum
        k, q, v = (_lin(p, n, x) for n in ("lin_key", "lin_query",
                                            "lin_value"))
        e = _lin(p, "lin_edge", edge_attr)
        wk, wm = p["key_update.0.weight"].t(), p["msg_update.0.weight"].t()
        pdt = torch.promote_types(k.dtype, wk.dtype)
        mm = lambda a, w: torch.matmul(a.to(pdt), w.to(pdt))
        xi = torch.cat([mm(k, wk[:d]), mm(v, wm[:d])], dim=1)
        xj = torch.cat([mm(k, wk[d:2 * d]), mm(v, wm[d:2 * d])], dim=1)
        we = torch.cat([wk[2 * d:], wm[2 * d:]], dim=1).contiguous()
        b = torch.cat([p["key_update.0.bias"], p["msg_update.0.bias"]])
        args = (xi, xj, e, we, b, p["key_update.2.weight"].t().contiguous(),
                p["key_update.2.bias"],
                p["msg_update.2.weight"].t().contiguous(),
                p["msg_update.2.bias"], batch.edge_dst, batch.edge_src,
                batch.edge_mask)
        E = e.shape[0]
        if self.training:
            key_j, msg, _, _, _ = EdgePhase.apply(
                *args, batch.dst_rowptr, batch.edge_src_perm,
                batch.src_rowptr, False)
        else:
            key_j, msg, _, _, _ = edge_phase_fwd(*args)
        q_dst = gather_sorted(q, batch.edge_dst, batch.dst_rowptr,
                              batch.edge_mask)
        alpha = q_dst * key_j / math.sqrt(d)
        if self.training:
            (scale, shift), (mean, var, n) = masked_bn_scale_shift_train(
                alpha, p["bn_att.weight"], p["bn_att.bias"], batch.edge_mask,
                eps)
            bn_state_update(self.bn_att, mean, var, n, mom)
            sigma = SigmaSegsum.apply
        else:
            scale, shift = masked_bn_scale_shift(
                p["bn_att.weight"], p["bn_att.bias"],
                self.bn_att.running_mean, self.bn_att.running_var, eps)
            sigma = sigma_segsum
        # e_in = 0: the conv has no edge residual; e_out is unused
        _, out = sigma(
            alpha, scale.float(), shift.float(),
            torch.ones((E, 1), dtype=alpha.dtype, device=alpha.device), msg,
            torch.zeros_like(msg), batch.edge_dst, batch.edge_mask,
            batch.dst_rowptr, batch.num_nodes)
        out = _lin(p, "lin_concate", out)
        if self.training:
            out, (mean, var, n) = masked_batch_norm_train(
                out, p["bn.weight"], p["bn.bias"], batch.node_mask, eps)
            bn_state_update(self.bn, mean, var, n, mom)
        else:
            out = masked_batch_norm(out, p["bn.weight"], p["bn.bias"],
                                    self.bn.running_mean,
                                    self.bn.running_var, eps)
        return F.softplus(x + out)


class RBFHead(nn.Module):
    """RBFExpansion(bins=d) -> Linear -> softplus; the centers and gamma
    are the model's ``rbf_centers`` / ``rbf_gamma``."""

    def __init__(self, d: int, dt, gen: torch.Generator):
        super().__init__()
        self.lin = nn.Linear(d, d, dtype=dt)
        torch_linear_init_(self.lin, gen)


class EComformer(nn.Module):
    """Embedding -> conv0 -> equivariant block -> conv1 -> conv2 -> head.

    Built on the CPU from ``seed`` with a torch.Generator, then moved to
    ``device`` (the card unless the caller passes ``device="cpu"``), in
    eval mode. ``forward`` -> (pred, pred_mask) as ``CartNet``'s; after
    ``model.train()`` the conv and block layers run their train forward.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if cfg.name != "ecomformer":
            raise ValueError(f"EComformer needs cfg.name 'ecomformer', got "
                             f"{cfg.name!r}")
        d, dt = cfg.dim_in, cfg.param_dtype
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.embedding = nn.Embedding(119, d, dtype=dt)
        with torch.no_grad():
            self.embedding.weight.normal_(generator=gen)
        self.temp_proj = nn.Linear(1, d, dtype=dt)
        torch_linear_init_(self.temp_proj, gen)
        self.rbf = RBFHead(d, dt, gen)
        self.conv0 = ComformerConv(cfg, gen)
        self.conv1 = ComformerConv(cfg, gen)
        self.conv2 = ComformerConv(cfg, gen)
        self.equi = EquiBlock(cfg, gen)
        self.head = (CholeskyHead(cfg, gen) if cfg.cholesky
                     else ScalarHead(cfg, gen))
        centers, gamma = rbf_ops.rbf_expansion_params(-4.0, 0.0, d, dt)
        self.rbf_centers = nn.Parameter(centers)
        self.rbf_gamma = nn.Parameter(gamma)
        self.to(device)
        self.eval()

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        """Param dtype -> compute dtype (other dtypes pass through)."""
        cfg = self.cfg
        return t.to(cfg.compute_dtype) if t.dtype == cfg.param_dtype else t

    def forward(self, batch: CrystalBatch):
        cfg, dt = self.cfg, self.cfg.compute_dtype
        p = Params(cast_params(self, dt, cfg.param_dtype, skip=("head.",)))
        t = _lin(p, "temp_proj", batch.temperature[:, None].to(dt))
        x = (embedding(p["embedding.weight"], batch.z, dt)
             + embedding(t, batch.graph_id, dt))
        efeat = -0.75 / torch.clamp(batch.cart_dist.to(dt), min=1e-6)
        e = F.softplus(_lin(p, "rbf.lin", rbf_ops.rbf_expansion(
            efeat, p["rbf_centers"], p["rbf_gamma"])))
        x = self.conv0(x, e, batch, p.sub("conv0"))
        x = self.equi(x, e, batch, p.sub("equi"))
        x = self.conv1(x, e, batch, p.sub("conv1"))
        x = self.conv2(x, e, batch, p.sub("conv2"))
        if cfg.cholesky:
            return self.head(x, self.cast), batch.non_h_mask
        return self.head(x, batch, self.cast), batch.graph_mask
