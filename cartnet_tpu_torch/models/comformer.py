"""eComformer and iComformer forward, eval and train (port of
cartnet_tpu/models/comformer.py:42-463).

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

``IComformer``: the same embedding and RBF head, the lattice features of
each edge (``lattice_features``: RBF heads over -0.75 / |cell row| and the
cosines between the cell rows and the edge direction, as channel-major
[3E, d] rows), conv0, the edge update ``ComformerConvEdge`` (plain
PyTorch: the JAX package has no kernel there), conv1-conv3 and the head.
With bf16 compute, eval BN's f32 running stats make the edge update's
output f32, so conv1-conv3 see f32 edges and cast their bf16 K1 weights to
f32 (exact; K1's f32 route), as the JAX package's K1 promotes them. In
training everything keeps the compute dtype.

In parallel (``groups``, as in models/cartnet.py) edge-row BNs (bn_att,
the edge update's) sum over ``groups.edge``, node BNs over
``groups.node``; under edge parallelism the conv's aggregate is summed
over ``groups.ep``; under halo partitioning the key and value
projections run over the table of the member's rows and the received
boundary rows, and the iComformer takes each edge's crystal from
``graph_id[edge_dst]`` (a member's node block is any window of its
slice, where the graph starts need not be sorted).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from cartnet_tpu_torch import tracing
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
                                                        edge_phase_fwd,
                                                        live_edges)
from cartnet_tpu_torch.ops.kernels.segment_kernels import (SigmaSegsum,
                                                           sigma_segsum)
from cartnet_tpu_torch.ops.segment import gather_sorted
from cartnet_tpu_torch.parallel.dist import SINGLE, Groups, ep_sum
from cartnet_tpu_torch.parallel.halo import halo_table


def _lin(p: Params, name: str, x):
    return linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _mlp2(d: int, dt, gen: torch.Generator) -> nn.Sequential:
    """Linear(3d, d) -> SiLU -> Linear(d, d)."""
    seq = nn.Sequential(nn.Linear(3 * d, d, dtype=dt), nn.SiLU(),
                        nn.Linear(d, d, dtype=dt))
    torch_linear_init_(seq[0], gen)
    torch_linear_init_(seq[2], gen)
    return seq


def _as_edge_dtype(weights, dt):
    """K1's weights in the edge dtype ``dt``. They already are, but for the
    bf16 weights on the f32 edges that the iComformer's eval edge update
    gives in bf16 compute: the JAX package's K1 promotes them in its
    products, so they are cast (exact) and K1 takes its f32 route. ``to``
    returns a tensor already in ``dt`` itself, so elsewhere nothing
    changes."""
    return tuple(w.to(dt) for w in weights)


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

    def forward(self, x, edge_attr, batch: CrystalBatch, p: Params,
                groups: Groups = SINGLE, live=None):
        """x [N, d], edge_attr [E, d] -> x [N, d]; train mode when
        ``self.training`` (advances bn/bn_att's running stats; sync BN
        over ``groups``). Under halo partitioning the key and value
        projections run over the table [x ‖ received rows] (the sources'
        rows), and dst, the query, the aggregation and the node BN touch
        the member's own rows only. ``live``: the batch's ``live_edges``
        (None: every edge), which bounds the edge phase."""
        d, eps, mom = x.shape[1], self.cfg.bn_eps, self.cfg.bn_momentum
        n = x.shape[0]
        table = halo_table(x, batch, groups) if batch.halo else x
        k_t, v_t = (_lin(p, name, table) for name in ("lin_key",
                                                      "lin_value"))
        k, v, q = k_t[:n], v_t[:n], _lin(p, "lin_query", x)
        e = _lin(p, "lin_edge", edge_attr)
        wk, wm = p["key_update.0.weight"].t(), p["msg_update.0.weight"].t()
        pdt = torch.promote_types(k.dtype, wk.dtype)
        mm = lambda a, w: torch.matmul(a.to(pdt), w.to(pdt))
        xi = torch.cat([mm(k, wk[:d]), mm(v, wm[:d])], dim=1)
        xj = torch.cat([mm(k_t, wk[d:2 * d]), mm(v_t, wm[d:2 * d])], dim=1)
        we = torch.cat([wk[2 * d:], wm[2 * d:]], dim=1).contiguous()
        b = torch.cat([p["key_update.0.bias"], p["msg_update.0.bias"]])
        weights = (we, b, p["key_update.2.weight"].t().contiguous(),
                   p["key_update.2.bias"],
                   p["msg_update.2.weight"].t().contiguous(),
                   p["msg_update.2.bias"])
        args = (xi, xj, e, *_as_edge_dtype(weights, e.dtype), batch.edge_dst,
                batch.edge_src, batch.edge_mask)
        E = e.shape[0]
        if self.training:
            key_j, msg, _, _, _ = EdgePhase.apply(
                *args, batch.dst_rowptr, batch.edge_src_perm,
                batch.src_rowptr, False, live)
        else:
            key_j, msg, _, _, _ = edge_phase_fwd(*args, live=live)
        q_dst = gather_sorted(q, batch.edge_dst, batch.dst_rowptr,
                              batch.edge_mask)
        alpha = q_dst * key_j / math.sqrt(d)
        if self.training:
            (scale, shift), (mean, var, cnt) = masked_bn_scale_shift_train(
                alpha, p["bn_att.weight"], p["bn_att.bias"], batch.edge_mask,
                eps, groups.edge)
            bn_state_update(self.bn_att, mean, var, cnt, mom)
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
        if not batch.halo:  # nodes copied: each member's rows are partial
            out = ep_sum(out, groups)
        out = _lin(p, "lin_concate", out)
        if self.training:
            out, (mean, var, cnt) = masked_batch_norm_train(
                out, p["bn.weight"], p["bn.bias"], batch.node_mask, eps,
                groups.node)
            bn_state_update(self.bn, mean, var, cnt, mom)
        else:
            out = masked_batch_norm(out, p["bn.weight"], p["bn.bias"],
                                    self.bn.running_mean,
                                    self.bn.running_var, eps)
        return F.softplus(x + out)


class ComformerConvEdge(nn.Module):
    """The edge update over the three lattice channels (port of
    conv_edge_apply, cartnet_tpu/models/comformer.py:227-282): a gated
    attention of each edge (query) over its three lattice rows (keys and
    values from the -0.75 / |row| features and the angle features), summed
    over the channels. Every [3E, d] tensor is channel-major (rows i*E + e)
    and stays rank 2. The first layers of the key and message MLPs over
    [x | y | exy] run as block products: the x block is projected once per
    edge and tiled, never an [E, 3, 3d] concat. Adds keep the JAX package's
    order, where bf16 rounds. Autograd does the backward."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, dt = cfg.dim_in, cfg.param_dtype
        self.cfg = cfg
        names = ("lin_key", "lin_query", "lin_value", "lin_edge",
                 "lin_concate", "key_e1", "key_e2", "key_e3", "value_e1",
                 "value_e2", "value_e3")
        for name in names:
            lin = nn.Linear(d, d, bias=name != "lin_edge", dtype=dt)
            torch_linear_init_(lin, gen)
            setattr(self, name, lin)
        self.key_update = _mlp2(d, dt, gen)
        self.msg_update = _mlp2(d, dt, gen)
        self.bn = nn.BatchNorm1d(d, eps=cfg.bn_eps, momentum=cfg.bn_momentum,
                                 dtype=dt)
        self.bn_att = nn.BatchNorm1d(d, eps=cfg.bn_eps,
                                     momentum=cfg.bn_momentum, dtype=dt)

    def _norm(self, bn: nn.BatchNorm1d, name: str, x, mask, p: Params,
              group=None):
        """``bn`` on edge rows (train BN over ``group``, the edge-stat
        group)."""
        eps = self.cfg.bn_eps
        if not self.training:
            return masked_batch_norm(x, p[f"{name}.weight"], p[f"{name}.bias"],
                                     bn.running_mean, bn.running_var, eps)
        y, (mean, var, n) = masked_batch_norm_train(
            x, p[f"{name}.weight"], p[f"{name}.bias"], mask, eps, group)
        bn_state_update(bn, mean, var, n, self.cfg.bn_momentum)
        return y

    def forward(self, edge_attr, nei_len, nei_ang, edge_mask, p: Params,
                group=None):
        """edge_attr [E, d], nei_len / nei_ang [3E, d] channel-major ->
        edge_attr [E, d]; train mode when ``self.training`` (advances bn
        and bn_att's running stats; sync BN over ``group``, the edge-stat
        group: both normalize edge rows)."""
        E, d = edge_attr.shape
        q, kx, vx = (_lin(p, n, edge_attr) for n in ("lin_query", "lin_key",
                                                      "lin_value"))
        ky, vy = (torch.cat([_lin(p, f"{n}{i + 1}", nei_len[i * E:(i + 1) * E])
                             for i in range(3)])
                  for n in ("key_e", "value_e"))
        exy = linear(nei_ang, p["lin_edge.weight"])

        def pre3(mlp, x2d, y2d):
            w = p[f"{mlp}.0.weight"]
            return ((linear(x2d, w[:, :d]).repeat(3, 1)
                     + linear(y2d, w[:, d:2 * d]))
                    + linear(exy, w[:, 2 * d:])) + p[f"{mlp}.0.bias"]

        key = _lin(p, "key_update.2", F.silu(pre3("key_update", kx, ky)))
        alpha = (q.repeat(3, 1) * key) / math.sqrt(d)
        alpha = self._norm(self.bn_att, "bn_att", alpha, edge_mask.repeat(3),
                           p, group)
        msg = _lin(p, "msg_update.2", F.silu(pre3("msg_update", vx, vy)))
        out3 = _lin(p, "lin_concate", msg * torch.sigmoid(alpha))
        out = (out3[:E] + out3[E:2 * E]) + out3[2 * E:]
        out = self._norm(self.bn, "bn", out, edge_mask, p, group)
        return F.softplus(edge_attr + out)


def lattice_features(batch: CrystalBatch, dt):
    """Each edge's lattice features in ``dt`` (icomformer_apply,
    cartnet_tpu/models/comformer.py:383-433) -> (nei_len_feat [E, 3] =
    -0.75 / |cell row|, cosang [E, 3] = the cosine between each cell row
    and the edge direction). An edge's graph is the one whose node range
    holds its dst (collate's contiguous ranges, only trailing graphs
    empty), clamped to a real graph so that pad edges get finite
    features. The JAX package selects per edge with an [E, G] one-hot
    product of one nonzero term; this indexes."""
    G, N = batch.num_graphs, batch.num_nodes
    dev = batch.edge_dst.device
    cell = batch.cell.to(dt)                                     # [G, 3, 3]
    row_norm_g = torch.linalg.vector_norm(cell, dim=-1)          # [G, 3]
    gids = torch.arange(G, dtype=batch.graph_id.dtype, device=dev)
    if batch.halo:
        # a member's rows are any contiguous window of the slice, so the
        # graph starts are not sorted: its edges' dst rows are its own
        gid_e = torch.clamp(batch.graph_id.index_select(0, batch.edge_dst),
                            0, G - 1)
    else:
        rows = torch.arange(N, dtype=batch.edge_dst.dtype, device=dev)
        owned = (batch.graph_id[:, None] == gids) & batch.node_mask[:, None]
        starts = torch.where(owned, rows[:, None], N).amin(dim=0)  # [G]
        gid_e = torch.clamp(torch.searchsorted(starts, batch.edge_dst,
                                               right=True) - 1, 0, G - 1)
    row_norm = torch.clamp(row_norm_g.index_select(0, gid_e), min=1e-6)
    dirs = batch.cart_dir.to(dt)
    # the JAX package's 3-term bf16 product sums in f32 and rounds once
    cos_raw = torch.einsum("ec,erc->er", dirs.float(),
                           cell.float().index_select(0, gid_e)).to(dt)
    dir_norm = torch.clamp(torch.linalg.vector_norm(dirs, dim=-1,
                                                    keepdim=True), min=1e-6)
    cosang = torch.clamp(cos_raw / (row_norm * dir_norm), -1.0, 1.0)
    return _inv_len(row_norm), cosang


def _inv_len(t):
    """-0.75 / t, rounded once: torch's scalar / tensor multiplies by the
    rounded reciprocal, which rounds twice in bf16 where the JAX package
    divides. The numerator is filled on t's device (a host tensor would
    be a copy to the card a forward, which a CUDA graph cannot capture)."""
    return torch.div(torch.full((), -0.75, dtype=t.dtype, device=t.device),
                     t)


class RBFHead(nn.Module):
    """RBFExpansion(bins=d) -> Linear -> softplus; the centers and gamma
    are the model's ``rbf_centers`` / ``rbf_gamma`` (``rbfa_*`` for the
    iComformer's angle head)."""

    def __init__(self, d: int, dt, gen: torch.Generator):
        super().__init__()
        self.lin = nn.Linear(d, d, dtype=dt)
        torch_linear_init_(self.lin, gen)


def _rbf_head(p: Params, name: str, x, centers: str, gamma: str):
    return F.softplus(_lin(p, f"{name}.lin", rbf_ops.rbf_expansion(
        x, p[centers], p[gamma])))


class _Comformer(nn.Module):
    """What the two Comformers share: the name check and device rule, the
    param cast, the input encoding and the head."""

    NAME = ""

    def _setup(self, cfg: ModelConfig, device, gen: torch.Generator):
        """Checks the name, resolves the device and builds the input
        layers (embedding, temperature projection, RBF head) from
        ``gen`` -> the device."""
        device = resolve_device(device)
        if cfg.name != self.NAME:
            raise ValueError(f"{type(self).__name__} needs cfg.name "
                             f"{self.NAME!r}, got {cfg.name!r}")
        d, dt = cfg.dim_in, cfg.param_dtype
        self.cfg = cfg
        self.embedding = nn.Embedding(119, d, dtype=dt)
        with torch.no_grad():
            self.embedding.weight.normal_(generator=gen)
        self.temp_proj = nn.Linear(1, d, dtype=dt)
        torch_linear_init_(self.temp_proj, gen)
        self.rbf = RBFHead(d, dt, gen)
        return device

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        """Param dtype -> compute dtype (other dtypes pass through)."""
        cfg = self.cfg
        return t.to(cfg.compute_dtype) if t.dtype == cfg.param_dtype else t

    def _encode(self, batch: CrystalBatch):
        """-> (p, x [N, d], dist [E]): the cast params, atom embedding +
        the temperature projection gathered per graph, and the edge
        lengths in the compute dtype, at least 1e-6."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        p = Params(cast_params(self, dt, cfg.param_dtype, skip=("head.",)))
        t = _lin(p, "temp_proj", batch.temperature[:, None].to(dt))
        x = (embedding(p["embedding.weight"], batch.z, dt)
             + embedding(t, batch.graph_id, dt))
        return p, x, torch.clamp(batch.cart_dist.to(dt), min=1e-6)

    def _head(self, x, batch: CrystalBatch, groups: Groups):
        with tracing.span("model.head"):
            if self.cfg.cholesky:
                return self.head(x, self.cast), batch.non_h_mask
            return self.head(x, batch, self.cast, groups), batch.graph_mask


class EComformer(_Comformer):
    """Embedding -> conv0 -> equivariant block -> conv1 -> conv2 -> head.

    Built on the CPU from ``seed`` with a torch.Generator, then moved to
    ``device`` (the card unless the caller passes ``device="cpu"``), in
    eval mode. ``forward`` -> (pred, pred_mask) as ``CartNet``'s; after
    ``model.train()`` the conv and block layers run their train forward;
    ``groups`` as ``CartNet``'s (module docstring).
    """

    NAME = "ecomformer"

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        device = self._setup(cfg, device, gen)
        self.conv0 = ComformerConv(cfg, gen)
        self.conv1 = ComformerConv(cfg, gen)
        self.conv2 = ComformerConv(cfg, gen)
        self.equi = EquiBlock(cfg, gen)
        self.head = (CholeskyHead(cfg, gen) if cfg.cholesky
                     else ScalarHead(cfg, gen))
        d, dt = cfg.dim_in, cfg.param_dtype
        centers, gamma = rbf_ops.rbf_expansion_params(-4.0, 0.0, d, dt)
        self.rbf_centers = nn.Parameter(centers)
        self.rbf_gamma = nn.Parameter(gamma)
        self.to(device)
        self.eval()

    def forward(self, batch: CrystalBatch, groups: Groups = SINGLE):
        with tracing.span("model.forward"):
            with tracing.span("model.encoder"):
                p, x, dist = self._encode(batch)
                e = _rbf_head(p, "rbf", _inv_len(dist), "rbf_centers",
                              "rbf_gamma")
                live = live_edges(batch.edge_mask, batch.edge_mask_src_sorted)
            with tracing.span("model.layer"):
                x = self.conv0(x, e, batch, p.sub("conv0"), groups, live)
            with tracing.span("model.equivariant"):
                x = self.equi(x, e, batch, p.sub("equi"), groups)
            for i in (1, 2):
                with tracing.span("model.layer"):
                    x = getattr(self, f"conv{i}")(x, e, batch,
                                                  p.sub(f"conv{i}"), groups,
                                                  live)
            return self._head(x, batch, groups)


class IComformer(_Comformer):
    """Embedding -> conv0 -> edge update -> conv1 -> conv2 -> conv3 -> head
    (port of icomformer_init / icomformer_apply,
    cartnet_tpu/models/comformer.py:350-463); built, moved and run as
    ``EComformer``. The lattice features go through the RBF head
    (``rbf_centers``) and the angle head (``rbfa_centers`` over [-1, 1])."""

    NAME = "icomformer"

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        device = self._setup(cfg, device, gen)
        d, dt = cfg.dim_in, cfg.param_dtype
        self.rbf_angle = RBFHead(d, dt, gen)
        self.conv0 = ComformerConv(cfg, gen)
        self.conv1 = ComformerConv(cfg, gen)
        self.conv2 = ComformerConv(cfg, gen)
        self.conv3 = ComformerConv(cfg, gen)
        self.edge_update = ComformerConvEdge(cfg, gen)
        self.head = (CholeskyHead(cfg, gen) if cfg.cholesky
                     else ScalarHead(cfg, gen))
        for prefix, lo, hi in (("rbf", -4.0, 0.0), ("rbfa", -1.0, 1.0)):
            centers, gamma = rbf_ops.rbf_expansion_params(lo, hi, d, dt)
            setattr(self, f"{prefix}_centers", nn.Parameter(centers))
            setattr(self, f"{prefix}_gamma", nn.Parameter(gamma))
        self.to(device)
        self.eval()

    def forward(self, batch: CrystalBatch, groups: Groups = SINGLE):
        with tracing.span("model.forward"):
            with tracing.span("model.encoder"):
                p, x, dist = self._encode(batch)
                e = _rbf_head(p, "rbf", _inv_len(dist), "rbf_centers",
                              "rbf_gamma")
                nei_len_feat, cosang = lattice_features(
                    batch, self.cfg.compute_dtype)
                # channel-major [3E] features -> [3E, d] heads (rows i*E + e)
                nei_len = _rbf_head(p, "rbf", nei_len_feat.t().reshape(-1),
                                    "rbf_centers", "rbf_gamma")
                nei_ang = _rbf_head(p, "rbf_angle", cosang.t().reshape(-1),
                                    "rbfa_centers", "rbfa_gamma")
                live = live_edges(batch.edge_mask, batch.edge_mask_src_sorted)
            with tracing.span("model.layer"):
                x = self.conv0(x, e, batch, p.sub("conv0"), groups, live)
            with tracing.span("model.layer"):
                e = self.edge_update(e, nei_len, nei_ang, batch.edge_mask,
                                     p.sub("edge_update"), groups.edge)
            for i in (1, 2, 3):
                with tracing.span("model.layer"):
                    x = getattr(self, f"conv{i}")(x, e, batch,
                                                  p.sub(f"conv{i}"), groups,
                                                  live)
            return self._head(x, batch, groups)
