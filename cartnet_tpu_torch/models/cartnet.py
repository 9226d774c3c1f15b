"""CartNet forward, eval and train (port of cartnet_tpu/models/cartnet.py).

Modules and buffers carry the reference's state_dict names
(``encoder.encoder_edge.0.weight``, ``layers.{i}.MLP_gate.0.weight``,
``layers.{i}.norm.running_mean``, ``head.MLP.2.bias`` ...), so
``load_state_dict(strict=True)`` takes a reference ``best.ckpt`` as well as
weights exported from the JAX package.

Numerics follow the reference: params are stored in ``param_dtype`` and cast
once per forward to ``compute_dtype`` (BN running stats are not cast). With
bf16 compute, eval BN2 promotes the node features to f32 after layer 0 while
the edge features stay bf16, so the kernels see bf16 node tables in layer 0
and f32 ones after (see ops/kernels/).

Each layer's edge work runs through two kernels: the fused edge phase
(gathers + both edge MLPs) and the fused sigma chain + segment sum. The
per-node projections xi = x @ Wi and xj = x @ Wj stay plain matmuls. The
forward derives the batch's live edge counts from its masks once
(``live_edges``) and every layer's edge phase, forward and backward, skips
the tail of pad edges past them.

In training (``model.train()``) a layer is the JAX package's flagship
train path (``fused_edge_sigma`` -> ``_fes_plain``): the edge phase as an
autograd Function (K1 forward with the saved residual and per-tile BN
moments, K5 backward) -> the window-moment merge into train-mode BN
scale/shift -> the sigma chain as an autograd Function (K2 forward, K4
backward) -> train-mode BN2 -> silu(aggr) + x. Train BN2 keeps x's dtype,
so with bf16 compute the node tables stay bf16 in every layer. Each train
forward advances the BN running stats in place.

With ``CARTNET_MERGED=1`` in the environment (the JAX package's switch, read
at each train forward as ``fused_edge_sigma`` reads it) the edge phase, the
BN merge and the sigma chain are one autograd Function (``FusedEdgeSigma``:
K1 with the pre-only residual, K2 forward; the merged backward K6 in place
of K4 + K5), and the layer advances norm's running stats once from the
moments it returns.

In parallel (``groups``, parallel/dist.Groups; the JAX package's
``ep_axis``, ``edge_stat_axes`` and ``node_stat_axes``) the edge BN's
moments sum over ``groups.edge`` and the node BN's over ``groups.node``.
Under edge parallelism the rank holds its slice of the edges and every
node: each layer's aggregate is a partial sum, summed over ``groups.ep``
before norm2 (``dist.ep_sum``). Under halo partitioning (a batch with
``halo_send_idx``) the rank owns its nodes and the edges into them: the
boundary source rows arrive by one exchange at d width before the
projections (``halo.halo_table``), xj is projected over that table and
one K1 call reads it (its src rows more than its dst rows), the
aggregate is complete, and the scalar head sums a crystal's partial
means over the members.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cartnet_tpu_torch import tracing
from cartnet_tpu_torch.config import ModelConfig, resolve_device
from cartnet_tpu_torch.data.schema import CrystalBatch
from cartnet_tpu_torch.nn.core import (embedding, linear, mlp_silu,
                                       torch_linear_init_, xavier_uniform_)
from cartnet_tpu_torch.nn.norm import (bn_scale_shift_from_window_moments,
                                       bn_state_update, masked_batch_norm,
                                       masked_batch_norm_train,
                                       masked_bn_scale_shift)
from cartnet_tpu_torch.ops import rbf as rbf_ops
from cartnet_tpu_torch.ops.kernels.edge_kernels import (TILE_EDGES, EdgePhase,
                                                        FusedEdgeSigma,
                                                        edge_phase_fwd,
                                                        live_edges)
from cartnet_tpu_torch.ops.kernels.segment_kernels import (SigmaSegsum,
                                                           sigma_segsum)
from cartnet_tpu_torch.ops.linalg3 import assemble_cholesky_upper
from cartnet_tpu_torch.ops.segment import masked_segment_sum, segment_sum
from cartnet_tpu_torch.parallel.dist import SINGLE, Groups, ep_sum
from cartnet_tpu_torch.parallel.halo import halo_table

Cast = Callable[[torch.Tensor], torch.Tensor]


def _lin_pairs(seq: nn.Sequential, cast: Cast):
    return [(cast(m.weight), cast(m.bias)) for m in seq
            if isinstance(m, nn.Linear)]


class ExpNormalSmearing(nn.Module):
    """Holds ``means``/``betas``. They are parameters, as in the JAX package
    (``params["encoder"]["rbf_means"/"rbf_betas"]``, which Adam updates);
    the state_dict keys are the reference buffers' names."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        means, betas = rbf_ops.exp_normal_params(0.0, cfg.radius, cfg.dim_rbf,
                                                 cfg.param_dtype)
        self.means = nn.Parameter(means)
        self.betas = nn.Parameter(betas)


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, dt = cfg.dim_in, cfg.param_dtype
        self.cfg = cfg
        if cfg.use_atom_types:
            self.embedding = nn.Embedding(119, 2 * d, dtype=dt)
            xavier_uniform_(self.embedding.weight, gen)
        elif not cfg.use_temperature:
            # a single learned row broadcast to all atoms (torch N(0,1))
            self.embedding = nn.Embedding(1, d, dtype=dt)
            with torch.no_grad():
                self.embedding.weight.normal_(generator=gen)
        if cfg.use_temperature:
            self.temperature_proj_atom = nn.Linear(1, 2 * d, dtype=dt)
            torch_linear_init_(self.temperature_proj_atom, gen)
        elif cfg.use_atom_types:
            self.bias = nn.Parameter(torch.zeros(2 * d, dtype=dt))
        if cfg.use_temperature or cfg.use_atom_types:
            # Sequential(SiLU, Linear, SiLU): activation BEFORE the linear
            self.encoder_atom = nn.Sequential(
                nn.SiLU(), nn.Linear(2 * d, d, dtype=dt), nn.SiLU())
            torch_linear_init_(self.encoder_atom[1], gen)
        dim_edge = cfg.dim_rbf + (0 if cfg.invariant else 3)
        self.encoder_edge = nn.Sequential(
            nn.Linear(dim_edge, 2 * d, dtype=dt), nn.SiLU(),
            nn.Linear(2 * d, d, dtype=dt), nn.SiLU())
        torch_linear_init_(self.encoder_edge[0], gen)
        torch_linear_init_(self.encoder_edge[2], gen)
        self.rbf = ExpNormalSmearing(cfg)

    def forward(self, batch: CrystalBatch, cast: Cast):
        """-> (x [N, d], e [E, d]) in the compute dtype."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        temp, atom = cfg.use_temperature, cfg.use_atom_types
        if temp:
            t = linear(batch.temperature[:, None].to(dt),
                       cast(self.temperature_proj_atom.weight),
                       cast(self.temperature_proj_atom.bias))
        if temp and atom:
            x = (embedding(cast(self.embedding.weight), batch.z, dt)
                 + embedding(t, batch.graph_id, dt))
        elif atom:
            x = embedding(cast(self.embedding.weight), batch.z, dt) \
                + cast(self.bias)
        elif temp:
            x = embedding(t, batch.graph_id, dt)
        else:
            x = cast(self.embedding.weight)[0].to(dt).expand(
                batch.num_nodes, cfg.dim_in)
        if temp or atom:
            lin = self.encoder_atom[1]
            x = F.silu(linear(F.silu(x), cast(lin.weight), cast(lin.bias)))
        feats = rbf_ops.exp_normal_smearing(
            batch.cart_dist.to(dt), cast(self.rbf.means).to(dt),
            cast(self.rbf.betas).to(dt), cfg.radius)
        if not cfg.invariant:
            feats = torch.cat([feats, batch.cart_dir.to(dt)], dim=-1)
        e = mlp_silu(feats, _lin_pairs(self.encoder_edge, cast),
                     final_act=True)
        return x, e


class CartNetLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, dt = cfg.dim_in, cfg.param_dtype
        self.cfg = cfg
        for name in ("MLP_gate", "MLP_aggr"):
            seq = nn.Sequential(nn.Linear(3 * d, d, dtype=dt), nn.SiLU(),
                                nn.Linear(d, d, dtype=dt))
            torch_linear_init_(seq[0], gen)
            torch_linear_init_(seq[2], gen)
            setattr(self, name, seq)
        self.norm = nn.BatchNorm1d(d, eps=cfg.bn_eps,
                                   momentum=cfg.bn_momentum, dtype=dt)
        self.norm2 = nn.BatchNorm1d(d, eps=cfg.bn_eps,
                                    momentum=cfg.bn_momentum, dtype=dt)

    def _weights(self, cast: Cast):
        """(wi, wj, we, b, w1g, b1g, w1a, b1a) in the compute dtype. The
        gate/aggr MLPs' first layers act on [x_dst | x_src | e]: their node
        blocks merge into one [d, 2d] projection per endpoint."""
        d = self.cfg.dim_in
        g0, g1 = self.MLP_gate[0], self.MLP_gate[2]
        a0, a1 = self.MLP_aggr[0], self.MLP_aggr[2]
        wg, wa = cast(g0.weight).t(), cast(a0.weight).t()        # [3d, d]
        return (torch.cat([wg[:d], wa[:d]], dim=1),
                torch.cat([wg[d:2 * d], wa[d:2 * d]], dim=1),
                torch.cat([wg[2 * d:], wa[2 * d:]], dim=1).contiguous(),
                torch.cat([cast(g0.bias), cast(a0.bias)]),
                cast(g1.weight).t().contiguous(), cast(g1.bias),
                cast(a1.weight).t().contiguous(), cast(a1.bias))

    def forward(self, x, e, batch: CrystalBatch,
                env: Optional[torch.Tensor], cast: Cast,
                groups: Groups = SINGLE, live=None):
        """One message-passing layer -> (x_out, e_out); train mode when
        ``self.training`` (sync BN over ``groups``, module docstring);
        ``live``: the batch's ``live_edges`` (None: every edge)."""
        if self.training:
            return self._train_forward(x, e, batch, env, cast, groups, live)
        eps = self.cfg.bn_eps
        wi, wj, we, b, w1g, b1g, w1a, b1a = self._weights(cast)
        pdt = torch.promote_types(x.dtype, wi.dtype)
        xi = torch.matmul(x.to(pdt), wi.to(pdt))                   # [N, 2d]
        xj = torch.matmul(_src_table(x, batch, groups).to(pdt), wj.to(pdt))
        gate, sender, _, _, _ = edge_phase_fwd(
            xi, xj, e, we, b, w1g, b1g, w1a, b1a,
            batch.edge_dst, batch.edge_src, batch.edge_mask, live=live)
        scale, shift = masked_bn_scale_shift(
            cast(self.norm.weight), cast(self.norm.bias),
            self.norm.running_mean, self.norm.running_var, eps)
        env_col = (env[:, None] if env is not None else
                   torch.ones((batch.num_edges, 1), device=e.device))
        e_out, aggr = sigma_segsum(
            gate, scale.float(), shift.float(),
            env_col.to(gate.dtype).contiguous(), sender, e, batch.edge_dst,
            batch.edge_mask, batch.dst_rowptr, batch.num_nodes)
        aggr = masked_batch_norm(
            _aggregate(aggr, batch, groups), cast(self.norm2.weight),
            cast(self.norm2.bias), self.norm2.running_mean,
            self.norm2.running_var, eps)
        return F.silu(aggr) + x, e_out

    def _train_forward(self, x, e, batch: CrystalBatch,
                       env: Optional[torch.Tensor], cast: Cast,
                       groups: Groups = SINGLE, live=None):
        """The train-mode layer (the JAX package's ``fused_edge_sigma``:
        the ``_fes_plain`` composition, or ``_fes_op`` under
        ``CARTNET_MERGED=1``); advances norm/norm2's running stats."""
        eps, mom = self.cfg.bn_eps, self.cfg.bn_momentum
        wi, wj, we, b, w1g, b1g, w1a, b1a = self._weights(cast)
        xi = torch.matmul(x, wi)
        xj = torch.matmul(_src_table(x, batch, groups), wj)
        idx = (batch.edge_dst, batch.edge_src, batch.edge_mask,
               batch.dst_rowptr, batch.edge_src_perm, batch.src_rowptr)
        env_col = (env[:, None] if env is not None else
                   torch.ones((batch.num_edges, 1), device=e.device))
        env_col = env_col.to(x.dtype).contiguous()
        gamma, beta = cast(self.norm.weight), cast(self.norm.bias)
        if os.environ.get("CARTNET_MERGED", "0") == "1":
            e_out, aggr, mean, var, n = FusedEdgeSigma.apply(
                xi, xj, e, we, b, w1g, b1g, w1a, b1a, gamma, beta, env_col,
                *idx, eps, groups.edge, live)
            bn_state_update(self.norm, mean, var, n, mom)
        else:
            gate, sender, e_res, s1w, m2w = EdgePhase.apply(
                xi, xj, e, we, b, w1g, b1g, w1a, b1a, *idx, True, live)
            scale, shift = bn_scale_shift_from_window_moments(
                self.norm, gamma, beta, s1w, m2w, batch.edge_mask,
                TILE_EDGES, mom, eps, groups.edge)
            e_out, aggr = SigmaSegsum.apply(
                gate, scale, shift, env_col, sender, e_res, batch.edge_dst,
                batch.edge_mask, batch.dst_rowptr, batch.num_nodes)
        aggr, (mean, var, n) = masked_batch_norm_train(
            _aggregate(aggr, batch, groups), cast(self.norm2.weight),
            cast(self.norm2.bias), batch.node_mask, eps, groups.node)
        bn_state_update(self.norm2, mean, var, n, mom)
        return F.silu(aggr) + x, e_out


def _src_table(x, batch: CrystalBatch, groups: Groups):
    """The node rows the edges' sources index: x, or under halo
    partitioning x with the received boundary rows below it (exchanged at
    d width, before the projection: one K1 call then reads the whole
    table)."""
    return halo_table(x, batch, groups) if batch.halo else x


def _aggregate(aggr, batch: CrystalBatch, groups: Groups):
    """A member's aggregates -> the dp slice's: summed over the ep members
    where each holds partial rows (nodes copied), as they are under halo
    partitioning (dst owned) or in one process."""
    return aggr if batch.halo else ep_sum(aggr, groups)


class CholeskyHead(nn.Module):
    """[N, d] -> SPD U [N, 3, 3]."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, dt = cfg.dim_in, cfg.param_dtype
        self.MLP = nn.Sequential(nn.Linear(d, d // 2, dtype=dt), nn.SiLU(),
                                 nn.Linear(d // 2, 6, dtype=dt))
        torch_linear_init_(self.MLP[0], gen)
        torch_linear_init_(self.MLP[2], gen)

    def forward(self, x, cast: Cast):
        out = mlp_silu(x, _lin_pairs(self.MLP, cast))
        return assemble_cholesky_upper(F.softplus(out[:, :3]), out[:, 3:])


class ScalarHead(nn.Module):
    """[N, d] -> per-graph scalar [G] via masked scatter-mean."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, dt = cfg.dim_in, cfg.param_dtype
        self.MLP = nn.Sequential(nn.Linear(d, d // 2, dtype=dt), nn.SiLU(),
                                 nn.Linear(d // 2, 1, dtype=dt))
        torch_linear_init_(self.MLP[0], gen)
        torch_linear_init_(self.MLP[2], gen)

    def forward(self, x, batch: CrystalBatch, cast: Cast,
                groups: Groups = SINGLE):
        out = mlp_silu(x, _lin_pairs(self.MLP, cast))
        s = masked_segment_sum(out, batch.graph_id, batch.node_mask,
                               batch.num_graphs)
        cnt = segment_sum(batch.node_mask.to(out.dtype), batch.graph_id,
                          batch.num_graphs)
        if batch.halo:  # a crystal's nodes may sit on several members
            s, cnt = ep_sum(s, groups), ep_sum(cnt, groups)
        return (s / torch.clamp(cnt, min=1.0)[:, None])[:, 0]


class CartNet(nn.Module):
    """Encoder -> num_layers CartNet layers -> Cholesky (or scalar) head.

    Built on the CPU from ``seed`` with a torch.Generator, then moved to
    ``device`` (the card unless the caller passes ``device="cpu"``), in
    eval mode. ``forward`` -> (pred, pred_mask), where pred is [N, 3, 3]
    (Cholesky, mask = non-H real nodes) or [G] (scalar, mask = real
    graphs); after ``model.train()`` it is the train forward. ``groups``
    (parallel/dist.Groups) makes it one rank's share of a parallel step
    (module docstring).
    """

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if cfg.name != "cartnet":
            raise ValueError(f"only CartNet is ported, got {cfg.name!r}")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.encoder = Encoder(cfg, gen)
        self.layers = nn.ModuleList(CartNetLayer(cfg, gen)
                                    for _ in range(cfg.num_layers))
        self.head = (CholeskyHead(cfg, gen) if cfg.cholesky
                     else ScalarHead(cfg, gen))
        self.to(device)
        self.eval()

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        """Param dtype -> compute dtype (other dtypes pass through)."""
        cfg = self.cfg
        return t.to(cfg.compute_dtype) if t.dtype == cfg.param_dtype else t

    def envelope(self, batch: CrystalBatch, dtype: torch.dtype):
        """CosineCutoff(dist), shared by every layer (None when off)."""
        if not self.cfg.use_envelope:
            return None
        return rbf_ops.cosine_cutoff(batch.cart_dist.to(dtype),
                                     self.cfg.radius)

    def forward(self, batch: CrystalBatch, groups: Groups = SINGLE):
        with tracing.span("model.forward"):
            with tracing.span("model.encoder"):
                x, e = self.encoder(batch, self.cast)
                env = self.envelope(batch, x.dtype)
                live = live_edges(batch.edge_mask, batch.edge_mask_src_sorted)
            for layer in self.layers:
                with tracing.span("model.layer"):
                    x, e = layer(x, e, batch, env, self.cast, groups, live)
            with tracing.span("model.head"):
                if self.cfg.cholesky:
                    return self.head(x, self.cast), batch.non_h_mask
                return (self.head(x, batch, self.cast, groups),
                        batch.graph_mask)
