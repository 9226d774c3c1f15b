"""The eComformer's equivariant tensor-product block, eval and train (port
of cartnet_tpu/models/equivariant.py).

Irreps 64x0e -> (64x0e + 8x1o + 8x2e) -> 64x0e with the spherical harmonics
of cart_dir (1x0e + 1x1o + 1x2e). Per-edge TP weights come from an fc MLP
over the edge features (Linear, softplus, Linear to 5120); its second layer
and the contraction with the gathered irreps run in one kernel
(ops/kernels/tp_kernels.py: K7 forward, K8 backward, through the
``TPContractL1`` / ``TPContractL2`` Functions). The TP path constants are
e3nn's FullyConnectedTensorProduct values derived in the JAX module: 1/8 for
the three layer-1 paths, 1/sqrt(80) x (1, 1/sqrt(3), 1/sqrt(5)) for layer 2.

The reference's (reversed) flow is kept: node scalars are gathered at
edge_dst (``gather_sorted``: its backward is K3 over ``dst_rowptr`` and the
edge mask) and scatter-MEANed onto edge_src, through the CSR segment-sum
kernel (K3) over collate's ``edge_src_perm`` / ``src_rowptr`` /
``edge_mask_src_sorted``, divided by max(src_degree, 1) outside it (its
backward is a gather). The node BN runs in train mode when
``self.training``. The layer-1 residual adds the node scalars only. The
JAX package's 128-lane padded gathers and the [out_e | 0] concatenation are
TPU layout: the port gathers [N, 64] directly and scatters out_e [E, 64]
alone.

In parallel (``groups``) the scatter-means are the global sum over the
global count (``src_degree`` is the dp slice's): under edge parallelism
each member's partial sums are summed over ``groups.ep``; under halo
partitioning the sums over the member's table (its rows and the received
ones) send the received rows' partials back to their owners
(``halo.halo_scatter_back``). The node BN sums over ``groups.node``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from cartnet_tpu_torch.config import ModelConfig
from cartnet_tpu_torch.data.schema import CrystalBatch
from cartnet_tpu_torch.nn.core import Params, linear, torch_linear_init_
from cartnet_tpu_torch.nn.norm import (bn_state_update, masked_batch_norm,
                                       masked_batch_norm_train)
from cartnet_tpu_torch.ops.kernels import tp_kernels
from cartnet_tpu_torch.ops.segment import gather_sorted, segment_sum_presorted
from cartnet_tpu_torch.ops.sh import SQRT3, SQRT5, spherical_harmonics_l012
from cartnet_tpu_torch.parallel.dist import SINGLE, Groups, ep_sum
from cartnet_tpu_torch.parallel.halo import halo_scatter_back

NS, NV = 64, 8  # scalar and vector/tensor channels (reference defaults)


class FC(nn.Module):
    """The TP weight generator: Linear(d, d) -> softplus -> Linear(d,
    numel); ``lin1.weight`` [numel, d] is the kernel's ``wt``."""

    def __init__(self, d: int, numel: int, dtype, gen: torch.Generator):
        super().__init__()
        self.lin0 = nn.Linear(d, d, dtype=dtype)
        self.lin1 = nn.Linear(d, numel, dtype=dtype)
        torch_linear_init_(self.lin0, gen)
        torch_linear_init_(self.lin1, gen)


def _fc_hidden(p: Params, e):
    return F.softplus(linear(e, p["lin0.weight"], p["lin0.bias"]))


def tp_layer1_apply(p: Params, s_dst, y0, y1, y2, edge_attr):
    """64x0e (x) sh -> (s [E, 64], v [E, 8, 3], t [E, 8, 5]); ``p`` holds
    the fc's cast parameters."""
    h = _fc_hidden(p, edge_attr)
    c0, c1, c2 = tp_kernels.TPContractL1.apply(h, s_dst.contiguous(),
                                               p["lin1.weight"],
                                               p["lin1.bias"])
    inv = 1.0 / math.sqrt(NS)
    return (c0 * y0 * inv, c1[..., None] * y1[:, None, :] * inv,
            c2[..., None] * y2[:, None, :] * inv)


def tp_layer2_apply(p: Params, s, v, t, y0, y1, y2, edge_attr):
    """(64x0e + 8x1o + 8x2e) (x) sh -> 64x0e [E, 64]."""
    h = _fc_hidden(p, edge_attr)
    a0 = s * y0
    d1 = torch.einsum("eum,em->eu", v, y1) / SQRT3
    d2 = torch.einsum("eum,em->eu", t, y2) / SQRT5
    out = tp_kernels.TPContractL2.apply(h, a0.contiguous(), d1.contiguous(),
                                        d2.contiguous(), p["lin1.weight"],
                                        p["lin1.bias"])
    return out * (1.0 / math.sqrt(80.0))


class EquiBlock(nn.Module):
    """x [N, d] -> [N, d], rotation invariant."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d, dt = cfg.dim_in, cfg.param_dtype
        self.cfg = cfg
        self.node_linear = nn.Linear(d, NS, dtype=dt)
        self.skip_linear = nn.Linear(d, d, dtype=dt)
        torch_linear_init_(self.node_linear, gen)
        torch_linear_init_(self.skip_linear, gen)
        self.tp1 = FC(d, NS * NS + 2 * NS * NV, dt, gen)
        self.tp2 = FC(d, NS * NS + 2 * NV * NS, dt, gen)
        self.node_linear_2 = nn.Linear(NS, d, dtype=dt)
        torch_linear_init_(self.node_linear_2, gen)
        self.bn = nn.BatchNorm1d(NS, eps=cfg.bn_eps, momentum=cfg.bn_momentum,
                                 dtype=dt)

    def forward(self, x, edge_attr, batch: CrystalBatch, p: Params,
                groups: Groups = SINGLE):
        src_perm, dst = batch.edge_src_perm, batch.edge_dst
        E = dst.shape[0]
        y0, y1, y2 = spherical_harmonics_l012(batch.cart_dir.to(x.dtype))
        s_node = linear(x, p["node_linear.weight"], p["node_linear.bias"])
        inv_cnt = 1.0 / torch.clamp(batch.src_degree.to(x.dtype),
                                    min=1.0)[:, None]

        def smean(flat):
            # the members' partials: summed over ep (nodes copied), or
            # under halo the received rows' sums sent back to their owners;
            # src_degree is the dp slice's count
            s = segment_sum_presorted(
                flat, src_perm, batch.src_rowptr, batch.edge_mask_src_sorted,
                batch.edge_src, batch.edge_mask)
            s = (halo_scatter_back(s, batch, groups) if batch.halo
                 else ep_sum(s, groups))
            return s * inv_cnt

        def g_dst(table):
            return gather_sorted(table, dst, batch.dst_rowptr,
                                 batch.edge_mask)

        # TP layer 1: gather at dst, scatter-mean onto src (reference flow)
        s_e, v_e, t_e = tp_layer1_apply(p.sub("tp1"), g_dst(s_node), y0, y1,
                                        y2, edge_attr)
        cat1 = smean(torch.cat([s_e, v_e.reshape(E, -1), t_e.reshape(E, -1)],
                               dim=1))
        # residual: the scalar part only
        cat1 = torch.cat([cat1[:, :NS] + s_node, cat1[:, NS:]], dim=1)

        # TP layer 2 (no residual)
        g = g_dst(cat1)
        out_e = tp_layer2_apply(p.sub("tp2"), g[:, :NS],
                                g[:, NS:NS + 3 * NV].reshape(E, NV, 3),
                                g[:, NS + 3 * NV:].reshape(E, NV, 5), y0, y1,
                                y2, edge_attr)
        out = smean(out_e)
        if self.training:
            out, (mean, var, n) = masked_batch_norm_train(
                out, p["bn.weight"], p["bn.bias"], batch.node_mask,
                self.cfg.bn_eps, groups.node)
            bn_state_update(self.bn, mean, var, n, self.cfg.bn_momentum)
        else:
            out = masked_batch_norm(out, p["bn.weight"], p["bn.bias"],
                                    self.bn.running_mean,
                                    self.bn.running_var, self.cfg.bn_eps)
        out = F.softplus(linear(F.softplus(out), p["node_linear_2.weight"],
                                p["node_linear_2.bias"]))
        return out + linear(x, p["skip_linear.weight"], p["skip_linear.bias"])
