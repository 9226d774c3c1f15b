"""eComformer (Yan et al., "Complete and efficient graph transformers for
crystal material property prediction", ICLR 2024) in plain float32
PyTorch, with the Cholesky ADP head.

Input: atom embedding plus the projected temperature of the atom's
crystal; edges: a Gaussian basis of -0.75 / distance through Linear and
softplus. Three gated single-head attention convs (key and message MLPs
over [k_dst | k_src | e] and [v_dst | v_src | e], BatchNorm on the
scaled query-key product, a sigmoid gate, the sum per destination,
Linear, BatchNorm, softplus of the residual) with the equivariant block
after the first: node scalars (64x0e) gathered at each edge's destination
and tensor-multiplied with the spherical harmonics (l <= 2) of its
direction under weights an MLP makes from the edge features (5120 per
edge), averaged onto the sources as 64x0e + 8x1o + 8x2e, then back to
64x0e the same way, BatchNorm, two softplus-Linear steps and a skip.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_h100.reference.cartnet import CholeskyHead
from bench_h100.reference.common import Graphs

NS, NV = 64, 8  # scalar and vector/tensor channels


def spherical_harmonics(vec):
    """Real spherical harmonics l = 0, 1, 2 of directions, component
    normalised; l = 1 ordered (x, y, z)."""
    vec = vec / torch.clamp(vec.norm(dim=-1, keepdim=True), min=1e-12)
    x, y, z = vec.unbind(-1)
    s3, s5, s15 = math.sqrt(3.0), math.sqrt(5.0), math.sqrt(15.0)
    y2 = torch.stack([s15 * x * y, s15 * y * z,
                      (s5 / 2.0) * (3.0 * z * z - 1.0), s15 * x * z,
                      (s15 / 2.0) * (x * x - y * y)], -1)
    return torch.ones_like(x)[:, None], s3 * vec, y2


def _mlp(d: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(3 * d, d), nn.SiLU(), nn.Linear(d, d))


class Conv(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        for name in ("lin_key", "lin_query", "lin_value", "lin_edge",
                     "lin_concate"):
            setattr(self, name, nn.Linear(d, d))
        self.key_update = _mlp(d)
        self.msg_update = _mlp(d)
        self.bn = nn.BatchNorm1d(d)
        self.bn_att = nn.BatchNorm1d(d)

    def forward(self, x, e, g: Graphs):
        d = x.shape[1]
        k, v, q = self.lin_key(x), self.lin_value(x), self.lin_query(x)
        ee = self.lin_edge(e)
        key = self.key_update(torch.cat([k[g.dst], k[g.src], ee], 1))
        msg = self.msg_update(torch.cat([v[g.dst], v[g.src], ee], 1))
        alpha = self.bn_att(q[g.dst] * key / math.sqrt(d))
        out = torch.zeros_like(x).index_add_(0, g.dst,
                                             torch.sigmoid(alpha) * msg)
        return F.softplus(x + self.bn(self.lin_concate(out)))


class FC(nn.Module):
    """The tensor product's weight generator over the edge features."""

    def __init__(self, d: int):
        super().__init__()
        self.lin0 = nn.Linear(d, d)
        self.lin1 = nn.Linear(d, NS * NS + 2 * NS * NV)

    def forward(self, e):
        return self.lin1(F.softplus(self.lin0(e)))


def _paths(w, widths):
    """The per-edge weight table [E, 5120] cut into each path's [E, U, V]
    block, U and V as listed, in column order."""
    out, off = [], 0
    for u, v in widths:
        out.append(w[:, off:off + u * v].reshape(-1, u, v))
        off += u * v
    return out


class EquiBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.node_linear = nn.Linear(d, NS)
        self.skip_linear = nn.Linear(d, d)
        self.tp1 = FC(d)
        self.tp2 = FC(d)
        self.node_linear_2 = nn.Linear(NS, d)
        self.bn = nn.BatchNorm1d(NS)

    def forward(self, x, e, g: Graphs):
        y0, y1, y2 = spherical_harmonics(g.cart_dir)
        n = x.shape[0]
        deg = torch.zeros_like(x[:, 0]).index_add_(
            0, g.src, torch.ones_like(g.dist))
        inv = 1.0 / torch.clamp(deg, min=1.0)[:, None]

        def mean_onto_src(vals):
            s = vals.new_zeros(n, vals.shape[1])
            return s.index_add_(0, g.src, vals) * inv

        s_node = self.node_linear(x)
        a = s_node[g.dst]
        w0, w1, w2 = _paths(self.tp1(e), ((NS, NS), (NS, NV), (NS, NV)))
        c0 = torch.einsum("eu,euv->ev", a, w0)
        c1 = torch.einsum("eu,euv->ev", a, w1)
        c2 = torch.einsum("eu,euv->ev", a, w2)
        E = a.shape[0]
        s_e = c0 * y0 / 8.0
        v_e = (c1[:, :, None] * y1[:, None, :] / 8.0).reshape(E, -1)
        t_e = (c2[:, :, None] * y2[:, None, :] / 8.0).reshape(E, -1)
        cat = mean_onto_src(torch.cat([s_e, v_e, t_e], 1))
        cat = torch.cat([cat[:, :NS] + s_node, cat[:, NS:]], 1)

        h = cat[g.dst]
        s = h[:, :NS]
        v = h[:, NS:NS + 3 * NV].reshape(E, NV, 3)
        t = h[:, NS + 3 * NV:].reshape(E, NV, 5)
        a0 = s * y0
        a1 = torch.einsum("eum,em->eu", v, y1) / math.sqrt(3.0)
        a2 = torch.einsum("eum,em->eu", t, y2) / math.sqrt(5.0)
        w0, w1, w2 = _paths(self.tp2(e), ((NS, NS), (NV, NS), (NV, NS)))
        out_e = (torch.einsum("eu,euv->ev", a0, w0)
                 + torch.einsum("eu,euv->ev", a1, w1)
                 + torch.einsum("eu,euv->ev", a2, w2)) / math.sqrt(80.0)
        out = self.bn(mean_onto_src(out_e))
        out = F.softplus(self.node_linear_2(F.softplus(out)))
        return out + self.skip_linear(x)


class RBFHead(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.lin = nn.Linear(d, d)


class EComformer(nn.Module):
    def __init__(self, dim_in: int = 256, **_):
        super().__init__()
        d = dim_in
        self.embedding = nn.Embedding(119, d)
        self.temp_proj = nn.Linear(1, d)
        self.rbf = RBFHead(d)
        self.conv0, self.conv1, self.conv2 = Conv(d), Conv(d), Conv(d)
        self.equi = EquiBlock(d)
        self.head = CholeskyHead(d)
        # Gaussian basis over [-4, 0], gamma = 1 / spacing
        self.rbf_centers = nn.Parameter(torch.linspace(
            -4.0, 0.0, d, dtype=torch.float64).float())
        self.rbf_gamma = nn.Parameter(torch.tensor((d - 1) / 4.0))

    def forward(self, g: Graphs):
        x = self.embedding(g.z) + self.temp_proj(g.temperature[:, None])[
            g.graph]
        inv = -0.75 / torch.clamp(g.dist, min=1e-6)
        e = F.softplus(self.rbf.lin(torch.exp(
            -self.rbf_gamma * (inv[:, None] - self.rbf_centers) ** 2)))
        x = self.conv0(x, e, g)
        x = self.equi(x, e, g)
        x = self.conv1(x, e, g)
        x = self.conv2(x, e, g)
        return self.head(x)
