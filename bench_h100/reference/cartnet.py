"""CartNet (Solé et al., "A Cartesian encoding graph neural network for
crystal structure property prediction", 2025; github.com/imatge-upc/CartNet)
in plain float32 PyTorch, with the Cholesky ADP head.

Encoder: atom embedding plus the projected temperature, then SiLU, Linear,
SiLU; edges: the exp-normal radial basis of the distance (enveloped by a
cosine cutoff) next to the unit direction, through Linear, SiLU, Linear,
SiLU. Each layer: gate and message MLPs over [x_dst | x_src | e]; the gate
through BatchNorm, a sigmoid and the cosine envelope; the gated messages
summed per destination, BatchNorm, SiLU and a residual; the edge features
gain the gate. The head maps each atom to the Cholesky factor of its ADP
tensor U = L^T L (softplus on the diagonal).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_h100.reference.common import Graphs, cholesky_upper


def cosine_cutoff(dist, radius: float):
    return 0.5 * (torch.cos(dist * math.pi / radius) + 1.0) * (dist < radius)


class ExpNormalSmearing(nn.Module):
    """PhysNet's radial basis: means evenly spaced in exp(-d) from
    exp(-radius) to 1, one width for all."""

    def __init__(self, radius: float, num: int):
        super().__init__()
        start = math.exp(-radius)
        self.radius = radius
        self.means = nn.Parameter(torch.linspace(start, 1.0, num,
                                                 dtype=torch.float64).float())
        self.betas = nn.Parameter(torch.full(
            (num,), (2.0 / num * (1.0 - start)) ** -2))

    def forward(self, dist):
        d = dist[:, None]
        alpha = 5.0 / self.radius
        return cosine_cutoff(d, self.radius) * torch.exp(
            -self.betas * (torch.exp(-alpha * d) - self.means) ** 2)


def _mlp(d_in: int, d: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, d), nn.SiLU(), nn.Linear(d, d))


class Encoder(nn.Module):
    def __init__(self, d: int, num_rbf: int, radius: float):
        super().__init__()
        self.embedding = nn.Embedding(119, 2 * d)
        self.temperature_proj_atom = nn.Linear(1, 2 * d)
        self.encoder_atom = nn.Sequential(nn.SiLU(), nn.Linear(2 * d, d),
                                          nn.SiLU())
        self.encoder_edge = nn.Sequential(
            nn.Linear(num_rbf + 3, 2 * d), nn.SiLU(), nn.Linear(2 * d, d),
            nn.SiLU())
        self.rbf = ExpNormalSmearing(radius, num_rbf)

    def forward(self, g: Graphs):
        t = self.temperature_proj_atom(g.temperature[:, None])
        x = self.encoder_atom(self.embedding(g.z) + t[g.graph])
        e = self.encoder_edge(torch.cat([self.rbf(g.dist), g.cart_dir], 1))
        return x, e


class Layer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.MLP_gate = _mlp(3 * d, d)
        self.MLP_aggr = _mlp(3 * d, d)
        self.norm = nn.BatchNorm1d(d)
        self.norm2 = nn.BatchNorm1d(d)

    def forward(self, x, e, g: Graphs, env):
        cat = torch.cat([x[g.dst], x[g.src], e], 1)
        sig = torch.sigmoid(self.norm(self.MLP_gate(cat))) * env[:, None]
        msg = sig * self.MLP_aggr(cat)
        aggr = torch.zeros_like(x).index_add_(0, g.dst, msg)
        return F.silu(self.norm2(aggr)) + x, e + sig


class CholeskyHead(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.MLP = nn.Sequential(nn.Linear(d, d // 2), nn.SiLU(),
                                 nn.Linear(d // 2, 6))

    def forward(self, x):
        out = self.MLP(x)
        return cholesky_upper(F.softplus(out[:, :3]), out[:, 3:])


class CartNet(nn.Module):
    def __init__(self, dim_in: int = 256, dim_rbf: int = 64,
                 num_layers: int = 4, radius: float = 5.0, **_):
        super().__init__()
        self.radius = radius
        self.encoder = Encoder(dim_in, dim_rbf, radius)
        self.layers = nn.ModuleList(Layer(dim_in) for _ in range(num_layers))
        self.head = CholeskyHead(dim_in)

    def forward(self, g: Graphs):
        x, e = self.encoder(g)
        env = cosine_cutoff(g.dist, self.radius)
        for layer in self.layers:
            x, e = layer(x, e, g, env)
        return self.head(x)
