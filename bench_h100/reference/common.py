"""What the reference models share: graph batches without padding, the
loss, the OneCycle schedules, Adam, and the training data order.

A batch here is the plain concatenation of its crystals (no pads, no atom
relabelling, edges in the records' order): the models' outputs are per
atom and their sums and batch moments do not depend on the order, so the
program's pads and reverse Cuthill-McKee order need not be reproduced.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence

import numpy as np
import torch


def plain_precision(tf32: bool = False) -> None:
    """Float32 products in full float32 (``tf32=True``: the lower
    precision the control computes in)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


@dataclasses.dataclass
class Graphs:
    """One unpadded batch, as a reference's ``forward(g)`` receives it.
    Edge e runs src[e] -> dst[e] and belongs to crystal graph[dst[e]],
    whose lattice rows are cell[graph[dst[e]]]."""
    z: torch.Tensor           # [N] atom numbers
    graph: torch.Tensor       # [N] crystal of each atom
    src: torch.Tensor         # [E]
    dst: torch.Tensor         # [E]
    dist: torch.Tensor        # [E]
    cart_dir: torch.Tensor    # [E, 3]
    temperature: torch.Tensor  # [G]
    y: torch.Tensor           # [N, 3, 3]
    non_h: torch.Tensor       # [N] bool
    cell: torch.Tensor        # [G, 3, 3] lattice rows of each crystal


def graphs(records: Sequence[dict], device,
           dtype: torch.dtype = torch.float32) -> Graphs:
    """The records as one unpadded batch on ``device``, its real-valued
    fields in ``dtype``; the crystals in the records' order (each record's
    ``cell`` as ``training_batches`` left it, rotated where it augments)."""
    off, parts = 0, {k: [] for k in ("z", "graph", "src", "dst", "dist",
                                     "dir", "y")}
    for g, r in enumerate(records):
        n = len(r["z"])
        parts["z"].append(np.asarray(r["z"], np.int64))
        parts["graph"].append(np.full(n, g, np.int64))
        parts["src"].append(np.asarray(r["edge_src"], np.int64) + off)
        parts["dst"].append(np.asarray(r["edge_dst"], np.int64) + off)
        parts["dist"].append(np.asarray(r["cart_dist"], np.float32))
        parts["dir"].append(np.asarray(r["cart_dir"], np.float32))
        parts["y"].append(np.asarray(r["y"], np.float32))
        off += n
    t = {k: torch.from_numpy(np.concatenate(v)).to(device)
         for k, v in parts.items()}
    t = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in t.items()}
    temp = torch.tensor([float(r["temperature"]) for r in records],
                        dtype=dtype, device=device)
    cell = torch.from_numpy(np.stack([np.asarray(r["cell"], np.float32)
                                      for r in records])).to(device, dtype)
    return Graphs(z=t["z"], graph=t["graph"], src=t["src"], dst=t["dst"],
                  dist=t["dist"], cart_dir=t["dir"], temperature=temp,
                  y=t["y"], non_h=t["z"] != 1, cell=cell)


def cholesky_upper(diag, off):
    """U = L^T L of the upper-triangular L with ``diag`` (positive) on its
    diagonal and ``off`` = (L01, L02, L12)."""
    n = diag.shape[0]
    L = torch.zeros(n, 3, 3, dtype=diag.dtype, device=diag.device)
    L[:, 0, 0], L[:, 1, 1], L[:, 2, 2] = diag[:, 0], diag[:, 1], diag[:, 2]
    L[:, 0, 1], L[:, 0, 2], L[:, 1, 2] = off[:, 0], off[:, 1], off[:, 2]
    return L.transpose(1, 2) @ L


def mae_mse(pred, g: Graphs):
    """Mean absolute and squared error over the non-H atoms' 9 entries."""
    diff = (pred - g.y)[g.non_h]
    return diff.abs().mean(), (diff * diff).mean()


def _cos_anneal(start, end, pct):
    return end + (start - end) / 2.0 * (1.0 + math.cos(math.pi * pct))


def onecycle(max_lr: float, total_steps: int, pct_start: float,
             div_factor: float, final_div_factor: float,
             base_momentum: float, max_momentum: float
             ) -> Callable[[int], tuple]:
    """PyTorch OneCycleLR (two-phase cosine, cycle_momentum) -> update
    count -> (lr, beta1)."""
    initial = max_lr / div_factor
    low = initial / final_div_factor
    p1, p2 = float(pct_start * total_steps) - 1.0, float(total_steps) - 1.0

    def at(count: int) -> tuple:
        t = min(float(count), p2)
        if t <= p1:
            pct = min(max(t / max(p1, 1e-8), 0.0), 1.0)
            return (_cos_anneal(initial, max_lr, pct),
                    _cos_anneal(max_momentum, base_momentum, pct))
        pct = min(max((t - p1) / max(p2 - p1, 1e-8), 0.0), 1.0)
        return (_cos_anneal(max_lr, low, pct),
                _cos_anneal(base_momentum, max_momentum, pct))

    return at


class Adam:
    """Adam (beta2 0.999, eps 1e-8, bias-corrected with the step's beta1)
    over named tensors, driven by ``schedule(count) -> (lr, beta1)``."""

    def __init__(self, params: dict, schedule):
        self.params, self.schedule, self.count = params, schedule, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        lr, b1 = self.schedule(self.count)
        self.count += 1
        t = self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=1.0 - 0.999)
            den = (self.v[k].sqrt() / math.sqrt(1.0 - 0.999 ** t)).add_(1e-8)
            p.addcdiv_(self.m[k], den, value=-lr / (1.0 - b1 ** t))


def rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniform rotation from four normals (a unit quaternion), float32."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def training_batches(records: Sequence[dict], seed: int, batch: int,
                     count: int, augment: bool) -> List[List[dict]]:
    """The first ``count`` training micro-batches of a job seeded with
    ``seed``: each pass over the records shuffles them with one generator,
    then (``augment``) rotates each record as its batch is formed, drawing
    from the same generator: the direction vectors and the cell turn by R,
    the ADP targets become R^T U R."""
    rng = np.random.default_rng(seed)
    out: List[List[dict]] = []
    while len(out) < count:
        order = np.arange(len(records))
        rng.shuffle(order)
        for i in range(0, len(order), batch):
            recs = [records[j] for j in order[i:i + batch]]
            if augment:
                rotated = []
                for r in recs:
                    R = rotation(rng)
                    rotated.append({**r, "cart_dir": r["cart_dir"] @ R,
                                    "cell": r["cell"] @ R,
                                    "y": np.einsum("ji,njk,kl->nil", R,
                                                   r["y"], R).astype(
                                                       np.float32)})
                recs = rotated
            out.append(recs)
            if len(out) == count:
                break
    return out


def total_steps(max_epoch: int, epoch_micro_steps: int,
                accumulation: int) -> int:
    """OneCycle's length as the reference trainer sets it: max_epoch *
    len(loader) // accumulation + max_epoch."""
    return max_epoch * epoch_micro_steps // accumulation + max_epoch
