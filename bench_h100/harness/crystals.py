"""The crystal pool a cell trains or predicts on.

A frozen copy of the port's synthetic generator
(``cartnet_tpu_torch/data/synthetic.random_crystal``) and of the numpy
radius graph it calls, kept here so that a change to the program cannot
change the benchmark's inputs. Its draws are split in two:

* the geometry (lattice, positions and so the radius graph) comes from the
  mix's fixed ``geometry_seed``: the structures are the deployment's data
  set, so every run seed pads to the same shapes and does the same work;
  it is built once per checkout and cached under ``bench_h100/.cache``;
* ``--seed`` draws the rest of each record: species, temperature (the
  CSD ADP source's standardisation applied) and the ADP targets, for each
  of the pool's ``copies`` (default 1) of every structure, so that a pass
  over the records is ``copies`` times longer than the geometry pool while
  no two records are alike.

Atom counts sit at fixed mid-quantiles of N(mean, spread * mean), floored
at ``min_atoms``: the generator's own size law at the ADP mean of 194.
The atoms fill the cell at the pool's ``density`` (atoms per cubic
angstrom, hydrogens included), which with the radius sets the edges per
atom (about 4/3 pi r^3 density).
"""

from __future__ import annotations

import hashlib
import json
import os
from statistics import NormalDist
from typing import List, Optional

import numpy as np

# the CSD ADP source's train statistics (data/adp.py of the port)
TRAIN_TEMP_MEAN = 192.1785
TRAIN_TEMP_STD = 81.2135
_VERSION = 1  # bump when the geometry draws change


def atom_counts(pool: dict) -> List[int]:
    """The pool's atom counts: ``count`` mid-quantiles of the size law."""
    law = NormalDist(pool["mean_atoms"], pool["spread"] * pool["mean_atoms"])
    n = pool["count"]
    return [max(pool["min_atoms"], int(law.inv_cdf((i + 0.5) / n)))
            for i in range(n)]


def radius_graph_pbc(pos, cell, radius: float,
                     max_neighbors: Optional[int] = None):
    """Periodic radius graph (the port's numpy path): image repetitions
    from the reciprocal plane distances, 0.0001 < d^2 <= r^2, an optional
    soft per-atom cap (degeneracy tolerance 0.01 on d^2), direction
    pos[dst] - imaged pos[src] -> (src, dst, dist, unit dir)."""
    pos = np.asarray(pos, np.float64)
    cell = np.asarray(cell, np.float64)
    n = pos.shape[0]
    crosses = (np.cross(cell[1], cell[2]), np.cross(cell[2], cell[0]),
               np.cross(cell[0], cell[1]))
    vol = abs(float(np.dot(cell[0], crosses[0])))
    reps = [int(np.ceil(radius * np.linalg.norm(c) / vol)) if vol > 0 else 0
            for c in crosses]
    grids = [np.arange(-r, r + 1, dtype=np.float64) for r in reps]
    offsets = np.stack(np.meshgrid(*grids, indexing="ij"),
                       axis=-1).reshape(-1, 3) @ cell
    diff = ((pos[:, None, None, :] - pos[None, :, None, :])
            - offsets[None, None, :, :])
    d2 = np.einsum("ijcx,ijcx->ijc", diff, diff)
    dst, src, cidx = np.nonzero((d2 <= radius * radius) & (d2 > 0.0001))
    d2_e = d2[dst, src, cidx]
    dir_e = diff[dst, src, cidx]
    if max_neighbors is not None and max_neighbors > 0:
        keep = _cap(dst, d2_e, n, max_neighbors)
        dst, src, d2_e, dir_e = dst[keep], src[keep], d2_e[keep], dir_e[keep]
    dist = np.sqrt(d2_e)
    return (src.astype(np.int32), dst.astype(np.int32),
            dist.astype(np.float32),
            (dir_e / np.maximum(dist[:, None], 1e-12)).astype(np.float32))


def _cap(dst, d2, n: int, k: int, tol: float = 0.01) -> np.ndarray:
    """Per destination, every edge within ``tol`` of the k-th smallest d^2."""
    counts = np.bincount(dst, minlength=n)
    if counts.max(initial=0) <= k:
        return np.ones(len(dst), bool)
    cutoff = np.full(n, np.inf)
    order = np.lexsort((d2, dst))
    sorted_d2 = d2[order]
    starts = np.searchsorted(dst[order], np.arange(n))
    for a in np.flatnonzero(counts > k):
        cutoff[a] = sorted_d2[starts[a] + k] + tol
    return d2 <= cutoff[dst]


def _geometry_one(rng, n: int, radius: float, density: float,
                  max_neighbors: Optional[int]) -> dict:
    a = (n / density) ** (1.0 / 3.0)
    # mildly skewed lattice to exercise the PBC image logic
    cell = (np.eye(3) * a
            + rng.uniform(-0.1 * a, 0.1 * a, (3, 3)) * (1 - np.eye(3)))
    pos = rng.uniform(0, 1, (n, 3)) @ cell
    src, dst, dist, cart_dir = radius_graph_pbc(pos, cell, radius,
                                                max_neighbors)
    return {"pos": pos.astype(np.float32), "cell": cell.astype(np.float32),
            "edge_src": src, "edge_dst": dst, "cart_dist": dist,
            "cart_dir": cart_dir}


_GEOM_KEYS = ("pos", "cell", "edge_src", "edge_dst", "cart_dist",
              "cart_dir")


def geometry(pool: dict, radius: float, max_neighbors: Optional[int],
             cache_dir: Optional[str]) -> List[dict]:
    """The pool's structures from ``pool["geometry_seed"]``, read from
    ``cache_dir`` where an earlier run left them (``None``: no cache)."""
    counts = atom_counts(pool)
    key = json.dumps([_VERSION, pool["geometry_seed"], pool["density"],
                      counts, radius, max_neighbors])
    path = None
    if cache_dir:
        digest = hashlib.sha256(key.encode()).hexdigest()[:20]
        path = os.path.join(cache_dir, f"geometry_{digest}.npz")
        if os.path.isfile(path):
            with np.load(path) as f:
                arrays = {k: f[k] for k in f.files}
            off = arrays["offsets"]
            return [{k: arrays[k][off[i, j]:off[i + 1, j]] if k != "cell"
                     else arrays[k][i] for j, k in enumerate(_GEOM_KEYS)}
                    for i in range(len(counts))]
    rng = np.random.default_rng(pool["geometry_seed"])
    recs = [_geometry_one(rng, n, radius, pool["density"], max_neighbors)
            for n in counts]
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        lens = np.array([[len(r[k]) if k != "cell" else 1
                          for k in _GEOM_KEYS] for r in recs])
        offsets = np.concatenate([np.zeros((1, len(_GEOM_KEYS)), np.int64),
                                  np.cumsum(lens, axis=0)])
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, offsets=offsets,
                 cell=np.stack([r["cell"] for r in recs]),
                 **{k: np.concatenate([r[k] for r in recs])
                    for k in _GEOM_KEYS if k != "cell"})
        os.replace(tmp, path)
    return recs


def make_pool(pool: dict, radius: float, max_neighbors: Optional[int],
              seed: int, cache_dir: Optional[str] = None) -> List[dict]:
    """The pool's records for run ``seed``: cached geometry, and from the
    seed each record's species, temperature and SPD ADP targets, the
    geometry pool ``copies`` times over (the copies share its arrays)."""
    geo = geometry(pool, radius, max_neighbors, cache_dir)
    rng = np.random.default_rng([seed, 1])
    out = []
    for g in geo * pool.get("copies", 1):
        n = len(g["pos"])
        z = rng.integers(1, 84, n)
        temp = float(rng.uniform(0, 600))
        m = rng.normal(size=(n, 3, 3)) * 0.05
        y = np.einsum("nij,nkj->nik", m, m) + 0.01 * np.eye(3)[None]
        out.append({**g, "z": z.astype(np.int32),
                    "temperature": (temp - TRAIN_TEMP_MEAN) / TRAIN_TEMP_STD,
                    "y": y.astype(np.float32)})
    return out
