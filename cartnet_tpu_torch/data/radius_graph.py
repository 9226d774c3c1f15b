"""Periodic-boundary radius graph construction (host-side ETL).

The port's own copy of cartnet_tpu/data/radius_graph.py: a numpy path and
the C++ one (``cartnet_tpu_torch/native``, built with g++ at first use),
which give the same edges in the same order (dist and dir within an ulp or
two: the C++ path multiplies by 1 / dist where numpy divides). Semantics:

  * per-crystal image repetitions from reciprocal-vector plane distances;
  * all-pairs distances against the full cartesian product of image offsets;
  * keep 0.0001 < dist^2 <= radius^2 (self-pairs at identical positions drop);
  * optional soft max-neighbor cap (degeneracy tolerance 0.01 on squared
    distance);
  * edges as (src, dst) with direction pos[dst] - imaged pos[src].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def radius_graph_pbc(pos: np.ndarray, cell: np.ndarray, radius: float,
                     max_neighbors: Optional[int] = None,
                     pbc=(True, True, True), backend: str = "auto"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build the PBC radius graph of one crystal.

    ``max_neighbors``: per-atom cap (None / -1: uncapped). ``pbc``: the
    periodic axes (the C++ path takes full periodicity only). ``backend``:
    "auto" (C++ where it builds and ``pbc`` is full, else numpy, with one
    logged warning if the build fails), "numpy", or "native" (raises if
    the C++ path cannot be built).

    Returns (edge_src, edge_dst, cart_dist, cart_dir): [e], [e], [e], [e, 3];
    cart_dir is the unit vector pos[dst] - imaged_pos[src].
    """
    if backend not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown radius-graph backend {backend!r}")
    if backend != "numpy" and all(pbc):
        from cartnet_tpu_torch import native
        lib = native.load() if backend == "native" else native.get_native()
        if lib is not None:
            return native.radius_graph_pbc(
                lib, pos, cell, radius,
                int(max_neighbors) if max_neighbors else -1)
    elif backend == "native":
        raise ValueError("the native radius graph takes full periodicity")
    pos = np.asarray(pos, np.float64)
    cell = np.asarray(cell, np.float64)
    n = pos.shape[0]

    # image repetitions per axis: ceil(radius / plane distance); the plane
    # distance for a1 is 1/||(a2 x a3)/V||
    cross23 = np.cross(cell[1], cell[2])
    cross31 = np.cross(cell[2], cell[0])
    cross12 = np.cross(cell[0], cell[1])
    vol = abs(float(np.dot(cell[0], cross23)))
    reps = [int(np.ceil(radius * np.linalg.norm(cr) / vol))
            if flag and vol > 0 else 0
            for flag, cr in zip(pbc, (cross23, cross31, cross12))]

    grids = [np.arange(-r, r + 1, dtype=np.float64) for r in reps]
    offsets_frac = np.stack(np.meshgrid(*grids, indexing="ij"),
                            axis=-1).reshape(-1, 3)
    offsets = offsets_frac @ cell  # [num_cells, 3]

    # diff[i, j, c] = pos[i] - (pos[j] + offset[c]): dst i, imaged src j
    diff = ((pos[:, None, None, :] - pos[None, :, None, :])
            - offsets[None, None, :, :])
    d2 = np.einsum("ijcx,ijcx->ijc", diff, diff)

    mask = (d2 <= radius * radius) & (d2 > 0.0001)
    dst, src, cidx = np.nonzero(mask)
    d2_e = d2[dst, src, cidx]
    dir_e = diff[dst, src, cidx]

    if max_neighbors is not None and max_neighbors > 0:
        keep = _max_neighbors_mask(dst, d2_e, n, max_neighbors)
        dst, src, d2_e, dir_e = dst[keep], src[keep], d2_e[keep], dir_e[keep]

    dist = np.sqrt(d2_e)
    cart_dir = dir_e / np.maximum(dist[:, None], 1e-12)
    return (src.astype(np.int32), dst.astype(np.int32),
            dist.astype(np.float32), cart_dir.astype(np.float32))


def _max_neighbors_mask(dst: np.ndarray, d2: np.ndarray, num_atoms: int,
                        max_neighbors: int,
                        degeneracy_tolerance: float = 0.01) -> np.ndarray:
    """Keeps, per destination atom, every edge whose squared distance is
    within ``degeneracy_tolerance`` of the ``max_neighbors``-th smallest."""
    counts = np.bincount(dst, minlength=num_atoms)
    if counts.max(initial=0) <= max_neighbors:
        return np.ones(len(dst), bool)
    cutoff = np.full(num_atoms, np.inf)
    order = np.lexsort((d2, dst))
    sorted_d2 = d2[order]
    starts = np.searchsorted(dst[order], np.arange(num_atoms))
    for a in range(num_atoms):
        if counts[a] > max_neighbors:
            seg = sorted_d2[starts[a]:starts[a] + counts[a]]
            cutoff[a] = seg[max_neighbors] + degeneracy_tolerance
    return d2 <= cutoff[dst]


def brute_force_radius_graph(pos: np.ndarray, cell: np.ndarray,
                             radius: float, rep: int = 3):
    """O(n^2 * images) oracle over a fixed image cube, for tests only."""
    pos = np.asarray(pos, np.float64)
    cell = np.asarray(cell, np.float64)
    edges = []
    rng = range(-rep, rep + 1)
    for i in range(len(pos)):
        for j in range(len(pos)):
            for a in rng:
                for b in rng:
                    for c in rng:
                        off = a * cell[0] + b * cell[1] + c * cell[2]
                        diff = pos[i] - (pos[j] + off)
                        d2 = float(diff @ diff)
                        if 0.0001 < d2 <= radius * radius:
                            edges.append((j, i, np.sqrt(d2),
                                          diff / np.sqrt(d2)))
    if not edges:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32), np.zeros((0, 3), np.float32))
    src, dst, dist, dirs = zip(*edges)
    return (np.array(src, np.int32), np.array(dst, np.int32),
            np.array(dist, np.float32), np.array(dirs, np.float32))
