"""Synthetic crystal generator (port of cartnet_tpu/data/synthetic.py).

Same numpy draws in the same order, so a seed gives the same records as the
JAX package: random periodic structures with the ADP size distribution
(~194 atoms per crystal) and their radius graphs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from cartnet_tpu_torch.data.radius_graph import radius_graph_pbc


def random_crystal(rng: np.random.Generator, n_atoms: int, radius: float = 5.0,
                   adp: bool = False, density: float = 0.045,
                   max_neighbors: Optional[int] = None) -> dict:
    """One random crystal record. density = atoms per cubic angstrom."""
    vol = n_atoms / density
    a = vol ** (1.0 / 3.0)
    # mildly skewed lattice to exercise the PBC image logic
    cell = (np.eye(3) * a
            + rng.uniform(-0.1 * a, 0.1 * a, (3, 3)) * (1 - np.eye(3)))
    frac = rng.uniform(0, 1, (n_atoms, 3))
    pos = frac @ cell
    z = rng.integers(1, 84, n_atoms)
    src, dst, dist, cart_dir = radius_graph_pbc(pos, cell, radius,
                                                max_neighbors,
                                                backend="numpy")
    rec = {
        "z": z.astype(np.int32), "pos": pos.astype(np.float32),
        "cell": cell.astype(np.float32),
        "edge_src": src, "edge_dst": dst,
        "cart_dist": dist, "cart_dir": cart_dir,
        "temperature": float(rng.uniform(0, 600)),
    }
    if adp:
        # random SPD 3x3 per atom, ellipsoid-scaled like real ADPs (~1e-2 A^2)
        m = rng.normal(size=(n_atoms, 3, 3)) * 0.05
        rec["y"] = (np.einsum("nij,nkj->nik", m, m)
                    + 0.01 * np.eye(3)[None]).astype(np.float32)
    else:
        rec["y"] = float(rng.normal())
    return rec


def learnable_adp_y(z, src, dst, dist, cart_dir, temperature: float,
                    radius: float) -> np.ndarray:
    """Deterministic, SO(3)-equivariant ADP ground truth:
    U_i = s_i (0.004 I + 0.012 M_i), M_i = sum_j w_ij r_ij r_ij^T / sum_j w_ij,
    w_ij = (1 - d_ij/r_c)^2, s_i = (0.3 + T/600) / sqrt(Z_i)."""
    n = len(z)
    w = (1.0 - dist / radius) ** 2
    outer = cart_dir[:, :, None] * cart_dir[:, None, :]
    M = np.zeros((n, 3, 3))
    np.add.at(M, dst, w[:, None, None] * outer)
    wsum = np.zeros(n)
    np.add.at(wsum, dst, w)
    M = M / np.maximum(wsum, 1e-6)[:, None, None]
    s = (0.3 + temperature / 600.0) / np.sqrt(z.astype(np.float64))
    U = s[:, None, None] * (0.004 * np.eye(3)[None] + 0.012 * M)
    return U.astype(np.float32)


def synthetic_dataset(num: int, mean_atoms: int = 194, radius: float = 5.0,
                      adp: bool = False, seed: int = 0,
                      max_neighbors: Optional[int] = None) -> List[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        n = max(4, int(rng.normal(mean_atoms, mean_atoms * 0.3)))
        out.append(random_crystal(rng, n, radius, adp,
                                  max_neighbors=max_neighbors))
    return out
