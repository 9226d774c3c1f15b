"""CSD -> graph ETL math (port of cartnet_tpu/data/csd_etl.py; numpy,
bitwise the JAX package's).

The reference ETL drives the licensed CCDC ``ccdc`` API, which is out of
scope; what it computes on the structures it reads is here, so that
pre-extracted structures from any source become records with the same
conventions:

  * ``frac_to_cart_matrix``: cell parameters -> lattice matrix (rows are
    lattice vectors);
  * ``adp_cif_to_cart``: CIF-convention ADPs -> Cartesian,
    U_cart = Aᵀ·(Nᵀ·U_cif·N)·A with N = diag(‖(A⁻¹)ᵀ_i‖);
  * ``isotropic_adp``: the H-atom fallback U = u_iso·I;
  * ``dedup_positions``: keep-first removal of repeated coordinates;
  * ``structure_to_record``: a record with the production radius graph
    (radius 5.0, uncapped).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from cartnet_tpu_torch.data.radius_graph import radius_graph_pbc


def frac_to_cart_matrix(a, b, c, alpha, beta, gamma) -> np.ndarray:
    """Lattice matrix (rows = lattice vectors) from cell parameters
    (angles in degrees)."""
    al, be, ga = np.radians([alpha, beta, gamma])
    v = math.sqrt(1 - math.cos(al) ** 2 - math.cos(be) ** 2
                  - math.cos(ga) ** 2
                  + 2 * math.cos(al) * math.cos(be) * math.cos(ga))
    m = np.array([
        [a, b * math.cos(ga), c * math.cos(be)],
        [0, b * math.sin(ga),
         c * (math.cos(al) - math.cos(be) * math.cos(ga)) / math.sin(ga)],
        [0, 0, c * v / math.sin(ga)],
    ])
    return m.T


def adp_cif_to_cart(u_cif: np.ndarray, cell: np.ndarray) -> np.ndarray:
    """CIF-convention ADP ([3, 3] or [n, 3, 3]) -> Cartesian, for a cell
    with lattice vectors as rows."""
    u_cif = np.asarray(u_cif, np.float64)
    cell = np.asarray(cell, np.float64)
    recip = np.linalg.inv(cell).T
    n = np.diag(np.linalg.norm(recip, axis=1))
    inner = n.T @ u_cif @ n if u_cif.ndim == 2 else np.einsum(
        "ij,njk,kl->nil", n.T, u_cif, n)
    if u_cif.ndim == 2:
        return cell.T @ inner @ cell
    return np.einsum("ij,njk,kl->nil", cell.T, inner, cell)


def isotropic_adp(u_iso: float) -> np.ndarray:
    """H atoms carry an isotropic U = u_iso·I."""
    return u_iso * np.eye(3)


def dedup_positions(pos: np.ndarray, tol: float = 1e-4) -> np.ndarray:
    """Indices of the unique atom positions, the first of each kept."""
    keep = []
    seen: list = []
    for i, p in enumerate(pos):
        if not any(np.allclose(p, q, atol=tol) for q in seen):
            keep.append(i)
            seen.append(p)
    return np.asarray(keep, np.int64)


def structure_to_record(z: np.ndarray, pos: np.ndarray, cell: np.ndarray,
                        u_cart: np.ndarray, temperature: float,
                        radius: float = 5.0,
                        max_neighbors: Optional[int] = None) -> dict:
    """The record of one ADP structure (the radius graph's default
    backend, as the JAX package's)."""
    src, dst, dist, cart_dir = radius_graph_pbc(pos, cell, radius,
                                                max_neighbors)
    return {"z": np.asarray(z, np.int32), "pos": np.asarray(pos, np.float32),
            "cell": np.asarray(cell, np.float32),
            "edge_src": src, "edge_dst": dst,
            "cart_dist": dist, "cart_dir": cart_dir,
            "y": np.asarray(u_cart, np.float32),
            "temperature": float(temperature)}
