"""Lattice canonicalization for the iComformer (port of
cartnet_tpu/data/lattice.py; float64 numpy, bitwise the JAX package's).

Pick the three shortest non-coplanar integer combinations of the lattice
vectors (coefficients -2..2), flip each to an acute angle with the first,
make the frame right-handed, then rotate so that a1 lies along x and a2 in
the xy plane. Callers conjugate ADP targets and rotate ``cart_dir`` with the
returned rotation (``data/adp.process_adp_record``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def optimize_lattice(cell: np.ndarray, reps: int = 2,
                     tol: float = 1e-3) -> Tuple[np.ndarray, np.ndarray]:
    """-> (new_cell, rotation) with new_cell = candidate_cell @ rotation.T."""
    cell = np.asarray(cell, np.float64)
    combos = []
    for i in range(-reps, reps + 1):
        for j in range(-reps, reps + 1):
            for k in range(-reps, reps + 1):
                if i == j == k == 0:
                    continue
                combos.append(i * cell[0] + j * cell[1] + k * cell[2])
    combos = np.stack(combos)
    order = np.argsort(np.linalg.norm(combos, axis=1), kind="stable")
    cand = combos[order]

    v1 = cand[0]
    v2 = None
    i2 = 0
    for idx, v in enumerate(cand[1:]):
        if np.linalg.norm(np.cross(v1, v)) > tol:
            v2 = -v if _angle(v1, v) > np.pi / 2 else v
            # the reference keeps the enumerate index of the [1:] slice, so
            # the search for v3 starts one candidate before v2
            i2 = idx
            break
    if v2 is None:
        raise ValueError("degenerate lattice: no non-colinear combination")
    v3 = None
    for v in cand[i2:]:
        if abs(np.dot(np.cross(v1, v2), v)) > tol:
            v3 = -v if _angle(v1, v) > np.pi / 2 else v
            break
    if v3 is None:
        raise ValueError("degenerate lattice: no non-coplanar combination")

    new = np.stack([v1, v2, v3])
    if np.dot(np.cross(new[0], new[1]), new[2]) < 0:
        new = -new
    rot, new = _rotate_to_frame(new)
    return new, rot


def _angle(a, b):
    c = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return abs(np.arccos(np.clip(c, -1.0, 1.0)))


def _rotate_to_frame(lat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The rotation that puts a1 along x and a2 in the xy plane."""
    x = lat[0] / np.linalg.norm(lat[0])
    a2p = lat[1] - np.dot(lat[1], x) * x
    y = a2p / np.linalg.norm(a2p)
    z = np.cross(x, y)
    rot = np.stack([x, y, z])
    return rot, lat @ rot.T
