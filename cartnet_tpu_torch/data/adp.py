"""ADP record transforms (port of ``augment_record`` of
cartnet_tpu/data/adp.py).

Host-side numpy, bitwise the JAX package's for the same
``np.random.Generator`` state: one rotation from four normals, an f32
matrix, ``cart_dir @ R`` and ``cell @ R``, and Rᵀ U R on per-atom ADP
targets when ``rotate_targets`` is set. The CSD loader (``ADPDataset``,
``LazyRecords``, ``remove_hydrogens``) is not ported yet (ROADMAP P2b).
"""

from __future__ import annotations

import numpy as np


def augment_record(rec: dict, rng: np.random.Generator,
                   rotate_targets: bool = True) -> dict:
    """A copy of ``rec`` rotated by a uniform random R (the reference's
    SO(3) augmentation)."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    out = dict(rec)
    out["cart_dir"] = rec["cart_dir"] @ R
    out["cell"] = rec["cell"] @ R
    if rotate_targets and np.ndim(rec["y"]) == 3:
        out["y"] = np.einsum("ji,njk,kl->nil", R, rec["y"], R).astype(
            np.float32)
    return out
