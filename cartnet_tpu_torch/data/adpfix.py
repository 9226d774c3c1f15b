"""The frozen learnable-ADP fixture ("adpfix"; port of the loader of
cartnet_tpu/data/adpfix.py).

240 random periodic crystals whose per-atom ADP targets follow a fixed,
SO(3)-equivariant, temperature- and Z-dependent rule that a model must
learn. The port keeps its own byte-for-byte copy of the JAX package's
``adpfix.npz`` (structures, temperatures and targets; the npz is the source
of truth) and rebuilds the radius-5 graphs with ``data/radius_graph.py``.
Split by position: 200 train, 20 val, 20 test. Temperatures are
standardized with the reference's ADP train statistics unless
``standarize_temp`` is off.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from cartnet_tpu_torch.data.radius_graph import radius_graph_pbc

FIXTURE_PATH = os.path.join(os.path.dirname(__file__), "fixtures",
                            "adpfix.npz")
TEMP_MEAN, TEMP_STD = 192.1785, 81.2135
N_TRAIN, N_VAL, N_TEST = 200, 20, 20
RADIUS = 5.0


def load_fixture(path: str = FIXTURE_PATH, standarize_temp: bool = True,
                 limit=None) -> Tuple[List[dict], List[dict], List[dict]]:
    """The frozen structures with rebuilt graphs -> (train, val, test);
    ``limit`` keeps the first ``limit`` train records and
    ``max(limit // 4, 2)`` of val and test."""
    with np.load(path) as f:
        recs = []
        for i in range(int(f["num"])):
            pos = f[f"pos_{i}"].astype(np.float64)
            cell = f[f"cell_{i}"].astype(np.float64)
            temp = float(f[f"temperature_{i}"])
            src, dst, dist, cart_dir = radius_graph_pbc(pos, cell, RADIUS,
                                                        backend="numpy")
            t_in = ((temp - TEMP_MEAN) / TEMP_STD) if standarize_temp \
                else temp
            recs.append({
                "z": f[f"z_{i}"].astype(np.int32),
                "pos": pos.astype(np.float32), "cell": f[f"cell_{i}"],
                "edge_src": src, "edge_dst": dst, "cart_dist": dist,
                "cart_dir": cart_dir, "temperature": t_in,
                "y": f[f"y_{i}"]})
    train = recs[:N_TRAIN]
    val = recs[N_TRAIN:N_TRAIN + N_VAL]
    test = recs[N_TRAIN + N_VAL:]
    if limit:
        k = max(limit // 4, 2)
        train, val, test = train[:limit], val[:k], test[:k]
    return train, val, test
