"""The CSD ADP source: per-refcode ``.pt`` graphs -> records (port of
cartnet_tpu/data/adp.py; host-side numpy, bitwise the JAX package's).

Each refcode of a split's csv names one reference-format ``.pt`` under the
data root (``x`` atom numbers, ``pos``, ``cell``, ``edge_index``,
``cart_dist``, ``cart_dir``, ``y`` the per-atom ADPs, ``temperature``; the
real CSD files are PyG ``Data`` pickles, so reading them needs
``torch_geometric`` installed). A record is processed as the reference
processes it:

  * the temperature standardized with the reference's train statistics
    (``TRAIN_TEMP_MEAN/STD``) unless ``standarize_temp`` is off;
  * with ``hydrogens`` off, H atoms and their edges dropped and the edges
    re-indexed (``remove_hydrogens``);
  * for the iComformer (``optimize_cell``), the lattice canonicalized
    (``data/lattice.py``), y conjugated and cart_dir rotated;
  * for the Comformers (``max_neighbors`` > 0), the edges rebuilt under the
    neighbour cap from the raw graph (``re_edge_record``), cached per
    refcode in a ``data_<k>_<radius>`` directory beside the data root;
  * SO(3) augmentation (``augment_record``): one rotation from four
    normals, ``cart_dir @ R``, ``cell @ R`` and Rᵀ U R on per-atom ADP
    targets, drawn at batch time by the pipeline.

``LazyRecords`` is the memory-bounded view a pipeline iterates: records load
on ``__getitem__``; ``counts()`` sizes the pads from a sidecar file
``sizes_h<H>_k<k>_r<radius>_<csv>.npy`` beside the data root, written by the
first scan and read by either package.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from cartnet_tpu_torch.data.lattice import optimize_lattice

TRAIN_TEMP_MEAN = 192.1785
TRAIN_TEMP_STD = 81.2135


def load_refcodes(csv_path: str) -> List[str]:
    with open(csv_path) as f:
        return [line.strip() for line in f if line.strip()]


def load_pt_raw(path: str) -> dict:
    """One reference-format ``.pt`` graph, unprocessed."""
    import torch
    data = torch.load(path, map_location="cpu", weights_only=False)
    return {
        "z": np.asarray(data.x, np.int32).reshape(-1),
        "pos": np.asarray(data.pos, np.float32),
        "cell": np.asarray(data.cell, np.float32).reshape(3, 3),
        "edge_src": np.asarray(data.edge_index[0], np.int64),
        "edge_dst": np.asarray(data.edge_index[1], np.int64),
        "cart_dist": np.asarray(data.cart_dist, np.float32).reshape(-1),
        "cart_dir": np.asarray(data.cart_dir, np.float32),
        "y": np.asarray(data.y, np.float32),
        "temperature": float(np.asarray(data.temperature).reshape(-1)[0]),
    }


def load_pt_record(path: str, standarize_temp: bool = True,
                   hydrogens: bool = True, optimize_cell: bool = False) -> dict:
    """One reference-format ``.pt`` graph as a processed record."""
    return process_adp_record(load_pt_raw(path), standarize_temp, hydrogens,
                              optimize_cell)


def re_edge_record(rec: dict, radius: float, max_neighbors: int) -> dict:
    """The record with its edges rebuilt under a per-atom neighbour cap,
    from the raw (pre-H-removal) graph: the reference's Comformer-on-ADP
    re-edging."""
    from cartnet_tpu_torch.data.radius_graph import radius_graph_pbc
    src, dst, dist, cart_dir = radius_graph_pbc(
        rec["pos"].astype(np.float64), rec["cell"].astype(np.float64),
        radius, max_neighbors, backend="numpy")
    out = dict(rec)
    out["edge_src"] = src.astype(np.int64)
    out["edge_dst"] = dst.astype(np.int64)
    out["cart_dist"] = dist.astype(np.float32)
    out["cart_dir"] = cart_dir.astype(np.float32)
    return out


def process_adp_record(rec: dict, standarize_temp: bool = True,
                       hydrogens: bool = True,
                       optimize_cell: bool = False) -> dict:
    rec = dict(rec)
    rec["temperature_og"] = rec["temperature"]
    if standarize_temp:
        rec["temperature"] = (rec["temperature"] - TRAIN_TEMP_MEAN) \
            / TRAIN_TEMP_STD
    if not hydrogens:
        rec = remove_hydrogens(rec)
    if optimize_cell:
        new_cell, rot = optimize_lattice(rec["cell"])
        rec["cell_og"] = rec["cell"]
        rec["cell"] = new_cell.astype(np.float32)
        # the reference's quirk, kept: cart_dir @ R and y -> RᵀyR, although
        # the cell itself was rotated with @ Rᵀ; dir and y stay consistent
        # with each other, the cell frame does not
        rot32 = rot.astype(np.float32)
        rec["cart_dir"] = rec["cart_dir"] @ rot32
        rec["y"] = np.einsum("ji,njk,kl->nil", rot32, rec["y"],
                             rot32).astype(np.float32)
    return rec


def remove_hydrogens(rec: dict) -> dict:
    """Drops H atoms (z = 1) and their edges, re-indexing the rest."""
    keep = rec["z"] != 1
    new_index = np.cumsum(keep) - 1  # old -> new position
    e_keep = keep[rec["edge_src"]] & keep[rec["edge_dst"]]
    out = dict(rec)
    out["z"] = rec["z"][keep]
    out["pos"] = rec["pos"][keep]
    out["edge_src"] = new_index[rec["edge_src"][e_keep]]
    out["edge_dst"] = new_index[rec["edge_dst"][e_keep]]
    out["cart_dist"] = rec["cart_dist"][e_keep]
    out["cart_dir"] = rec["cart_dir"][e_keep]
    if np.ndim(rec["y"]) == 3:
        out["y"] = rec["y"][keep]
    return out


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


class ADPDataset:
    """The records of one split: ``<root>/<refcode>.pt`` for each refcode
    of ``refcodes_csv``, loaded and processed on ``get``.

    ``max_neighbors`` > 0 rebuilds every record's edges under that cap
    before any processing, cached per refcode as ``<refcode>.npz`` in
    ``data_<k>_<radius>`` beside ``root``."""

    def __init__(self, root: str, refcodes_csv: str, standarize_temp=True,
                 hydrogens=True, augment=False, optimize_cell=False,
                 max_neighbors: Optional[int] = None, radius: float = 5.0):
        self.root = root
        self.refcodes = load_refcodes(refcodes_csv)
        self.standarize_temp = standarize_temp
        self.hydrogens = hydrogens
        self.augment = augment
        self.optimize_cell = optimize_cell
        self._csv_name = os.path.splitext(os.path.basename(refcodes_csv))[0]
        self.max_neighbors = (max_neighbors if max_neighbors
                              and max_neighbors > 0 else None)
        self.radius = radius
        if self.max_neighbors:
            self.knn_dir = os.path.join(
                os.path.dirname(os.path.normpath(root)) or ".",
                f"data_{self.max_neighbors}_{radius}")
            os.makedirs(self.knn_dir, exist_ok=True)

    def __len__(self):
        return len(self.refcodes)

    def _load_raw(self, refcode: str) -> dict:
        rec = load_pt_raw(os.path.join(self.root, refcode + ".pt"))
        if not self.max_neighbors:
            return rec
        cache = os.path.join(self.knn_dir, refcode + ".npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                rec.update({k: z[k] for k in ("edge_src", "edge_dst",
                                              "cart_dist", "cart_dir")})
            return rec
        rec = re_edge_record(rec, self.radius, self.max_neighbors)
        np.savez(cache, edge_src=rec["edge_src"], edge_dst=rec["edge_dst"],
                 cart_dist=rec["cart_dist"], cart_dir=rec["cart_dir"])
        return rec

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        rec = process_adp_record(self._load_raw(self.refcodes[idx]),
                                 self.standarize_temp, self.hydrogens,
                                 self.optimize_cell)
        if self.augment and rng is not None:
            rec = augment_record(rec, rng)
        return rec


class LazyRecords:
    """A sequence of records over an ``ADPDataset`` (the first ``limit``),
    each loaded on ``__getitem__``; never the whole split in memory."""

    def __init__(self, dataset: ADPDataset, limit: Optional[int] = None):
        self.dataset = dataset
        self.n = len(dataset) if limit is None else min(limit, len(dataset))

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> dict:
        if not (0 <= idx < self.n):
            raise IndexError(idx)
        return self.dataset.get(idx)

    def sidecar_path(self) -> str:
        """The sizes file beside the data root, under the JAX name."""
        ds = self.dataset
        tag = (f"sizes_h{int(ds.hydrogens)}_k{ds.max_neighbors or -1}"
               f"_r{ds.radius}")
        return os.path.join(os.path.dirname(os.path.normpath(ds.root))
                            or ".", f"{tag}_{ds._csv_name}.npy")

    def counts(self):
        """(node_counts, edge_counts) for pad sizing: from the sidecar when
        it covers the records, else from one scan, which writes it."""
        cache = self.sidecar_path()
        if os.path.exists(cache):
            arr = np.load(cache)
            if len(arr) >= self.n:
                return arr[:self.n, 0], arr[:self.n, 1]
        arr = np.zeros((self.n, 2), np.int64)
        for i in range(self.n):
            rec = self.dataset.get(i)
            arr[i] = (len(rec["z"]), len(rec["edge_src"]))
        try:
            np.save(cache, arr)
        except OSError:  # a read-only data directory: sized, not cached
            pass
        return arr[:, 0], arr[:, 1]
