"""Jarvis-DFT / Materials Project (megnet) ingest with the reference's
split (the port's own copy of cartnet_tpu/data/jarvis.py; numpy only).

A plain HTTP figshare fetch and the reference loader's protocol:

  * target filter: drop entries whose target is None, "na" or NaN;
  * 80/10/10 split via ``random.seed(123); random.shuffle(ids)``, bitwise
    the reference's (and PotNet's) split: CPython's Mersenne shuffle is
    deterministic;
  * graph build: ``radius_graph_pbc`` at radius 5.0, ``max_neighbors``
    None for CartNet and 25 for the Comformers, cart_dist = |vec|,
    cart_dir = vec / |vec|.

Downloads are cached under ``<path>/raw``; where there is no network,
place the figshare JSON (``<dataset>.json``) or its zip there by hand.
The npz cache ``<path>/{name}_{radius}_{mn}_{target}_123.npz_dir`` has
the JAX package's layout and name, so either package reads a cache the
other wrote.
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
import zipfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cartnet_tpu_torch.data.elements import SYMBOL_TO_Z
from cartnet_tpu_torch.data.radius_graph import radius_graph_pbc

# figshare file ids used by jarvis-tools (jarvis.db.figshare.get_db_info)
FIGSHARE_URLS = {
    "dft_3d_2021": "https://ndownloader.figshare.com/files/28794820",
    "megnet": "https://ndownloader.figshare.com/files/26724977",
}

# megnet bulk/shear moduli ship as PRE-SPLIT pickles, not via jdata (files
# from https://figshare.com/projects/Bulk_and_shear_datasets/165430)
PICKLE_TARGETS = {"bulk modulus": "bulk", "shear modulus": "shear"}


def load_pickle_splits(target: str, path: str) -> List[List[dict]]:
    """Pre-split megnet bulk/shear pickles -> [train, val, test] raw lists.

    The three ``{bulk|shear}_megnet_{split}.pkl`` files are loaded as they
    are (the split is fixed upstream; no seed-123 reshuffle)."""
    import pickle
    prefix = PICKLE_TARGETS[target]
    out = []
    for split in ("train", "val", "test"):
        p = os.path.join(path, f"{prefix}_megnet_{split}.pkl")
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} not found — download the bulk/shear megnet pickles "
                "from https://figshare.com/projects/"
                "Bulk_and_shear_datasets/165430 into the dataset path")
        with open(p, "rb") as f:
            out.append(pickle.load(f))
    return out


# Optional integrity pins for the ~800 MB figshare archives. Populate (or
# export CARTNET_FIGSHARE_SHA256_<NAME>=<hex>) once a trusted copy has been
# hashed; None = integrity falls back to the zip CRC check + JSON parse.
FIGSHARE_SHA256 = {
    "dft_3d_2021": None,
    "megnet": None,
}

_CHUNK = 1 << 20


def _sha256(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(_CHUNK), b""):
            h.update(block)
    return h.hexdigest()


def _fetch_with_resume(url: str, dest: str) -> None:
    """Chunked streaming download with HTTP-Range resume.

    The archives are ~800 MB; a dropped connection resumes from the .part
    offset instead of restarting. The .part file is promoted to ``dest`` only after the stream
    completes AND matches the server's Content-Length."""
    import urllib.error
    import urllib.request
    part = dest + ".part"
    offset = os.path.getsize(part) if os.path.exists(part) else 0
    req = urllib.request.Request(url)
    if offset:
        req.add_header("Range", f"bytes={offset}-")
        logging.info("resuming %s at byte %d", url, offset)
    try:
        resp = urllib.request.urlopen(req, timeout=60)
    except urllib.error.HTTPError as e:
        if e.code == 416:  # range beyond EOF: .part is already complete
            os.replace(part, dest)
            return
        raise
    if offset and resp.status != 206:
        # server ignored the Range header: restart from scratch
        offset = 0
    total = resp.headers.get("Content-Length")
    expected = (offset + int(total)) if total is not None else None
    mode = "ab" if offset else "wb"
    with open(part, mode) as out:
        for block in iter(lambda: resp.read(_CHUNK), b""):
            out.write(block)
    got = os.path.getsize(part)
    if expected is not None and got != expected:
        raise IOError(
            f"incomplete download of {url}: {got} of {expected} bytes "
            f"(rerun to resume from the .part file)")
    os.replace(part, dest)


def verify_archive(name: str, zip_path: str) -> str:
    """Integrity-check a downloaded archive. Returns a status string.

    SHA256 when a pin is available (FIGSHARE_SHA256 or the
    CARTNET_FIGSHARE_SHA256_<NAME> env var), always a full zip CRC pass."""
    env_key = f"CARTNET_FIGSHARE_SHA256_{name.upper()}"
    expected = os.environ.get(env_key) or FIGSHARE_SHA256.get(name)
    status = "crc-only"
    if expected:
        got = _sha256(zip_path)
        if got.lower() != expected.lower():
            raise IOError(f"checksum mismatch for {zip_path}: "
                          f"expected {expected}, got {got}")
        status = "sha256-ok"
    with zipfile.ZipFile(zip_path) as zf:
        bad = zf.testzip()
        if bad is not None:
            raise IOError(f"corrupt archive {zip_path}: first bad member "
                          f"{bad} — delete it and re-download")
    return status


def _download(name: str, raw_dir: str) -> str:
    os.makedirs(raw_dir, exist_ok=True)
    json_path = os.path.join(raw_dir, f"{name}.json")
    if os.path.exists(json_path):
        return json_path
    url = FIGSHARE_URLS.get(name)
    if url is None:
        raise ValueError(f"unknown figshare dataset '{name}'")
    zip_path = os.path.join(raw_dir, f"{name}.zip")
    if not os.path.exists(zip_path):
        # zero-egress environments: place either <name>.json or <name>.zip
        # under <path>/raw and the download is skipped
        logging.info("downloading %s from %s", name, url)
        _fetch_with_resume(url, zip_path)
    status = verify_archive(name, zip_path)
    logging.info("archive %s integrity: %s", zip_path, status)
    with zipfile.ZipFile(zip_path) as zf:
        member = zf.namelist()[0]
        with zf.open(member) as f, open(json_path, "wb") as out:
            for block in iter(lambda: f.read(_CHUNK), b""):
                out.write(block)
    return json_path


def load_raw(name: str, path: str) -> List[dict]:
    """Load (download if needed) the raw figshare JSON list of dicts."""
    if name == "jarvis":
        name = "dft_3d_2021"  # the reference loader's rename
    json_path = _download(name, os.path.join(path, "raw"))
    with open(json_path) as f:
        return json.load(f)


def filter_by_target(data: Sequence[dict], target: str):
    """Keep entries with a usable target (the reference loader's rule)."""
    dat, targets = [], []
    for item in data:
        v = item.get(target)
        if isinstance(v, list):
            targets.append(np.asarray(v, np.float32))
            dat.append(item)
        elif v is not None and v != "na" and not (
                isinstance(v, float) and math.isnan(v)):
            dat.append(item)
            targets.append(float(v))
    return dat, targets


def split_123(n: int, val_ratio: float = 0.1, test_ratio: float = 0.1,
              seed: int = 123) -> Tuple[List[int], List[int], List[int]]:
    """The PotNet comparative-table split, exactly."""
    ids = list(np.arange(n))
    n_val = int(n * val_ratio)
    n_test = int(n * test_ratio)
    n_train = n - n_val - n_test
    random.seed(seed)
    random.shuffle(ids)
    return (ids[:n_train], ids[-(n_val + n_test):-n_test], ids[-n_test:])


def atoms_to_record(atoms: dict, target, radius: float = 5.0,
                    max_neighbors: Optional[int] = None,
                    backend: str = "auto") -> dict:
    """jarvis Atoms dict -> GraphRecord. ``backend`` picks the radius
    graph's builder (``radius_graph_pbc``)."""
    lattice = np.asarray(atoms["lattice_mat"], np.float64)
    coords = np.asarray(atoms["coords"], np.float64)
    if not atoms.get("cartesian", True):
        coords = coords @ lattice
    z = np.asarray([SYMBOL_TO_Z[s] for s in atoms["elements"]], np.int32)
    src, dst, dist, cart_dir = radius_graph_pbc(coords, lattice, radius,
                                                max_neighbors,
                                                backend=backend)
    return {"z": z, "pos": coords.astype(np.float32),
            "cell": lattice.astype(np.float32),
            "edge_src": src, "edge_dst": dst,
            "cart_dist": dist, "cart_dir": cart_dir,
            "y": target}


def build_dataset(name: str, target: str, path: str, radius: float = 5.0,
                  max_neighbors: Optional[int] = None,
                  limit: Optional[int] = None, backend: str = "auto"):
    """Full pipeline -> (train, val, test) lists of GraphRecords, cached.
    ``limit`` cuts the splits to (limit, limit // 8, limit // 8), at least
    one each."""
    mn = max_neighbors if (max_neighbors or 0) > 0 else None
    cache = os.path.join(
        path,
        f"{name}_{radius}_{mn or -1}_{target.replace(' ', '_')}_123.npz_dir")
    if os.path.isdir(cache):
        return tuple(_load_split(os.path.join(cache, s))
                     for s in ("train", "val", "test"))
    if name == "megnet" and target in PICKLE_TARGETS:
        # pre-split pickles, the same usable-target filter per split, no
        # seed-123 reshuffle
        per_split = []
        for raw in load_pickle_splits(target, path):
            dat, targets = filter_by_target(raw, target)
            per_split.append((dat, targets))
        split_ids = [list(range(len(d))) for d, _ in per_split]
    else:
        data = load_raw(name, path)
        dat, targets = filter_by_target(data, target)
        tr, va, te = split_123(len(dat))
        per_split = [(dat, targets)] * 3
        split_ids = [tr, va, te]
    if limit:
        lims = (limit, max(limit // 8, 1), max(limit // 8, 1))
        split_ids = [ids[:k] for ids, k in zip(split_ids, lims)]
    splits = []
    for (dat, targets), ids in zip(per_split, split_ids):
        recs = [atoms_to_record(dat[i]["atoms"], targets[i], radius, mn,
                                backend) for i in ids]
        splits.append(recs)
    for sname, recs in zip(("train", "val", "test"), splits):
        _save_split(os.path.join(cache, sname), recs)
    return tuple(splits)


def _save_split(dirname: str, recs: List[dict]):
    os.makedirs(dirname, exist_ok=True)
    flat = {}
    for i, r in enumerate(recs):
        for k, v in r.items():
            flat[f"{i}_{k}"] = v
    np.savez_compressed(os.path.join(dirname, "data.npz"),
                        __count=len(recs), **flat)


def _load_split(dirname: str) -> List[dict]:
    with np.load(os.path.join(dirname, "data.npz")) as z:
        n = int(z["__count"])
        return [{k: z[f"{i}_{k}"] for k in
                 ("z", "pos", "cell", "edge_src", "edge_dst",
                  "cart_dist", "cart_dir", "y")} for i in range(n)]
