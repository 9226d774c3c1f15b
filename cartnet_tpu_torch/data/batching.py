"""Static-shape batch collation (port of cartnet_tpu/data/batching.py).

Variable crystals become one padded, dst-sorted CrystalBatch. The TPU window
plans of the reference (band base rows, src bands, Pallas gates) are not
carried over: the Hopper kernels gather rows by index and segment on the
CSR offsets ``dst_rowptr`` computed here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from cartnet_tpu_torch import tracing
from cartnet_tpu_torch.data.schema import CrystalBatch

# per-graph edge alignment of ADP-scale batches (the reference's edge window)
EDGE_ALIGN = 512
# the edge kernels' tile (ops/kernels/edge_kernels.TILE_EDGES), the unit of
# collate's tile counters
EDGE_TILE = 64


def bandwidth_reorder(record: dict) -> dict:
    """Relabel one crystal's atoms in reverse Cuthill-McKee order.

    Exact host-side relabeling (model outputs are permutation-equivariant)
    that clusters each dst's src ids near it; kept so that the port sees the
    same atom order as the reference pipeline.
    """
    n = len(record["z"])
    src = np.asarray(record["edge_src"])
    dst = np.asarray(record["edge_dst"])
    if n < 16 or len(src) == 0:
        return record
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    # bool data: RCM only consults sparsity structure, and PBC graphs can
    # carry >127 parallel edges per atom pair (int8 sum would wrap)
    a = sp.coo_matrix((np.ones(len(src), bool), (dst, src)),
                      shape=(n, n)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=False),
                      np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    out = dict(record)
    out["z"] = np.asarray(record["z"])[perm]
    out["pos"] = np.asarray(record["pos"])[perm]
    y = np.asarray(record["y"])
    # per-atom targets (ADP [n,3,3]) ride with their atom
    if y.ndim >= 2 and y.shape[0] == n:
        out["y"] = y[perm]
    out["edge_src"] = inv[src]
    out["edge_dst"] = inv[dst]
    return out


def collate(records: Sequence[dict], max_nodes: int, max_edges: int,
            max_graphs: int, adp: Optional[bool] = None,
            edge_align: int = 0) -> CrystalBatch:
    """Concatenate structures into one padded, dst-sorted batch.

    ``edge_align`` > 0: pad each graph's (dst-sorted) edge segment up to a
    multiple of edge_align with masked edges pointing at the graph's last
    node, so the dst ids stay monotone. Tail pad edges point at the last
    node for the same reason.

    While the tracer records, counts the batch's ``EDGE_TILE``-edge tiles
    (``batch.edge_tiles``) and those up to its tail of pads
    (``batch.edge_tiles_live``: through the last masked-in edge, the tiles
    the edge kernels compute; ``edge_kernels.live_edges``).
    """
    g = len(records)
    if g > max_graphs:
        raise ValueError(f"{g} graphs > max_graphs={max_graphs}")
    if adp is None:
        adp = np.ndim(records[0]["y"]) == 3

    z = np.zeros(max_nodes, np.int32)
    pos = np.zeros((max_nodes, 3), np.float32)
    graph_id = np.zeros(max_nodes, np.int32)
    node_mask = np.zeros(max_nodes, bool)
    non_h = np.zeros(max_nodes, bool)
    cell = np.tile(np.eye(3, dtype=np.float32), (max_graphs, 1, 1))
    temp = np.zeros(max_graphs, np.float32)
    graph_mask = np.zeros(max_graphs, bool)
    y = (np.zeros((max_nodes, 3, 3), np.float32) if adp
         else np.zeros(max_graphs, np.float32))

    srcs, dsts, dists, dirs, masks = [], [], [], [], []
    n_off = 0
    for gi, r in enumerate(records):
        n = len(r["z"])
        if n_off + n > max_nodes:
            raise ValueError(f"node overflow: {n_off + n} > {max_nodes}")
        sl = slice(n_off, n_off + n)
        z[sl] = r["z"]
        pos[sl] = r["pos"]
        graph_id[sl] = gi
        node_mask[sl] = True
        non_h[sl] = np.asarray(r["z"]) != 1
        cell[gi] = r["cell"]
        temp[gi] = float(r.get("temperature", 0.0))
        graph_mask[gi] = True
        if adp:
            y[sl] = r["y"]
        else:
            y[gi] = float(r["y"])
        g_src = np.asarray(r["edge_src"], np.int64) + n_off
        g_dst = np.asarray(r["edge_dst"], np.int64) + n_off
        # per-graph dst sort (the concatenation stays globally sorted since
        # node offsets increase)
        order = np.argsort(g_dst, kind="stable")
        g_src, g_dst = g_src[order], g_dst[order]
        g_dist = np.asarray(r["cart_dist"], np.float32)[order]
        g_dir = np.asarray(r["cart_dir"], np.float32)[order]
        g_mask = np.ones(len(g_src), bool)
        if edge_align:
            pad = (-len(g_src)) % edge_align
            if pad:
                safe = n_off + n - 1  # last node of THIS graph: ids monotone
                g_src = np.concatenate([g_src, np.full(pad, safe, np.int64)])
                g_dst = np.concatenate([g_dst, np.full(pad, safe, np.int64)])
                g_dist = np.concatenate([g_dist, np.zeros(pad, np.float32)])
                g_dir = np.concatenate([g_dir,
                                        np.zeros((pad, 3), np.float32)])
                g_mask = np.concatenate([g_mask, np.zeros(pad, bool)])
        srcs.append(g_src)
        dsts.append(g_dst)
        dists.append(g_dist)
        dirs.append(g_dir)
        masks.append(g_mask)
        n_off += n

    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    dist = (np.concatenate(dists).astype(np.float32) if dists
            else np.zeros(0, np.float32))
    dire = (np.concatenate(dirs).astype(np.float32) if dirs
            else np.zeros((0, 3), np.float32))
    mask = np.concatenate(masks) if masks else np.zeros(0, bool)
    e = len(src)
    if e > max_edges:
        raise ValueError(f"edge overflow: {e} > {max_edges}")

    esrc = np.full(max_edges, max_nodes - 1, np.int32)
    edst = np.full(max_edges, max_nodes - 1, np.int32)
    edist = np.zeros(max_edges, np.float32)
    edir = np.zeros((max_edges, 3), np.float32)
    emask = np.zeros(max_edges, bool)
    esrc[:e] = src
    edst[:e] = dst
    edist[:e] = dist
    edir[:e] = dire
    emask[:e] = mask
    if tracing.recording():
        real = np.flatnonzero(mask)
        n_live = int(real[-1]) + 1 if real.size else 0
        tracing.count("batch.edge_tiles", -(-max_edges // EDGE_TILE))
        tracing.count("batch.edge_tiles_live", -(-n_live // EDGE_TILE))
    src_perm = np.argsort(esrc, kind="stable").astype(np.int32)
    rows = np.arange(max_nodes + 1)
    rowptr = np.searchsorted(edst, rows, side="left").astype(np.int32)
    src_sorted = esrc[src_perm]
    return CrystalBatch(
        z=z, pos=pos, graph_id=graph_id, node_mask=node_mask,
        non_h_mask=non_h, edge_src=esrc, edge_dst=edst, cart_dir=edir,
        cart_dist=edist, edge_mask=emask, cell=cell, temperature=temp,
        graph_mask=graph_mask, y=y, dst_rowptr=rowptr,
        src_rowptr=np.searchsorted(src_sorted, rows,
                                   side="left").astype(np.int32),
        edge_src_perm=src_perm, edge_src_sorted=src_sorted,
        edge_mask_src_sorted=emask[src_perm],
        src_degree=np.bincount(esrc[emask],
                               minlength=max_nodes).astype(np.float32))


def make_batches(records: Sequence[dict], batch_size: int,
                 node_multiple: int = 128,
                 edge_multiple: int = 512) -> List[CrystalBatch]:
    """Consecutive groups of ``batch_size`` records, collated to one static
    shape: the worst group's nodes rounded up to ``node_multiple`` and edges
    to ``edge_multiple``. ADP-scale data (mean >= 2 * EDGE_ALIGN edges per
    crystal) is RCM-relabeled and per-graph edge-aligned, as the reference
    pipeline does."""
    edges = np.array([len(r["edge_src"]) for r in records])
    align = EDGE_ALIGN if len(edges) and edges.mean() >= 2 * EDGE_ALIGN else 0
    if align:
        records = [bandwidth_reorder(r) for r in records]
    groups = [records[i:i + batch_size]
              for i in range(0, len(records), batch_size)]
    rnd = lambda v, m: -(-v // m) * m
    need_n = max(sum(len(r["z"]) for r in g) for g in groups)
    need_e = max(sum(rnd(len(r["edge_src"]), align) if align
                     else len(r["edge_src"]) for r in g) for g in groups)
    max_nodes = rnd(max(need_n, 1), node_multiple)
    max_edges = rnd(max(need_e, 1), edge_multiple)
    return [collate(g, max_nodes, max_edges, batch_size, edge_align=align)
            for g in groups]


def all_masked(batch: CrystalBatch) -> CrystalBatch:
    """``batch`` with every mask off: it adds nothing to a loss, a BN
    moment or a gradient, and keeps valid indices for the kernels (a
    short data-parallel group's pad member, a fused chunk's pad step)."""
    off = lambda a: None if a is None else np.zeros_like(a)
    return dataclasses.replace(
        batch, node_mask=off(batch.node_mask),
        non_h_mask=off(batch.non_h_mask), edge_mask=off(batch.edge_mask),
        graph_mask=off(batch.graph_mask),
        edge_mask_src_sorted=off(batch.edge_mask_src_sorted),
        src_degree=off(batch.src_degree))
