"""One ep member's share of a dp slice's batch (port of
cartnet_tpu/parallel/step.py's ``stack_for_shards`` and of the loss
partition of its ``_build_forward_loss``).

Edge parallelism (``--ep P``): the nodes of a dp slice are copied to
every member, and member m holds the contiguous slice
``[m E/P, (m+1) E/P)`` of the slice's dst-sorted edges (``ep_member``).
The port rebuilds the kernels' plans over that slice alone:

  * ``dst_rowptr`` clipped to the slice, so a node whose in-edges cross a
    cut has a partial row on each side (the partial aggregates are summed
    over the members in the models);
  * a src plan over the slice: ``edge_src_perm``, ``edge_src_sorted``,
    ``src_rowptr`` and ``edge_mask_src_sorted``. The JAX package drops its
    src plans for ep > 1 and scatters with XLA there; the port keeps them,
    so the sorted gathers' backward and the scatter onto sources stay the
    CSR kernel (K3), with no float atomics;
  * ``src_degree`` stays the dp slice's: the eComformer's scatter-mean
    onto sources divides the members' summed partials by it (the global
    count).

Halo partitioning (``--halo``, parallel/halo.py) lays the slice out
member-major first; ``halo_member`` cuts member m's block and builds the
same plans over its node block (dst) and its table ``[local ‖ received]``
(src).

The loss partition (``partition_loss``): every member predicts the same
nodes (ep), so element i of the prediction's mask (the non-H node mask of
ADP targets, the graph mask of scalar targets) goes to member ``i mod P``
alone; the members' loss sums, weights and eval values are then disjoint,
and their sums over the ranks are the dp slice's. Under halo with node
targets each member owns its nodes, which is already disjoint, and the
mask is kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cartnet_tpu_torch.data.schema import CrystalBatch

EDGE_FIELDS = ("edge_src", "edge_dst", "cart_dir", "cart_dist", "edge_mask")
NODE_FIELDS = ("z", "pos", "graph_id", "node_mask", "non_h_mask")


def pad_multiples(ep: int) -> tuple:
    """(node, edge) pad multiples of an ep-way split (the JAX runner's):
    member node blocks stay 8-row aligned and member edge slices hold whole
    512-edge windows, so each member's E / ep is a multiple of the edge
    kernels' 64-edge tile."""
    ep = max(ep, 1)
    return (128 if 128 % (8 * ep) == 0 else 128 * ep,
            512 * ep if ep > 1 else 512)


def src_plan(edge_src: np.ndarray, edge_mask: np.ndarray,
             num_src: int) -> dict:
    """The src-sorted companions of an edge list over ``num_src`` table
    rows (collate's): the stable sort, the sorted ids, their CSR offsets
    and the mask in sorted order."""
    perm = np.argsort(edge_src, kind="stable").astype(np.int32)
    srt = np.asarray(edge_src)[perm].astype(np.int32)
    return dict(edge_src_perm=perm, edge_src_sorted=srt,
                src_rowptr=np.searchsorted(
                    srt, np.arange(num_src + 1), "left").astype(np.int32),
                edge_mask_src_sorted=np.asarray(edge_mask)[perm])


def partition_loss(batch: CrystalBatch, ep: int, m: int,
                   owned: bool = False) -> CrystalBatch:
    """``batch`` with its prediction mask split over ``ep`` members:
    element i kept by member ``i mod ep`` only. ``owned`` (halo with node
    targets): the member's nodes are its own, and the mask is kept."""
    if ep == 1 or (owned and batch.adp_targets):
        return batch
    name = "non_h_mask" if batch.adp_targets else "graph_mask"
    mask = np.asarray(getattr(batch, name))
    keep = (np.arange(mask.shape[0]) % ep) == m
    return dataclasses.replace(batch, **{name: mask & keep})


def ep_member(batch: CrystalBatch, ep: int, m: int) -> CrystalBatch:
    """Member ``m`` of ``ep``'s share of a collated host batch: its edge
    slice with plans local to it, the nodes and graphs as they are, and
    the loss partition (module docstring)."""
    if ep == 1:
        return batch
    E, N = batch.num_edges, batch.num_nodes
    if E % ep:
        raise ValueError(f"{E} edges do not split over ep = {ep}")
    e_per = E // ep
    sl = slice(m * e_per, (m + 1) * e_per)
    edges = {k: np.asarray(getattr(batch, k))[sl] for k in EDGE_FIELDS}
    rowptr = np.clip(np.asarray(batch.dst_rowptr).astype(np.int64)
                     - m * e_per, 0, e_per).astype(np.int32)
    out = dataclasses.replace(
        batch, **edges, dst_rowptr=rowptr,
        **src_plan(edges["edge_src"], edges["edge_mask"], N))
    return partition_loss(out, ep, m)


def halo_member(hb: CrystalBatch, ep: int, m: int) -> CrystalBatch:
    """Member ``m``'s block of a halo layout (``halo.to_halo``'s
    member-major batch): its nodes and edges, its send lists, ``dst_rowptr``
    over its n_per node rows and the src plan over its table of n_per + ep
    H rows, ``src_degree`` of its own rows (the dp slice's counts), and the
    loss partition of scalar targets."""
    N, E = hb.num_nodes, hb.num_edges
    n_per, e_per = N // ep, E // ep
    nsl = slice(m * n_per, (m + 1) * n_per)
    esl = slice(m * e_per, (m + 1) * e_per)
    nodes = {k: np.asarray(getattr(hb, k))[nsl] for k in NODE_FIELDS}
    if hb.adp_targets:
        nodes["y"] = np.asarray(hb.y)[nsl]
    edges = {k: np.asarray(getattr(hb, k))[esl] for k in EDGE_FIELDS}
    send_idx = np.asarray(hb.halo_send_idx)[m]
    n_table = n_per + send_idx.shape[0] * send_idx.shape[1]
    out = dataclasses.replace(
        hb, **nodes, **edges,
        dst_rowptr=np.searchsorted(edges["edge_dst"], np.arange(n_per + 1),
                                   "left").astype(np.int32),
        **src_plan(edges["edge_src"], edges["edge_mask"], n_table),
        src_degree=np.asarray(hb.src_degree)[nsl],
        halo_send_idx=send_idx,
        halo_send_mask=np.asarray(hb.halo_send_mask)[m])
    return partition_loss(out, ep, m, owned=True)

