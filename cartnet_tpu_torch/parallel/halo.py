"""Halo partitioning: nodes and edges sharded over ep (port of
cartnet_tpu/parallel/halo.py).

Each ep member owns a contiguous range of a dp slice's nodes and exactly
the edges whose destination it owns, so:

  * the segment sums of message passing are member-local (dst-partitioned
    edges need no reduction of the aggregates);
  * the only per-layer exchange is the halo: the boundary source rows
    fetched from their owners with one all-to-all over the ep group;
  * node ranges snap to graph boundaries whenever the crystals fit whole
    members, and then the halo is empty and nothing is exchanged.

Host side (numpy, the JAX package's planner, copied): ``to_halo`` lays a
collated dp-slice batch out member-major (``n_per = N / ep`` node rows and
``e_per = E / ep`` edges a member; ``edge_dst`` member-local; ``edge_src``
into the member's table ``[local n_per ‖ received ep·H]``, the received
blocks in the neighbours-first rolled order), with the send lists
``halo_send_idx`` / ``halo_send_mask`` [ep, ep, H] and ``halo_empty``.
The JAX package's Pallas window plans (``edge_dst_lo``, ``src_band``, the
fused flags) and its interior-first window order, which lets a TPU overlap
the exchange with a first kernel call, are TPU mechanics the port does not
carry: its kernels take the member's dst-sorted edges with
``parallel/partition.halo_member``'s plans. ``src_degree`` is the slice's
count of real edges out of each node, member-major (the eComformer's
scatter-mean onto sources divides by it). A batch no layout fits raises
``HaloInfeasible``. ``comms_bytes_per_layer`` counts the halo's bytes
against the all-reduce of the replicated layout.

Device side: ``halo_recv_rows`` (the received block), ``halo_table``
(``[x ‖ received]``) and ``halo_scatter_back`` (partial sums onto received
rows sent back to their owners), each one ``all_to_all_single`` over the ep
group through an autograd Function whose backward is the reverse exchange.
An empty halo skips the collective: the received block is zeros, which no
real edge reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cartnet_tpu_torch.data.schema import CrystalBatch


class HaloInfeasible(ValueError):
    pass


def _partition_nodes(node_mask: np.ndarray, graph_id: np.ndarray,
                     edge_dst: np.ndarray, edge_mask: np.ndarray,
                     ep: int, n_per: int, e_per: int,
                     cum_edges: Optional[np.ndarray] = None) -> np.ndarray:
    """Contiguous node-range bounds [ep+1] balancing in-edges under the
    caps: an all-snapped partition (every cut at a graph start: no halo)
    when one exists, found with a right-to-left suffix-feasibility table,
    else the greedy mid-graph splitter. ``cum_edges``: edges into [0, i)
    as the caller counts them (``to_halo`` counts every edge whose dst is
    in range, alignment pads included)."""
    n = len(node_mask)
    nr = int(node_mask.sum())
    if cum_edges is None:
        indeg = np.bincount(edge_dst[edge_mask], minlength=n)
        cum_edges = np.concatenate([[0], np.cumsum(indeg)])
    er = int(cum_edges[nr])
    graph_starts = np.flatnonzero(np.diff(
        np.concatenate([[-1], graph_id[:nr]])) != 0)

    def fits(lo, hi):
        return (hi - lo <= n_per
                and cum_edges[hi] - cum_edges[lo] <= e_per)

    # all snapped: suffix[j] = the fewest members that hold the graphs
    # from gs[j] on
    gs = np.concatenate([graph_starts, [nr]])
    ng = len(gs) - 1
    suffix = np.full(ng + 1, 10 ** 9, np.int64)
    suffix[ng] = 0
    for j in range(ng - 1, -1, -1):
        j2 = j
        while j2 + 1 <= ng and fits(gs[j], gs[j2 + 1]):
            j2 += 1
        if j2 > j and suffix[j2] < 10 ** 9:
            suffix[j] = suffix[j2] + 1
        for jt in range(j2, j, -1):
            if suffix[jt] + 1 < suffix[j]:
                suffix[j] = suffix[jt] + 1
    if suffix[0] <= ep:
        bounds = [0]
        j = 0
        for m in range(ep - 1):
            left = ep - m - 1
            j2 = j
            while (j2 + 1 <= ng and fits(gs[j], gs[j2 + 1])
                   and suffix[j2 + 1] <= left):
                j2 += 1
            bounds.append(int(gs[j2]))
            j = j2
        bounds.append(nr)
        bounds = np.asarray(bounds, np.int64)
        if all(fits(bounds[m], bounds[m + 1]) for m in range(ep)):
            return bounds

    # greedy mid-graph cuts
    bounds = [0]
    for m in range(ep - 1):
        lo = bounds[-1]
        target_edges = er * (m + 1) / ep
        hi_cap = min(lo + n_per, nr)
        while hi_cap > lo and cum_edges[hi_cap] - cum_edges[lo] > e_per:
            hi_cap -= 1
        hi_bal = int(np.searchsorted(cum_edges, target_edges))
        hi = min(max(hi_bal, lo), hi_cap)
        # the graph start nearest the balanced cut costs no halo
        snaps = graph_starts[(graph_starts > lo) & (graph_starts <= hi_cap)]
        if len(snaps):
            hi = int(snaps[np.argmin(np.abs(snaps - hi))])
        if hi <= lo and nr > lo:
            hi = min(lo + 1, hi_cap) if hi_cap > lo else lo
        # the remaining members must hold the remaining nodes and edges
        left = ep - m - 1
        while hi < nr and (nr - hi > left * n_per
                           or er - cum_edges[hi] > left * e_per):
            hi += 1
        if hi > hi_cap:
            raise HaloInfeasible(
                f"member {m}: no cut satisfies caps (n_per={n_per}, "
                f"e_per={e_per}) — raise max_nodes/max_edges padding")
        bounds.append(hi)
    bounds.append(nr)
    bounds = np.asarray(bounds, np.int64)
    for m in range(ep):
        ln = bounds[m + 1] - bounds[m]
        le = cum_edges[bounds[m + 1]] - cum_edges[bounds[m]]
        if ln > n_per or le > e_per:
            raise HaloInfeasible(
                f"member {m}: {ln} nodes (cap {n_per}) / {le} edges "
                f"(cap {e_per}) — raise max_nodes/max_edges padding")
    return bounds


def to_halo(batch: CrystalBatch, ep: int,
            h_max: Optional[int] = None) -> CrystalBatch:
    """A collated host dp-slice batch laid out for halo partitioning over
    ``ep`` members (module docstring); ``h_max``: the rows one owner sends
    one member at most (default n_per)."""
    N, E = batch.z.shape[0], batch.edge_src.shape[0]
    if N % ep or E % ep:
        raise HaloInfeasible(f"pad sizes must divide ep: N={N} E={E} ep={ep}")
    n_per, e_per = N // ep, E // ep
    if h_max is None:
        h_max = n_per
    node_mask = np.asarray(batch.node_mask)
    edge_mask = np.asarray(batch.edge_mask)
    dst = np.asarray(batch.edge_dst).astype(np.int64)
    src = np.asarray(batch.edge_src).astype(np.int64)
    graph_id = np.asarray(batch.graph_id)
    # a member's capacity counts every edge whose dst is in its range,
    # interior alignment pads included (the tail pads are left out: each
    # member pads its own tail)
    real_pos = np.flatnonzero(edge_mask)
    e_end = int(real_pos.max()) + 1 if len(real_pos) else 0
    cum_all = np.searchsorted(dst[:e_end], np.arange(len(node_mask) + 1),
                              "left")
    bounds = _partition_nodes(node_mask, graph_id, dst, edge_mask, ep,
                              n_per, e_per, cum_edges=cum_all)

    adp = np.ndim(batch.y) == 3
    nz = lambda shape, dt: np.zeros(shape, dt)
    out_z = nz(N, np.int32)
    out_pos = nz((N, 3), np.float32)
    out_gid = nz(N, np.int32)
    out_nmask = nz(N, bool)
    out_nonh = nz(N, bool)
    out_y = nz((N, 3, 3), np.float32) if adp else np.asarray(batch.y)
    out_deg = nz(N, np.float32)
    out_src = np.zeros(E, np.int32)
    out_dst = np.zeros(E, np.int32)
    out_dist = nz(E, np.float32)
    out_dir = nz((E, 3), np.float32)
    out_emask = nz(E, bool)
    send_idx = nz((ep, ep, h_max), np.int32)
    send_mask = nz((ep, ep, h_max), bool)
    degree = np.bincount(src[edge_mask], minlength=N).astype(np.float32)

    owner_of = np.searchsorted(bounds, np.arange(N), side="right") - 1
    owner_of = np.clip(owner_of, 0, ep - 1)

    for m in range(ep):
        lo, hi = int(bounds[m]), int(bounds[m + 1])
        ln = hi - lo
        nsl = slice(m * n_per, m * n_per + ln)
        out_z[nsl] = np.asarray(batch.z)[lo:hi]
        out_pos[nsl] = np.asarray(batch.pos)[lo:hi]
        out_gid[nsl] = graph_id[lo:hi]
        out_nmask[nsl] = node_mask[lo:hi]
        out_nonh[nsl] = np.asarray(batch.non_h_mask)[lo:hi]
        out_deg[nsl] = degree[lo:hi]
        if adp:
            out_y[nsl] = np.asarray(batch.y)[lo:hi]

        # the contiguous dst range of the dst-sorted edge list, interior
        # alignment pads included
        e0, e1 = int(cum_all[lo]), int(cum_all[hi])
        esel = np.arange(e0, e1)
        le = len(esel)
        if le > e_per:
            raise HaloInfeasible(
                f"member {m}: {le} edges (cap {e_per}) — raise max_edges")
        emask_m = edge_mask[esel]
        esl = slice(m * e_per, m * e_per + le)
        out_dst[esl] = (dst[esel] - lo).astype(np.int32)
        out_dist[esl] = np.asarray(batch.cart_dist)[esel]
        out_dir[esl] = np.asarray(batch.cart_dir)[esel]
        out_emask[esl] = emask_m
        # the member's tail pads point at its last local row (monotone)
        pad_sl = slice(m * e_per + le, (m + 1) * e_per)
        out_dst[pad_sl] = max(n_per - 1, 0)
        out_src[pad_sl] = 0

        # src: a local row, or a halo slot of its owner; pads point at
        # their own dst row
        e_src = src[esel]
        e_owner = owner_of[e_src]
        src_ids = np.empty(le, np.int32)
        src_ids[~emask_m] = (dst[esel][~emask_m] - lo).astype(np.int32)
        local = (e_owner == m) & emask_m
        src_ids[local] = (e_src[local] - lo).astype(np.int32)
        remote = (~local) & emask_m
        for o in np.unique(e_owner[remote]):
            sel = (e_owner == o) & remote
            rows = np.unique(e_src[sel])  # global rows owned by o
            if len(rows) > h_max:
                raise HaloInfeasible(
                    f"halo {len(rows)} rows from member {int(o)} to {m} "
                    f"exceeds h_max={h_max}")
            send_idx[o, m, :len(rows)] = (rows - bounds[o]).astype(np.int32)
            send_mask[o, m, :len(rows)] = True
            slot = np.searchsorted(rows, e_src[sel])
            # neighbours-first rolled order: owner m+1 right after the
            # local rows (halo_recv_rows builds the same order)
            rank = (int(o) - m - 1) % ep
            src_ids[sel] = (n_per + rank * h_max + slot).astype(np.int32)
        out_src[esl] = src_ids

    return dataclasses.replace(
        batch, z=out_z, pos=out_pos, graph_id=out_gid, node_mask=out_nmask,
        non_h_mask=out_nonh, y=out_y, edge_src=out_src, edge_dst=out_dst,
        cart_dist=out_dist, cart_dir=out_dir, edge_mask=out_emask,
        dst_rowptr=None, src_rowptr=None, edge_src_perm=None,
        edge_src_sorted=None, edge_mask_src_sorted=None, src_degree=out_deg,
        halo_send_idx=send_idx, halo_send_mask=send_mask,
        halo_empty=bool(send_mask.sum() == 0))


def comms_bytes_per_layer(batch: CrystalBatch, dim: int,
                          itemsize: int = 4) -> Tuple[int, int]:
    """(halo bytes, replicated all-reduce bytes) a message-passing layer
    of a ``to_halo`` batch: the real send rows once out and once in,
    against a ring all-reduce of the whole [N, d] aggregate,
    2 (ep - 1) / ep N d."""
    ep = np.asarray(batch.halo_send_idx).shape[-2]
    sent = int(np.asarray(batch.halo_send_mask).sum())
    halo = 2 * sent * dim * itemsize
    n_total = batch.z.shape[0]
    psum = int(2 * (ep - 1) / ep * n_total * dim * itemsize)
    return halo, psum


# ------------------------------------------------------------ device side

class _AllToAll(torch.autograd.Function):
    """Equal blocks of the rows to and from every member of ``group``; the
    backward is the reverse exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, ct):
        out = torch.empty_like(ct)
        dist.all_to_all_single(out, ct.contiguous(), group=ctx.group)
        return out, None


def halo_recv_rows(x, batch: CrystalBatch, groups):
    """The received block [ep·H, d]: the rows each owner sends this
    member, in the neighbours-first rolled order ``to_halo``'s src ids
    were built against (owner (m+1+r) mod ep at block r). An empty halo
    gives zeros and no collective."""
    ep, h = batch.halo_send_idx.shape
    if batch.halo_empty:
        return x.new_zeros((ep * h, x.shape[-1]))
    send = x.index_select(0, batch.halo_send_idx.reshape(-1))
    recv = _AllToAll.apply(send, groups.ep).view(ep, h, -1)
    return torch.roll(recv, -(groups.ep_rank + 1), dims=0).reshape(
        ep * h, -1)


def halo_table(x, batch: CrystalBatch, groups):
    """The member's gather table [n_per + ep·H, d] = [x ‖ received]."""
    return torch.cat([x, halo_recv_rows(x, batch, groups)], dim=0)


def halo_scatter_back(table_sums, batch: CrystalBatch, groups):
    """Sums over a member's table rows [n_per + ep·H, C] (a scatter onto
    edge sources) -> the complete sums of its own n_per rows: the received
    rows' partials go back to their owners (rolled from rank to owner
    order, one all-to-all: the reverse of ``halo_recv_rows``) and are added
    into the rows they came from. Unused slots carry zeros."""
    n_per = table_sums.shape[0] - batch.halo_send_idx.numel()
    local = table_sums[:n_per]
    if batch.halo_empty:
        return local
    ep, h = batch.halo_send_idx.shape
    remote = table_sums[n_per:].view(ep, h, -1)
    remote = torch.roll(remote, groups.ep_rank + 1, dims=0)
    back = _AllToAll.apply(remote.reshape(ep * h, -1).contiguous(),
                           groups.ep)
    return local.index_add(0, batch.halo_send_idx.reshape(-1), back)
