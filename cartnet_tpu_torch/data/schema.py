"""Canonical crystal-graph batch (port of cartnet_tpu/data/schema.py).

A plain dataclass: ``collate`` fills it with numpy arrays on the host and
``.to(device)`` returns a copy whose arrays are torch tensors on the device.
Every array is padded to a static size and carries an explicit mask; edges
are sorted by destination.

Conventions: messages flow src -> dst and aggregate onto dst; ``cart_dir``
is the unit vector pos[dst] - imaged pos[src]; pad nodes/edges/graphs have
mask=False.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from cartnet_tpu_torch import tracing


@dataclasses.dataclass
class CrystalBatch:
    # nodes [N]
    z: Any            # [N] int32 atomic numbers (0 on pads)
    pos: Any          # [N, 3] f32 cartesian coords
    graph_id: Any     # [N] int32 graph slot of each node (0 on pads)
    node_mask: Any    # [N] bool
    non_h_mask: Any   # [N] bool (False on pads and H atoms)
    # edges [E], sorted by dst
    edge_src: Any     # [E] int32
    edge_dst: Any     # [E] int32
    cart_dir: Any     # [E, 3] f32 unit direction
    cart_dist: Any    # [E] f32 distance
    edge_mask: Any    # [E] bool
    # graphs [G]
    cell: Any         # [G, 3, 3] f32 lattice rows
    temperature: Any  # [G] f32
    graph_mask: Any   # [G] bool
    # targets: scalar [G] or per-node ADP [N, 3, 3]
    y: Any
    # CSR offsets of edge_dst: the edges of node n are
    # [dst_rowptr[n], dst_rowptr[n+1]) — the sigma/segment-sum kernel's rows
    dst_rowptr: Any = None            # [N+1] int32
    # src-sorted companions for the deterministic src-side reductions of
    # the edge-phase backward: edge_src[edge_src_perm] is ascending, and
    # the sorted positions of node n are [src_rowptr[n], src_rowptr[n+1])
    src_rowptr: Any = None                      # [N+1] int32
    edge_src_perm: Optional[Any] = None         # [E] int32
    edge_src_sorted: Optional[Any] = None       # [E] int32
    edge_mask_src_sorted: Optional[Any] = None  # [E] bool
    src_degree: Optional[Any] = None            # [N] f32 real src degree
    # halo partitioning (parallel/halo.py): the rows this member sends to
    # each member [ep, H] and which of them are real; ``halo_empty`` (a
    # host bool, the same on every member of a dp slice) says no member
    # sends anything, and the exchange is skipped
    halo_send_idx: Optional[Any] = None         # [ep, H] int32
    halo_send_mask: Optional[Any] = None        # [ep, H] bool
    halo_empty: bool = False
    # chunked execution (parallel/chunk.py): the member-major chunks the
    # batch is laid out in (1: collate's layout), a host int
    chunks: int = 1

    @property
    def num_nodes(self) -> int:
        return self.z.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_src.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.temperature.shape[0]

    @property
    def adp_targets(self) -> bool:
        return self.y.ndim == 3

    @property
    def halo(self) -> bool:
        """The batch is one member's block of a halo layout."""
        return self.halo_send_idx is not None

    def to(self, device) -> "CrystalBatch":
        """Copy with every array field as a torch tensor on ``device``
        (the span ``batch.to_device``; the counters
        ``batch.to_device.copies``, one a field, and
        ``batch.to_device.bytes``, their ``nbytes``)."""
        def move(a):
            if isinstance(a, torch.Tensor):
                return a.to(device)
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        with tracing.span("batch.to_device"):
            fields = array_fields(self)
            moved = dataclasses.replace(self, **{
                k: move(a) for k, a in fields.items()})
        if tracing.recording():
            tracing.count("batch.to_device.copies", len(fields))
            tracing.count("batch.to_device.bytes",
                          sum(a.nbytes for a in fields.values()))
        return moved


# host-side flags: not arrays, never stacked or moved to a device
STATIC_FIELDS = ("halo_empty", "chunks")


def array_fields(batch: CrystalBatch) -> dict:
    """The batch's array fields that are set, name -> array."""
    return {f.name: getattr(batch, f.name)
            for f in dataclasses.fields(batch)
            if f.name not in STATIC_FIELDS
            and getattr(batch, f.name) is not None}
