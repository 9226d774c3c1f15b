"""Batch pipeline (port of the default path of cartnet_tpu/data/pipeline.py).

Pad sizes chosen once for a whole dataset, per-graph edge alignment on
ADP-scale data, RCM relabeling where the edges are aligned, a seeded
per-epoch shuffle and SO(3) augmentation: the train split shuffles and
(with ``augment``) rotates each record as its batch is emitted, val/test do
neither. Shuffle and augmentation draw from one ``np.random.default_rng``
(``rng``) in the JAX order, so with ``buckets=1`` (the JAX default) this
emits the same batches, in the same order, as the JAX ``BatchPipeline``
with the same seed. ``rng``'s bit-generator state is what a resumable
checkpoint keeps. Size buckets and background prefetch are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Optional

import numpy as np

from cartnet_tpu_torch.data.adp import augment_record
from cartnet_tpu_torch.data.batching import (EDGE_ALIGN, bandwidth_reorder,
                                             collate)
from cartnet_tpu_torch.data.schema import CrystalBatch


def record_counts(records) -> tuple:
    """(node_counts, edge_counts) arrays of a record list."""
    nodes = np.array([len(r["z"]) for r in records])
    edges = np.array([len(r["edge_src"]) for r in records])
    return nodes, edges


def edge_align_for(edges: np.ndarray) -> int:
    """Align each graph's edge segment on ADP-scale data (mean >= 2 edge
    windows per crystal); small-graph data stays unaligned."""
    return EDGE_ALIGN if len(edges) and float(np.mean(edges)) >= 2 * EDGE_ALIGN \
        else 0


def choose_pad_sizes_from_counts(nodes: np.ndarray, edges: np.ndarray,
                                 batch_size: int, node_multiple: int = 128,
                                 edge_multiple: int = 512,
                                 safety: float = 1.0, edge_align: int = 0):
    """Static (max_nodes, max_edges) covering the worst batch: the sum of
    the ``batch_size`` largest graphs, rounded up to the multiples."""
    if edge_align:
        edges = (-(-np.asarray(edges) // edge_align)) * edge_align
    nodes = np.sort(np.asarray(nodes))[::-1]
    edges = np.sort(np.asarray(edges))[::-1]
    worst_n = int(nodes[:batch_size].sum() * safety)
    worst_e = int(edges[:batch_size].sum() * safety)
    max_nodes = -(-max(worst_n, 1) // node_multiple) * node_multiple
    max_edges = -(-max(worst_e, 1) // edge_multiple) * edge_multiple
    logging.info("pad sizes: nodes %d (avg fill %.0f%%), edges %d "
                 "(avg fill %.0f%%)", max_nodes,
                 100 * nodes.mean() * batch_size / max_nodes, max_edges,
                 100 * edges.mean() * batch_size / max_edges)
    return max_nodes, max_edges


class BatchPipeline:
    """Iterates padded host batches over a list of records."""

    def __init__(self, records, batch_size: int,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None, shuffle: bool = False,
                 augment: bool = False, rotate_targets: bool = True,
                 seed: int = 0, edge_align: Optional[int] = None,
                 node_multiple: int = 128, edge_multiple: int = 512):
        self.records = records
        self.batch_size = batch_size
        nodes, edges = record_counts(records)
        if edge_align is None:
            edge_align = edge_align_for(edges)
        self.edge_align = edge_align or 0
        if max_nodes is None or max_edges is None:
            max_nodes, max_edges = choose_pad_sizes_from_counts(
                nodes, edges, batch_size, node_multiple, edge_multiple,
                edge_align=self.edge_align)
        self.max_nodes, self.max_edges = max_nodes, max_edges
        self.shuffle = shuffle
        self.augment = augment
        self.rotate_targets = rotate_targets
        self.rng = np.random.default_rng(seed)
        self._cached: Optional[List[CrystalBatch]] = None

    def __len__(self):
        return -(-len(self.records) // self.batch_size)

    def _make_batches(self) -> Iterator[CrystalBatch]:
        order = np.arange(len(self.records))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order), bs):
            recs = [self.records[j] for j in order[i:i + bs]]
            if self.augment:
                recs = [augment_record(r, self.rng, self.rotate_targets)
                        for r in recs]
            if self.edge_align:  # RCM only where edges are window-aligned
                recs = [bandwidth_reorder(r) for r in recs]
            yield collate(recs, self.max_nodes, self.max_edges, bs,
                          edge_align=self.edge_align)

    def __iter__(self) -> Iterator[CrystalBatch]:
        if self.shuffle or self.augment:
            yield from self._make_batches()
            return
        if self._cached is None:  # val/test: collate once
            self._cached = list(self._make_batches())
        yield from self._cached
