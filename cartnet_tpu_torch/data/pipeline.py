"""Batch pipeline (port of cartnet_tpu/data/pipeline.py).

Pad sizes chosen once for a whole dataset (or, with ``buckets`` > 1, once
for each edge-count quantile of it), per-graph edge alignment on
ADP-scale data, RCM relabeling where the edges are aligned, a seeded
per-epoch shuffle and SO(3) augmentation: the train split shuffles and
(with ``augment``) rotates each record as its batch is emitted, val/test do
neither and are collated once while they fit ``CACHE_BUDGET_BYTES``.
Shuffle, bucket visit order and augmentation draw from one
``np.random.default_rng`` (``rng``) in the JAX order, so this emits the
same batches, in the same order, as the JAX ``BatchPipeline`` with the same
seed, buckets or not. ``rng``'s bit-generator state is what a resumable
checkpoint keeps. With ``prefetch`` > 0 a background thread collates up to
that many batches ahead of the consumer; every draw an epoch makes is made
by the time its iteration ends, so ``rng`` read after an epoch is the same
with prefetch on or off. With ``workers`` > 1 a thread pool fetches each
batch's records (lazy sources such as ``data/adp.LazyRecords``, which load
a ``.pt`` file per record); the records come back in order and are
augmented after the fetch, in order, so the batches are bitwise those of
``workers=0``.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

from cartnet_tpu_torch import tracing
from cartnet_tpu_torch.data.adp import augment_record
from cartnet_tpu_torch.data.batching import (EDGE_ALIGN, bandwidth_reorder,
                                             collate)
from cartnet_tpu_torch.data.schema import CrystalBatch


def record_counts(records) -> tuple:
    """(node_counts, edge_counts) arrays of a record source; a lazy source
    answers from its own ``counts()`` (a sidecar file) without loading its
    records."""
    if hasattr(records, "counts"):
        return records.counts()
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
    """Iterates padded host batches over a list of records.

    ``buckets`` > 1: records are split into size quantiles by edge count,
    each padded to its own worst batch (bounds the pad waste a heavy size
    tail causes under one global shape). Bucket visit order is shuffled
    each epoch with the records; batches never mix buckets."""

    # eval-batch caching is skipped above this estimated footprint
    CACHE_BUDGET_BYTES = 2 << 30

    def __init__(self, records, batch_size: int,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None, shuffle: bool = False,
                 augment: bool = False, rotate_targets: bool = True,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 2,
                 workers: int = 0, buckets: int = 1,
                 edge_align: Optional[int] = None,
                 node_multiple: int = 128, edge_multiple: int = 512):
        self.records = records
        self.batch_size = batch_size
        self.buckets = max(1, buckets)
        self._bucket_idx: Optional[List[np.ndarray]] = None
        self._bucket_sizes: Optional[List[tuple]] = None
        nodes, edges = record_counts(records)
        if edge_align is None:
            edge_align = edge_align_for(edges)
        self.edge_align = edge_align or 0
        if self.buckets > 1:
            order = np.argsort(edges, kind="stable")
            self._bucket_idx = [b for b in np.array_split(order, self.buckets)
                                if len(b)]
            self._bucket_sizes = [
                choose_pad_sizes_from_counts(nodes[b], edges[b], batch_size,
                                             node_multiple, edge_multiple,
                                             edge_align=self.edge_align)
                for b in self._bucket_idx]
            max_nodes = max(s[0] for s in self._bucket_sizes)
            max_edges = max(s[1] for s in self._bucket_sizes)
        elif max_nodes is None or max_edges is None:
            max_nodes, max_edges = choose_pad_sizes_from_counts(
                nodes, edges, batch_size, node_multiple, edge_multiple,
                edge_align=self.edge_align)
        self.max_nodes, self.max_edges = max_nodes, max_edges
        self.shuffle = shuffle
        self.augment = augment
        self.rotate_targets = rotate_targets
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self.cache = (not shuffle and not augment
                      and len(self) * self._batch_nbytes()
                      < self.CACHE_BUDGET_BYTES)
        self.rng = np.random.default_rng(seed)
        self._cached: Optional[List[tuple]] = None

    def _batch_nbytes(self) -> int:
        """Rough collated-batch footprint (f32 fields, masks, indices)."""
        return self.max_nodes * 64 + self.max_edges * 33

    def _batches_of(self, n: int) -> int:
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def bucket_batch_counts(self) -> List[int]:
        """Batches per bucket (one pseudo-bucket when unbucketed)."""
        if self._bucket_idx is not None:
            return [self._batches_of(len(b)) for b in self._bucket_idx]
        return [self._batches_of(len(self.records))]

    def __len__(self):
        return sum(self.bucket_batch_counts())

    def _fetch(self, idxs) -> List[dict]:
        """The records at ``idxs``, in order (a thread pool with
        ``workers`` > 1)."""
        if self.workers > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.workers)
            return list(self._pool.map(self.records.__getitem__, idxs))
        return [self.records[j] for j in idxs]

    def _emit(self, order, mn, me) -> Iterator[CrystalBatch]:
        bs = self.batch_size
        stop = (len(order) // bs) * bs if self.drop_last else len(order)
        for i in range(0, stop, bs):
            with tracing.span("data.batch"):
                with tracing.span("data.fetch"):
                    recs = self._fetch(order[i:i + bs])
                if self.augment:
                    with tracing.span("data.augment"):
                        recs = [augment_record(r, self.rng,
                                               self.rotate_targets)
                                for r in recs]
                if self.edge_align:  # RCM only where edges are aligned
                    with tracing.span("data.reorder"):
                        recs = [bandwidth_reorder(r) for r in recs]
                with tracing.span("data.collate"):
                    batch = collate(recs, mn, me, bs,
                                    edge_align=self.edge_align)
            yield batch

    def _make_batches(self) -> Iterator[tuple]:
        """(bucket_id, batch) pairs; a bucket's id is stable across epochs
        (the shuffle permutes the visit order, not the buckets)."""
        if self._bucket_idx is not None:
            border = np.arange(len(self._bucket_idx))
            if self.shuffle:
                self.rng.shuffle(border)
            for bi in border:
                order = self._bucket_idx[bi].copy()
                if self.shuffle:
                    self.rng.shuffle(order)
                for b in self._emit(order, *self._bucket_sizes[bi]):
                    yield int(bi), b
            return
        order = np.arange(len(self.records))
        if self.shuffle:
            self.rng.shuffle(order)
        for b in self._emit(order, self.max_nodes, self.max_edges):
            yield 0, b

    def _prefetched(self) -> Iterator[tuple]:
        """``_make_batches`` on a producer thread, up to ``prefetch``
        batches ahead. Its errors reach the consumer; a consumer that stops
        early stops the producer before the generator is closed."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            last = done
            try:
                for pair in self._make_batches():
                    if not put(pair):
                        return
            except Exception as err:  # raised again by the consumer
                last = err
            finally:
                put(last)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with tracing.span("data.wait"):
                    item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def iter_with_bucket(self) -> Iterator[tuple]:
        """(bucket_id, batch) pairs, cached or prefetched as configured."""
        if self.cache:
            if self._cached is None:
                self._cached = list(self._make_batches())
            yield from self._cached
        elif self.prefetch > 0:
            yield from self._prefetched()
        else:
            yield from self._make_batches()

    def __iter__(self) -> Iterator[CrystalBatch]:
        for _, b in self.iter_with_bucket():
            yield b
