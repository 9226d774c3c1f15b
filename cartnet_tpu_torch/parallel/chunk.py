"""Chunked single-device execution, ``--chunks K`` (port of
cartnet_tpu/parallel/chunk.py).

What chunking means to a user, kept from the JAX package:

  * each batch is re-laid into K member-major chunks by the halo
    partitioner (parallel/halo.to_halo), with graph-snapped cuts where the
    crystals fit whole chunks;
  * the pads get the chunk slack and the ep-style multiples
    (``runner.pipelines``);
  * BN statistics, the loss and the gradients are those of the flat step;
  * eval gives flat member-major predictions.

What the JAX package does with that layout is TPU mechanics: it vmaps the
member-local forward over a chunk axis, so that each Pallas instance holds
an N/K-node table in VMEM. The port's kernels keep no node table
resident, and launching each kernel K times a layer would multiply the
launches of a step that is already host-bound. So ``to_chunked`` turns
the K chunks back into one flat batch in the chunk layout (member m's
node rows at ``m n_per + local``, every edge's ids global, the flat plans
rebuilt over the whole batch), and the runner trains it with the
single-process step: one kernel call a layer over all K chunks.

That computes what the JAX chunk step computes. Under halo each member
owns its dst rows and every edge into them, in the flat batch's order,
so each dst row's aggregate sums the same edges in the same order as the
flat batch's; each member's edge block is a multiple of 512 edges, so no
64-edge BN moment tile straddles two members. The pad edges between the
members move real edges into other tiles, so BN's window moments and
K5's weight sums agree with the flat step to f32 rounding, as the JAX
chunk step's do.

``ChunkedPipeline`` applies ``to_chunked`` to each batch of a pipeline
lazily (the JAX runner's ``_TransformedPipe``). A batch that no layout
fits raises ``HaloInfeasible``; it is never run flat.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from cartnet_tpu_torch.data.schema import CrystalBatch
from cartnet_tpu_torch.parallel.halo import HaloInfeasible, to_halo
from cartnet_tpu_torch.parallel.partition import src_plan

# the rows one owner may send one chunk, tried in this order before n_per:
# graph-snapped cuts need none, and a small allowance is found first
H_MAX_STEPS = (16, 64, 256)


def to_chunked(batch: CrystalBatch, k: int,
               h_max: Optional[int] = None) -> CrystalBatch:
    """A collated host batch in the layout of ``k`` member-major chunks,
    as one flat batch (module docstring): the halo layout's node rows,
    masks, targets and per-member edge blocks, ``edge_dst`` and
    ``edge_src`` as global rows, ``dst_rowptr``, the src plan and
    ``src_degree`` over the whole batch, no send lists (the model takes
    its flat path), ``halo_empty`` as the layout found it and ``chunks``
    = k. ``h_max`` None: the first of ``H_MAX_STEPS``, then n_per, that
    fits (the JAX search); the last ``HaloInfeasible`` when none does."""
    hb, err = None, None
    n_per = batch.num_nodes // k
    for cand in ((h_max,) if h_max is not None else H_MAX_STEPS + (n_per,)):
        if cand > n_per:
            continue
        try:
            hb = to_halo(batch, k, cand)
            break
        except HaloInfeasible as e:
            err = e
    if hb is None:
        raise err
    n, e = hb.num_nodes, hb.num_edges
    n_per, e_per = n // k, e // k
    send_idx = np.asarray(hb.halo_send_idx)
    h = send_idx.shape[-1]
    member = np.repeat(np.arange(k, dtype=np.int64), e_per)
    base = member * n_per
    dst = np.asarray(hb.edge_dst).astype(np.int64) + base
    src = np.asarray(hb.edge_src).astype(np.int64)
    emask = np.asarray(hb.edge_mask)
    out_src = base + src
    # a halo slot n_per + r h + s of member m: its owner o's local row
    # send_idx[o, m, s], in to_halo's neighbours-first rolled order
    remote = src >= n_per
    if remote.any():
        m = member[remote]
        r, s = np.divmod(src[remote] - n_per, h)
        o = (m + 1 + r) % k
        out_src[remote] = o * n_per + send_idx[o, m, s]
    out_src = out_src.astype(np.int32)
    return dataclasses.replace(
        hb, edge_src=out_src, edge_dst=dst.astype(np.int32),
        dst_rowptr=np.searchsorted(dst, np.arange(n + 1),
                                   "left").astype(np.int32),
        **src_plan(out_src, emask, n),
        src_degree=np.bincount(out_src[emask],
                               minlength=n).astype(np.float32),
        halo_send_idx=None, halo_send_mask=None, chunks=k)


class ChunkedPipeline:
    """A pipeline whose batches come out ``to_chunked(b, k)``, each as it
    is reached; its length and shuffle generator are the pipeline's."""

    def __init__(self, pipe, k: int):
        self.pipe, self.k = pipe, k

    @property
    def rng(self):
        return self.pipe.rng

    def __len__(self):
        return len(self.pipe)

    def __iter__(self):
        return (to_chunked(b, self.k) for b in self.pipe)
