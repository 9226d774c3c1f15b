"""Fused chunks on the card: one CUDA graph of K micro-steps per pad shape
(the port of the JAX package's one-launch ``lax.scan`` chunk, whose
counterpart here is ``loop.make_fused_chunk``).

``ChunkRunner(chunk_fn, num_steps, device, group)`` runs
``chunk_fn(state, stacked)`` over ``num_steps`` host batches of one pad
shape and returns its per-step stats on the device:

* on the CPU it stacks the batches (``loop.stack_batches``) and runs the
  chunk eagerly, through the kernels' plain versions (the port's device
  rule);
* on the card, the first time it meets a pad shape (with the
  ``CARTNET_MERGED`` switch, which the CartNet train forward reads), it
  allocates static device inputs with a leading K axis and a pinned host
  copy of them, runs the chunk once on a side stream from a snapshot of
  the state (the kernels build, cuBLAS and NCCL initialize, the allocator
  settles) and puts the state back, then captures the chunk into a CUDA
  graph with a private memory pool. Each call then writes the K batches
  into the pinned copy (one ``np.stack`` a field), copies it to the static
  inputs (one ``copy_`` a field) and replays the graph: K micro-steps for
  one host launch.

The graph reads and writes the state at the addresses it had at capture:
the parameters, Adam's moments and the device count, the accumulator, the
guard's counters and the BN buffers, all of which the chunk updates in
place (the kernels' TMA descriptors carry addresses too). A chunk whose
state tensors moved (a checkpoint load gives Adam new tensors) is captured
again. A capture or a replay that fails raises; there is no eager
fallback on the card. Under data parallelism the chunk's all-reduces are
captured with it, which needs NCCL: gloo reduces CUDA tensors through the
host, and a ``group`` on another backend raises on the card.

The kernel wrappers' launch counters advance in the warm-up and at the
capture (once a micro-step each), never at a replay: a replay's kernels
are counted by their CUDA names (``chip_smoke.py``). ``captures`` holds
each capture's seconds (recording the chunk, then ending the capture,
which instantiates the graph) and the memory its pool took.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from cartnet_tpu_torch import tracing
from cartnet_tpu_torch.data.schema import CrystalBatch, array_fields
from cartnet_tpu_torch.train.loop import bn_buffers, stack_batches
from cartnet_tpu_torch.train.state import TrainState


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor of ``state`` a fused chunk reads or writes in place."""
    return (list(state.optimizer.params) + state.optimizer.device_state()
            + list(state.grad_accum) + [state.accum_count, state.bad_steps]
            + bn_buffers(state.model))


def _fields(batch: CrystalBatch) -> Dict[str, np.ndarray]:
    return {k: np.asarray(a) for k, a in array_fields(batch).items()}


class _Graph:
    """One captured chunk: its static inputs, pinned host copy, outputs
    and the state addresses it was captured at."""

    def __init__(self, template: CrystalBatch, num_steps: int, device):
        fields = _fields(template)
        self.pinned = {k: torch.empty((num_steps,) + a.shape,
                                      dtype=torch.from_numpy(a[:0]).dtype,
                                      pin_memory=True)
                       for k, a in fields.items()}
        self.host = {k: t.numpy() for k, t in self.pinned.items()}
        self.static = {k: torch.empty_like(t, device=device)
                       for k, t in self.pinned.items()}
        self.stacked = dataclasses.replace(template, **self.static)
        self.copied = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        self.outputs: Dict[str, torch.Tensor] = {}
        self.ptrs: List[int] = []

    def load(self, batches: List[CrystalBatch]) -> None:
        """The batches into the static inputs, through the pinned copy
        (which the previous chunk's copy must have left)."""
        with tracing.span("chunk.wait"):
            self.copied.synchronize()
        with tracing.span("chunk.stack"):
            for k, out in self.host.items():
                np.stack([np.asarray(getattr(b, k)) for b in batches],
                         out=out)
        with tracing.span("chunk.copy"):
            for k, t in self.static.items():
                t.copy_(self.pinned[k], non_blocking=True)
            self.copied.record()


class ChunkRunner:
    """``chunk_fn`` over ``num_steps`` host batches a call: eager on the
    CPU, a CUDA-graph replay on the card (module docstring)."""

    def __init__(self, chunk_fn, num_steps: int, device="cuda", group=None):
        self.device = torch.device(device)
        if (self.device.type == "cuda" and group is not None
                and dist.get_backend(group) != "nccl"):
            raise ValueError(
                "--fused_steps under data parallelism on the card needs "
                f"NCCL, not {dist.get_backend(group)}: gloo all-reduces CUDA "
                "tensors through the host, which a CUDA graph cannot "
                "capture")
        self.chunk_fn, self.num_steps = chunk_fn, num_steps
        self.graphs: Dict[tuple, _Graph] = {}
        self.captures: List[dict] = []

    def __call__(self, state: TrainState, batches: List[CrystalBatch]):
        if len(batches) != self.num_steps:
            raise ValueError(f"a chunk takes {self.num_steps} batches, got "
                             f"{len(batches)}")
        with tracing.span("chunk.run"):
            if self.device.type != "cuda":
                with tracing.span("chunk.stack"):
                    stacked = stack_batches(batches)
                return self.chunk_fn(state, stacked.to(self.device))
            return self._replay(state, batches)

    def _replay(self, state: TrainState, batches: List[CrystalBatch]):
        # a halo chunk captures its exchange unless every halo is empty
        empty = all(b.halo_empty for b in batches)
        key = (tuple((k, a.shape, a.dtype.str)
                     for k, a in _fields(batches[0]).items()),
               os.environ.get("CARTNET_MERGED", "0"), empty)
        g = self.graphs.get(key)
        ptrs = [t.data_ptr() for t in state_tensors(state)]
        if g is None or g.ptrs != ptrs:
            self.graphs.pop(key, None)
            g = self.graphs[key] = self._capture(
                state, batches, key, dataclasses.replace(
                    batches[0], halo_empty=empty))
        else:
            g.load(batches)
        with tracing.span("chunk.replay"):
            g.graph.replay()
        with tracing.span("chunk.clone"):
            return {k: v.clone() for k, v in g.outputs.items()}

    def _capture(self, state: TrainState, batches, key,
                 template: CrystalBatch) -> _Graph:
        g = _Graph(template, self.num_steps, self.device)
        g.load(batches)
        tensors = state_tensors(state)
        kept = [t.clone() for t in tensors]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.chunk_fn(state, g.stacked)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, v in zip(tensors, kept):
                t.copy_(v)
        del kept
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        with torch.cuda.graph(g.graph):
            t0 = time.perf_counter()
            g.outputs = self.chunk_fn(state, g.stacked)
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        g.ptrs = [t.data_ptr() for t in state_tensors(state)]
        self.captures.append({
            "pad_shape": [int(batches[0].num_nodes),
                          int(batches[0].num_edges)],
            "merged": key[1] == "1", "capture_s": t1 - t0,
            "instantiate_s": t2 - t1,
            "pool_bytes": torch.cuda.memory_reserved(self.device)
            - reserved})
        return g
