#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cartnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (every line names the card and its power limit):
  1. device   the card (nvidia-smi name and power limit, also printed raw)
  2. build    nvcc builds the eight kernels from csrc/ (seven sources, one
              process per source, all started together; K6 is the second
              entry point of edge_phase_bwd.cu); each kernel's registers,
              spills and static shared memory from ptxas; the CPU tests'
              mirrors of the kernels' shared-memory plans (K1, K7, K8) and
              of K4's scratch rows against the sources' own
  3. check    each kernel against its plain PyTorch version on the card, at
              the main paths' shapes: K1/K2 in every dtype combination the
              CartNet inference forward feeds them, with K1's optional
              outputs off and on; K4/K5 (the backward kernels) and K6 (the
              merged backward) in the bf16 training case and the f32 case,
              with random cotangents that are zero on pad rows, after K1's
              pre-only residual (also held to the [pre | sig] layout's
              gate, sender and moments, bitwise); K3 (CSR segment sum) in
              f32 [E, 128] and bf16 [E, 64] / [E, 128] over the src sort,
              and K7 (TP contraction, l1 and l2) with bf16 h/W and f32 a,
              bf16 a, and the f32 config; K8 (TP backward, l1 and l2) in
              bf16 and f32 with random cotangents zero on pad rows, and K3's
              perm=None form over dst_rowptr (the sorted gather's backward)
              at bf16 [E, 256] / [E, 64] / [E, 128] and f32 [E, 256]; K2
              (four dtype combinations) and K3 (perm and perm=None, bf16
              and f32) at d = 36 and 33, also on views one row into a
              larger buffer, so that K2 runs its scalar route; plus a
              bitwise repeat of every kernel run
  4. main     the CartNet ADP inference sweep (runner.inference) over 2
              batches of 4 synthetic ADP-scale crystals, flagship model (dim
              256, 64 RBF, 4 layers, Cholesky head, bf16 compute, random
              weights from seed 0): launch counts per kernel, finite
              predictions, and agreement with the same model run through the
              plain versions
  5. train    the CartNet training path (loop.make_steps / loop.train_epoch)
              on the same batches with the flagship training config
              (temperature + atom-type inputs, bf16): 32 micro-steps with
              batch_accumulation 16, i.e. 2 optimizer updates; launch counts
              per kernel (4 of each of K1, K2, K4, K5 per micro-step),
              finite losses, no skipped step, advanced BN running stats; a
              short training run through the CLI (train, val, test) with its
              launch counts; then one micro-step from the same state through
              the kernels and through the plain versions (loss, BN stats;
              f32: every gradient per layer; bf16: each layer group's
              gradients against the f32 ones, bf16_grad_gate), in bf16 and
              in f32
  6. merged_train  the same with CARTNET_MERGED=1 (the merged backward): 16
              micro-steps = 1 optimizer update from seed 0 (K1 4, K2 4, K6 4,
              no K4 or K5 per micro-step), the CLI run, one merged micro-step
              through the kernels and through the plain versions in bf16 and
              f32, and merged vs default from the same state (forward
              bitwise equal, f32 gradients within F32_STEP_TOL, each bf16
              gradient's distance from the f32 gradient through K6 and
              through K4 + K5)
  6b. widths  the CartNet edge kernels at d = 32, 64, 96, 384 and 512, bf16
              and f32: K1 (training layout), K2, K4, K5 and K6 against their
              plain versions with bitwise repeats, K4's device time per
              pass at every width, K1's f32, K5's and K6's past 256 (K7/K8
              likewise at d = 64, 384, 512); then one CartNet micro-step
              (4 layers) per width, dtype and backward path (default: K1,
              K2, K4, K5 4 each; merged: K1, K2, K6 4 each) through the
              kernels against the plain versions, with its launch counts
  6c. cli_scalar  the CLI's --dataset synthetic without --cholesky: the
              scalar head on scalar targets (the JAX CLI's rule), trained
              through the kernels
  7. ecomformer  the eComformer inference sweep on the same 2 batches (dim
              256, 3 convs + the equivariant block, Cholesky head, bf16,
              random weights from seed 0): K1 3, K2 3, K3 2, K7 2 launches
              per forward, finite predictions, the kernel forward against
              the plain forward; then a short sweep through the CLI
              (--model eComformer --inference)
  8. ecomformer_train  the eComformer training path on the same batches
              (bench.py's eComformer, bf16, batch_accumulation 16): 16
              micro-steps = 1 optimizer update with launch counts per kernel
              (K1 3, K2 3, K3 7, K4 3, K5 3, K7 2, K8 2 per micro-step),
              finite losses, no skipped step, advanced BN stats; a short
              training run through the CLI (--model eComformer); one
              micro-step through the kernels and through the plain versions,
              in bf16 and in f32
  8b. icomformer  the iComformer inference sweep on the same 2 batches (dim
              256, four convs and the edge update, Cholesky head, bf16,
              random weights from seed 0, BN running stats from one f32
              train-mode forward over batch 0, calibrate_bn, here and in
              its f32 forward): K1 4, K2 4 launches per forward
              (K1 by CUDA kernel name: conv0's bf16 kernel once, conv1-conv3's
              two f32 passes three times each, as the edge update's f32
              output gives them f32 edges), finite predictions, the kernel
              forward against the plain forward; then a short sweep through
              the CLI (--model iComformer --inference)
  8c. icomformer_train  the iComformer training path on the same batches
              (bf16, batch_accumulation 16): 16 micro-steps = 1 optimizer
              update, K1, K2, K3 (the q gathers' backward), K4 and K5 4
              launches each per micro-step, finite losses, no skipped step,
              advanced running stats in all ten BNs; a short training run
              through the CLI; one micro-step through the kernels and
              through the plain versions, in bf16 and in f32
  8d. adpfix  the README's product path on the in-repo fixture through
              the CLI (flagship widths, f32, --augment, --limit 8, two
              epochs, batch_accumulation 2) in a temporary directory: K1,
              K2, K4, K5 4 launches a micro-step and K1, K2 4 an eval
              forward, two stats.json lines in train and val and one in
              test with the JAX package's keys (``iou`` in test),
              best.ckpt and last.ckpt; ``--resume --epochs 3`` adds
              exactly epoch 2; two Monte-Carlo rounds on best.ckpt
              (runner.montecarlo) give finite stats; one bf16 epoch
  8e. jarvis  the Jarvis/MP scalar-property path on the committed sample
              (tests/fixtures/jarvis_sample.json staged as a dataset
              path's raw/dft_3d_2021.json; its radius graphs built with
              backend="native", src/dst equal to numpy's; jarvis_data):
              at the batch-64 layouts (640 / 30720 CartNet, 640 / 12800
              the Comformers, unaligned) a CartNet forward and micro-step
              against plain in f32 and bf16 and an f32 micro-step of each
              Comformer against plain; after the time phase (so that the
              in-process --profile run stays clear of its captures), the
              CLI at full width (CartNet, dim 256, 4 layers, scalar head,
              f32, batch 64, batch_accumulation 1, two epochs) with
              --profile and --heartbeat (K1, K2, K4, K5 4 launches a
              micro-step, K1, K2 4 an eval forward; finite stats lines,
              both checkpoints, a trace file, a "stopped" heartbeat),
              again with --buckets 2, and one epoch of the eComformer and
              the iComformer with --max_neighbours 25
  8f. adp     the CSD ADP source (--dataset ADP, the CLI's default) on
              reference-layout .pt files written in the working directory
              (24 / 4 / 4 of the main path's ADP-scale crystals, a third of
              the atoms H): the JAX README's ADP command through the CLI
              at full width (batch 4, batch_accumulation 16, --augment,
              two f32 epochs: K1, K2, K4, K5 4 launches a micro-step and
              K1, K2 4 an eval forward; stats lines with the JAX keys, both
              checkpoints), one bf16 epoch, an --inference sweep on
              best.ckpt, one epoch with --disable_H (the node counts drop
              by the H share; the kernels against the plain versions at
              that layout, f32 and bf16), one epoch each of the eComformer
              (re-edged to 25 neighbours) and the iComformer (cells
              canonicalized); the seconds per epoch, LazyRecords' sizing
              seconds (scan, sidecar), one train pass with 0 and 4 fetch
              workers (the same batches)
  8g. dp      data parallelism, two ranks on the card in an explicit gloo
              group (NCCL takes one rank a device): one micro-step each on
              the main path's two batches and the update, CartNet f32 and
              bf16 and the eComformer f32, against a single-process step
              on the union batch (loss, BN stats, each layer's summed
              gradients within 1e-4, bf16 through bf16_grad_gate; the
              ranks' updated weights equal to the bit and to the update
              of the summed gradients), launches per rank; a world = 1
              NCCL group's step against the single process, beside the
              single-process step's own repeat from the same state (the
              gradients that differ between two runs of one step: the
              embedding's and the temperature projection's atomics), and
              a world = 1 NCCL fused chunk (its all-reduces captured in
              the CUDA graph) against the single-process fused chunk; the
              dp step's wall time beside the single-process step's
  8g2. ep     edge parallelism and halo partitioning, gloo ranks on the
              card: ep = 2 on the main path's first batch (CartNet bf16 and
              f32, merged bf16, the eComformer and the iComformer bf16),
              halo ep = 2 on it (an empty halo) and on three crystals one
              of which is cut across the members (CartNet and the
              eComformer bf16), dp 2 x ep 2 on both batches (CartNet
              f32); each case's loss, BN stats, gradients (f32 within
              1e-4 a layer, bf16 through bf16_grad_gate) and eval
              predictions against the single-process step on the same
              data, a member's launches (the single step's), its wall
              and collectives a micro-step; one [N, d] all-reduce's time;
              K5 and K6 with separate dst and src row counts (a halo
              member's table) against their plain versions; K1's and
              K5's device time at an ep member's shapes beside the full
              batch's; the halo bytes a layer (comms_bytes_per_layer)
  8g3. chunks chunked execution (--chunks K, parallel/chunk.py): the main
              path's crystals through runner.pipelines with K = 2 and 4
              (the chunk slack on the pads), laid out by to_chunked, and
              the split batch (one crystal cut across two chunks): K1,
              K2, K4 and K5 against their plain versions on each layout
              with bitwise repeats; a micro-step against the flat step on
              the same crystals and pads (f32 gradients within 1e-4 a
              layer or 1.5 times the flat step's rounding floor on
              shifted batches, bf16 through bf16_grad_gate; the flat
              step's launches), its wall and device busy time beside the
              flat step's; --dataset ADP --chunks 2 through the CLI for
              one epoch
  8h. fused   fused epochs (--fused_steps, train/graphs.py: K micro-steps
              one CUDA-graph replay) at the flagship CartNet training
              config on the same two batches: 32 micro-steps with K = 16
              (two replays, two updates on the device) against
              train_epoch, bf16 and f32 (update counts, losses, each
              layer group's weight change through bf16_grad_gate); one
              chunk's replay against the same chunk run eagerly (bf16 K =
              16; K = 4 in f32, merged, the eComformer, the iComformer);
              a ragged tail and a guard-rejected micro-step (K = 4 over 6
              batches) against a host replay of the cadence; one replay's
              kernels by CUDA name (K times each wrapper's launches a
              micro-step); the wall a micro-step fused and unfused, one
              replay's busy time and idle share, capture seconds and pool
              bytes; the CLI with --fused_steps 16 on the adp phase's
              files (two epochs, then --resume with --profile)
  9. time     CUDA-event medians (>= 20 runs after warm-up) of each kernel
              and its plain version, and their device time alone (profiler,
              without the host's launch overhead), the bound for the same
              work, K3's index_add_ time and the [E, d] x [d, 5120] GEMM
              beside K7, cuBLAS's products beside K1, K5, K6 and K8, the
              device time per pass of K1's and K7's f32 passes (K1 also in
              its f32 training layout), of K4's (rows, fold) and of K5's,
              K6's and K8's passes (tile, weights, reduce) in bf16 and f32,
              K7's bf16 l1 / l2 with f32 and bf16 a, one CartNet layer's
              whole backward through the default path and through the
              merged one, the forward times per batch (CartNet,
              eComformer, iComformer; bf16, then f32 through the kernels
              against the plain versions) and the train micro-step times
              (CartNet default and merged in turns, eComformer,
              iComformer; then the f32 micro-steps of the three models
              and the Jarvis batch-64 f32 CartNet micro-step),
              and one profiled forward and micro-step of each model, path
              and dtype (device time by kernel, idle share of the device)
  10. kernels the summary line {"kernels": [...]}, with each kernel's
              launches per micro-step in the chunks phase and on the fused
              path (at the warm-up and capture, and
              in one replay by CUDA name)
The last line is {"ok": true, "device": {...}}; any failure raises before it
(exit code != 0). Without a GPU, or without the repository beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}  # tensor-core bf16; f32 FMA
# max |kernel - plain| / max |plain|: f32 elementwise outputs; f32 sums over
# all edges (weight/bias gradients, dscale/dshift, dxi/dxj: 2*10^4-term
# sums in another order); anything that bf16 rounding touches
CHECK_TOL = {"f32": 1e-5, "sum": 1e-4, "bf16": 1e-2}
PRED_TOL = 3e-2  # bf16 forward / train step, kernels vs plain, normalized
# f32 train step, kernels vs plain: 10x the largest per-parameter error of
# the port's f32 step against the JAX package in the CPU tests (1.4e-4)
F32_STEP_TOL = 1e-3
# bf16 train step (bf16_grad_gate): the kernels' gradients may differ from
# the plain versions' by GATE_SPREAD times the spread of two honest plain
# implementations, plus GATE_NOISE times the plain path's distance from the
# f32 gradients, plus PRED_TOL. Chosen from the readings of two
# ``kernel_ab gate`` sweeps and two runs of this script's own gates (NVIDIA
# H100 80GB HBM3, 700.00 W): 122 honest runs stayed within 0.50 of that
# limit, and all 24 runs through K5 builds that are wrong went beyond 1.4
# times it (two later sweeps: within 0.43, beyond 1.18).
GATE_SPREAD, GATE_NOISE = 8, 0.2
RUNS = 30
# csrc sources: K1, K2, K4, K5 (CartNet), K3, K7, K8 (eComformer); K6 is
# the second entry point of edge_phase_bwd.cu
CARTNET_KERNELS = ("edge_phase_fwd", "sigma_segsum_fwd", "sigma_segsum_bwd",
                   "edge_phase_bwd")
SOURCES = CARTNET_KERNELS + ("segment_sum_csr", "tp_contract_fwd",
                             "tp_contract_bwd")
# kernel names: the sources' and K6, the merged CartNet backward
KERNELS = SOURCES + ("edge_phase_merged_bwd",)
# CartNet launches per train micro-step under CARTNET_MERGED=1
MERGED_MICRO = dict(edge_phase_fwd=4, sigma_segsum_fwd=4,
                    edge_phase_merged_bwd=4)
TRAIN_MICRO_STEPS, TRAIN_ACCUM = 32, 16
# the Comformers' training phases: one optimizer update at TRAIN_ACCUM
COMFORMER_STEPS = 16
# eComformer launches per forward (serving) and per train micro-step
ECO_FWD = dict(edge_phase_fwd=3, sigma_segsum_fwd=3, segment_sum_csr=2,
               tp_contract_fwd=2)
ECO_MICRO = dict(ECO_FWD, segment_sum_csr=7, sigma_segsum_bwd=3,
                 edge_phase_bwd=3, tp_contract_bwd=2)
# iComformer launches per forward (four convs; the edge update is plain
# PyTorch) and per train micro-step (K3: the q gathers' backward)
ICO_FWD = dict(edge_phase_fwd=4, sigma_segsum_fwd=4)
ICO_MICRO = dict(ICO_FWD, segment_sum_csr=4, sigma_segsum_bwd=4,
                 edge_phase_bwd=4)
# widths besides the flagship's 256 that the widths phase drives: the
# CartNet edge kernels below their 128-column granule (zero-padded inside
# the wrappers) and up to MAX_WIDTH; the eComformer's TP kernels likewise
CARTNET_WIDTHS = (32, 64, 96, 384, 512)
ECO_WIDTHS = (64, 384, 512)
E_MAIN = 20992  # the main path's padded edges (2 batches of 4 crystals)
# K5/K6's passes, by the CUDA kernel's name
BWD_PASSES = (("tile", "edge_bwd_tile"), ("weights", "edge_bwd_weights"),
              ("reduce", "edge_bwd_reduce"))
# K8's passes (bf16 and f32: tile, weights, reduce)
TP_BWD_PASSES = (("tile", "tp_bwd_tile"), ("weights", "tp_bwd_weight"),
                 ("reduce", "tp_bwd_reduce"))
# K1's f32-edge passes (pre tiles, gate / sender tiles) and K7's f32 ones
# (tile pass, reduce of its partial tables)
K1_PASSES = (("pre", "edge_fwd_pre_f32"), ("out", "edge_fwd_out_f32"))
K7_PASSES = (("tile", "tp_fwd_tile_f32"), ("reduce", "tp_fwd_reduce_f32"))
# K4's passes, bf16 and f32 (row pass, column pass over its partial rows)
K4_PASSES = (("rows", "sigma_bwd_rows"), ("fold", "sigma_bwd_fold"))
# the CUDA kernels one call of each wrapper launches at its own width, in
# bf16 and in f32 (K1: its edge dtype; K7: h's), by a piece of the kernels'
# names
_SAME = lambda launches: {"bf16": launches, "f32": launches}
LAUNCHES = {
    "edge_phase_fwd": {"bf16": {"edge_phase_fwd_tc": 1},
                       "f32": {sub: 1 for _, sub in K1_PASSES}},
    "sigma_segsum_fwd": _SAME({"sigma_segsum_fwd_kernel": 1}),
    "sigma_segsum_bwd": _SAME({sub: 1 for _, sub in K4_PASSES}),
    "edge_phase_bwd": _SAME({sub: 1 for _, sub in BWD_PASSES}),
    "edge_phase_merged_bwd": _SAME({sub: 1 for _, sub in BWD_PASSES}),
    "segment_sum_csr": _SAME({"segment_sum_csr_kernel": 1}),
    "tp_contract_fwd": {"bf16": {"tp_fwd_tc": 1},
                        "f32": {sub: 1 for _, sub in K7_PASSES}},
    "tp_contract_bwd": _SAME({sub: 1 for _, sub in TP_BWD_PASSES}),
}
# K1's CUDA kernels in one bf16 iComformer forward: conv0's bf16 kernel,
# conv1-conv3's f32 passes (f32 edges after the eval edge update)
ICO_K1_BF16_FWD = {**LAUNCHES["edge_phase_fwd"]["bf16"],
                   **{k: 3 * v for k, v in
                      LAUNCHES["edge_phase_fwd"]["f32"].items()}}
# profiler captures of one timing at most (``cuda_events``), and the spin
# kernels around each capture's calls (``_capture``): their name, length
# (~0.1 ms each) and number at each end
CAPTURES = 10
GUARD_KERNEL, GUARD_CYCLES, GUARDS = "spin_kernel", 200_000, 10


def launches_of(kname: str, dt) -> dict:
    """``LAUNCHES`` of wrapper ``kname`` whose kernel runs in ``dt`` (K1:
    the edge dtype; K7: h's dtype; a torch dtype)."""
    return LAUNCHES[kname]["bf16" if str(dt).endswith("bfloat16")
                           else "f32"]


def emit(**obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def normalized_err(a, b) -> tuple:
    a, b = a.float(), b.float()
    abs_err = float((a - b).abs().max()) if a.numel() else 0.0
    scale = float(b.abs().max()) if b.numel() else 0.0
    return abs_err, abs_err / max(scale, 1e-30)


def cuda_median_ms(fn, runs: int = RUNS) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _capture(fn, calls: int, cpu: bool = False) -> tuple:
    """One torch.profiler (CUPTI) capture of ``calls`` calls of ``fn``
    between ``GUARDS`` spin kernels (``torch.cuda._sleep``) at each end,
    each end closed by a synchronize: the profiler now and then loses the
    first or the last kernels of a capture (every capture of a run lost
    its first two on one machine, PR 14), and the spins are lost instead
    of ``fn``'s -> (``fn``'s CUDA events, the spin kernels caught, wall ms
    of the calls to their synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        for _ in range(GUARDS):
            torch.cuda._sleep(GUARD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(GUARDS):
            torch.cuda._sleep(GUARD_CYCLES)
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    kept = [ev for ev in evs if GUARD_KERNEL not in ev.name]
    return kept, len(evs) - len(kept), wall_ms


def cuda_events(fn, calls: int, kernels=None) -> list:
    """The CUDA kernel events of ``calls`` calls of ``fn`` (``_capture``),
    after a warm-up call. The profiler now and then drops some of a
    capture's kernels, so only a complete capture counts: one with a whole
    number of kernels per call and, for each ``name: n`` of ``kernels``
    (the CUDA launches of a wrapper, by a piece of the kernels' names),
    exactly ``calls * n`` kernels of that name. ``fn`` is captured until
    two complete captures hold the same number of kernels (at most
    ``CAPTURES`` captures), and that capture is returned; the run fails
    when none does."""
    import torch
    kernels = kernels or {}
    fn()
    torch.cuda.synchronize()
    complete, counts = set(), []
    for _ in range(CAPTURES):
        evs, guards, _ = _capture(fn, calls)
        counts.append((len(evs), guards))
        if not evs or len(evs) % calls or any(
                sum(name in ev.name for ev in evs) != calls * n
                for name, n in kernels.items()):
            continue
        if len(evs) in complete:
            return evs
        complete.add(len(evs))
    fail(f"no two complete profiler captures of {calls} calls agree "
         f"((kernels, spin kernels) a capture: {counts}; expected per "
         f"call: {kernels})")


def device_ms(fn, calls: int = 10, kernels=None) -> float:
    """Device time per call of ``fn``: the durations of the CUDA kernels it
    launches in a complete profiler capture of ``calls`` calls
    (``cuda_events``; ``kernels`` as there), summed and divided by the
    calls. Unlike ``cuda_median_ms`` it leaves out the host's time between
    the launches, which the events of a single small call include."""
    evs = cuda_events(fn, calls, kernels)
    return sum(ev.device_time for ev in evs) / 1e3 / calls


def kernel_name(mangled: str) -> str:
    """A readable kernel name from ptxas's mangled one: the innermost name
    of the nested name and its template arguments."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, parts = 3, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    rest = mangled[i:]
    args = rest[1:rest.index("E")] if rest.startswith("I") else ""
    for raw, nice in (("Lb0", "false"), ("Lb1", "true"),
                      ("13__nv_bfloat16", "bf16"), ("f", "float")):
        if args == raw:
            args = nice
    return parts[-1] + (f"<{args}>" if args else "")


def ptxas_report(log: str) -> list:
    """Registers, spills and static shared memory of each kernel of a
    source, from ``nvcc -Xptxas -v`` (dynamic shared memory is set at
    launch)."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = {"kernel": kernel_name(m.group(1))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = (int(m.group(1)),
                                                       int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return rows


def pass_device_ms(fn, kernels: dict, calls: int = 10,
                   passes=BWD_PASSES) -> dict:
    """Device time per call of each of a kernel's passes (profiler, a
    complete capture as ``cuda_events`` takes it, with ``kernels`` the
    wrapper's launches; K5/K6's three passes by default, K8's with
    ``TP_BWD_PASSES``), the rest of the call's kernels, and the pass
    kernels per call: {tile, weights, reduce, other, kernels_per_call}."""
    evs = cuda_events(fn, calls, kernels)
    keys = [k for k, _ in passes]
    sums = dict.fromkeys(keys + ["other"], 0.0)
    n_pass = 0
    for ev in evs:
        key = next((k for k, sub in passes if sub in ev.name), "other")
        sums[key] += ev.device_time / 1e3
        n_pass += key != "other"
    out = {k: v / calls for k, v in sums.items()}
    out["kernels_per_call"] = n_pass / calls
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: int, n_ops: int, op_dtype: str) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- inputs

def edge_inputs(batch, table_dt, edge_dt, d, gen, dev):
    """Random K1 operands at the batch's shapes: node tables xi [N, 2d]
    and xj over the src table's rows, edge features [E, d], weights
    U(+-1/sqrt(fan_in))."""
    import torch
    N, E = batch.num_nodes, batch.num_edges
    # xj spans the src table: N rows, or a halo member's n_per + ep H
    n_src = N if batch.src_rowptr is None else batch.src_rowptr.shape[0] - 1
    rn = lambda *s: torch.randn(*s, generator=gen).mul_(0.3)
    ru = lambda fan, *s: (torch.rand(*s, generator=gen) * 2 - 1) / math.sqrt(
        fan)
    vals = [rn(N, 2 * d).to(table_dt), rn(n_src, 2 * d).to(table_dt),
            rn(E, d).to(edge_dt), ru(3 * d, d, 2 * d).to(edge_dt),
            ru(3 * d, 2 * d).to(edge_dt), ru(d, d, d).to(edge_dt),
            ru(d, d).to(edge_dt), ru(d, d, d).to(edge_dt),
            ru(d, d).to(edge_dt)]
    return [v.to(dev) for v in vals]


def sigma_inputs(batch, gate_dt, edge_dt, d, gen, dev):
    import torch
    E = batch.num_edges
    rn = lambda *s: torch.randn(*s, generator=gen)
    gate, sender = rn(E, d).to(gate_dt), rn(E, d).mul_(0.5).to(gate_dt)
    scale = (1.0 + 0.1 * rn(d)).float()
    shift = (0.5 * rn(d)).float()
    env = torch.rand(E, 1, generator=gen).to(gate_dt)
    e_in = rn(E, d).to(edge_dt)
    return [t.to(dev) for t in (gate, scale, shift, env, sender, e_in)]


def edge_cost(args, outs, d, E, op_dtype):
    """Bytes (each input read once, each output written once) and
    operations (the three matmuls; the elementwise part is below 1%)."""
    n_ops = 2 * E * d * (2 * d) + 2 * 2 * E * d * d
    return bound(nbytes(*args) + nbytes(*outs), n_ops, op_dtype)


def sigma_cost(args, outs, real_edges: int):
    """K2's ``args`` (gate, scale, shift, env, sender, e_in, mask, rowptr)
    and outputs. Bytes: each read once and each written once, the sender
    rows only at the masked-in edges (a pad's e_out needs none). Operations
    per element: scale, shift, exp, add, divide, envelope and residual add
    at every edge; sender product and accumulate at the masked-in ones."""
    E, d = args[0].shape
    sender = args[4]
    n_bytes = (nbytes(*args[:4], *args[5:]) + nbytes(*outs)
               + real_edges * d * sender.element_size())
    return bound(n_bytes, 7 * E * d + 2 * real_edges * d, "f32")


def sigma_bwd_cost(args, outs, E, d):
    # per element ~20 f32 operations (sigmoid chain, products, three sums)
    return bound(nbytes(*args) + nbytes(*outs), 20 * E * d, "f32")


def edge_bwd_cost(args, outs, d, E, op_dtype):
    """dh = [dg|ds] @ W1^T, de = dpre @ We^T, dWe, dW1g, dW1a: 16 E d^2."""
    return bound(nbytes(*args) + nbytes(*outs), 16 * E * d * d, op_dtype)


def profile_call(fn, top: int = 10) -> dict:
    """One profiled call of ``fn`` after a warm-up call (``_capture``):
    device time by kernel name, the device's busy time against the wall
    time, and the number of device kernels. The call is profiled until two
    captures hold the same number of kernels (at most ``CAPTURES``; the
    profiler drops kernels now and then, ``cuda_events``), and the second
    is returned."""
    import torch
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(CAPTURES):
        evs, _, wall_ms = _capture(fn, 1, cpu=True)
        if evs and len(evs) in counts:
            break
        counts.append(len(evs))
    else:
        fail(f"no two profiler captures of one call agree (kernels a "
             f"capture: {counts})")
    kern = {}
    for ev in evs:
        kern[ev.name] = kern.get(ev.name, 0.0) + ev.device_time / 1e3
    busy = sum(kern.values())
    ranked = sorted(kern.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if wall_ms else None,
            "device_kernels": len(evs),
            "top_kernels_ms": [[name[:80], ms] for name, ms in ranked]}


def check_outputs(card, kernel, case, names, got, again, want, tol_of,
                  **extra) -> float:
    """One check line per kernel call: each output against the plain
    version, with a bitwise repeat; fails outside tolerance. -> the largest
    abs error."""
    import torch
    outputs, bad = {}, []
    for oname, g, a, w in zip(names, got, again, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{kernel} {case} {oname}: {g.dtype}{tuple(g.shape)} vs "
                 f"{w.dtype}{tuple(w.shape)}")
        abs_err, rel = normalized_err(g, w)
        bitwise = bool(torch.equal(g, a))
        tol = tol_of(oname)
        outputs[oname] = dict(dtype=str(g.dtype).replace("torch.", ""),
                              max_abs_err=abs_err, max_rel_err=rel, tol=tol,
                              bitwise_repeat=bitwise)
        if not (rel <= tol and bitwise and math.isfinite(abs_err)):
            bad.append(oname)
    emit(phase="check", card=card, kernel=kernel, case=case, **extra,
         outputs=outputs)
    if bad:
        fail(f"{kernel} {case}: {bad} outside tolerance or not bitwise "
             f"repeatable")
    return max(o["max_abs_err"] for o in outputs.values())


def backward_inputs(batch, dt, d, gen, dev):
    """K5 and K4 operands at the batch's shapes in the training dtype
    ``dt``: K5's saved residual, gate and window moments come from a K1
    run; cotangents are random and zero on pad-edge rows, as the model's
    are. -> (K5 args, K4 args), in the wrappers' argument order."""
    import torch
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    E, N = batch.num_edges, batch.num_nodes
    m = batch.edge_mask[:, None]
    rn = lambda *s: torch.randn(*s, generator=gen).to(dev)
    cot = lambda: (rn(E, d) * m).to(dt)
    args = edge_inputs(batch, dt, dt, d, gen, dev)
    idx = (batch.edge_dst, batch.edge_src, batch.edge_mask)
    gate, _, saved, s1w, _ = ek.edge_phase_fwd(*args, *idx, saved=True,
                                               moments=True)
    nt = s1w.shape[0]
    n_w = batch.edge_mask.reshape(nt, -1).sum(dim=1,
                                              dtype=torch.float32)[:, None]
    edge = (args[2], args[3], args[5], args[7], saved, gate,
            s1w / torch.clamp(n_w, min=1.0), 0.01 * rn(nt, d),
            0.01 * rn(nt, d), cot(), cot(), cot(), *idx, batch.dst_rowptr,
            batch.edge_src_perm, batch.src_rowptr)
    sig = sigma_inputs(batch, dt, dt, d, gen, dev)
    sigma = (*sig[:5], cot(), rn(N, d).to(dt), batch.edge_dst,
             batch.edge_mask)
    return edge, sigma


EDGE_BWD_OUT = ("de", "dxi", "dxj", "dwe", "db", "dw1g", "db1g", "dw1a",
                "db1a")
SIGMA_BWD_OUT = ("dgate", "dscale", "dshift", "denv", "dsender")


def edge_bwd_plain(*a, live=None):
    """K5's plain version with the wrapper's arguments (its dst and src
    row counts from the two rowptrs); ``live`` is ignored, as by
    ``edge_phase_fwd_plain``: the plain version sums every edge."""
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    return ek.edge_phase_bwd_plain(*a[:15], a[15].shape[0] - 1,
                                   a[17].shape[0] - 1)


def merged_bwd_plain(*a, live=None):
    """K6's plain version with the wrapper's arguments (its src row count
    from src_rowptr); ``live`` is ignored, as by ``edge_bwd_plain``."""
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    return ek.merged_bwd_plain(*a[:18], a[20].shape[0] - 1)


def merged_inputs(batch, dt, d, gen, dev):
    """K6 operands at the batch's shapes in the training dtype ``dt``, in
    the wrapper's argument order: the pre-only residual, gate, sender and
    window moments from a K1 run; random env, scale/shift, window
    cotangents, daggr, and deout zero on pad-edge rows, as the model's is.
    -> (K6 args, K1 args)."""
    import torch
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    E, N = batch.num_edges, batch.num_nodes
    rn = lambda *s: torch.randn(*s, generator=gen).to(dev)
    args = edge_inputs(batch, dt, dt, d, gen, dev)
    idx = (batch.edge_dst, batch.edge_src, batch.edge_mask)
    gate, sender, pre, s1w, _ = ek.edge_phase_fwd(
        *args, *idx, saved=True, pre_only=True, moments=True)
    nt = s1w.shape[0]
    n_w = batch.edge_mask.reshape(nt, -1).sum(dim=1,
                                              dtype=torch.float32)[:, None]
    sig = sigma_inputs(batch, dt, dt, d, gen, dev)
    merged = (args[2], args[3], args[5], args[7], pre, gate, sender, sig[3],
              sig[1], sig[2], s1w / torch.clamp(n_w, min=1.0),
              0.01 * rn(nt, d), 0.01 * rn(nt, d),
              (rn(E, d) * batch.edge_mask[:, None]).to(dt),
              rn(N, d).to(dt), *idx, batch.dst_rowptr, batch.edge_src_perm,
              batch.src_rowptr)
    return merged, args


def sigma_fwd_plain(*a):
    """K2's plain version with the wrapper's arguments."""
    from cartnet_tpu_torch.ops.kernels import segment_kernels as sk
    return sk.sigma_segsum_plain(*a[:8], a[9])


def row_offset_view(t):
    """t's values in a contiguous view one row into a buffer one row
    longer: a base d elements past the allocation's start, which K2's
    vector route needs to be a multiple of 16 bytes (else its scalar route
    runs)."""
    import torch
    buf = torch.empty((t.shape[0] + 1,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


def odd_width_checks(card, batch, gen, dev, widths=(36, 33)) -> None:
    """K2 in its four gate / edge dtype combinations and K3 (scatter onto
    sources with perm, sorted-gather backward without) in bf16 and f32 at
    widths that are not a multiple of 8, on fresh tensors and on views one
    row into a larger buffer (``row_offset_view``): between them K2 runs
    its vector and its scalar (AL = false) route in every dtype, and K3
    (one feature a thread) reads unaligned rows. Each against its plain
    version, with bitwise repeats."""
    import torch
    from cartnet_tpu_torch.ops.kernels import segment_kernels as sk
    from cartnet_tpu_torch.ops.kernels import segsum_kernels as k3
    bf, f32 = torch.bfloat16, torch.float32
    N, E = batch.num_nodes, batch.num_edges
    for d in widths:
        for gdt, edt in ((bf, bf), (f32, bf), (bf, f32), (f32, f32)):
            tol = CHECK_TOL["f32" if gdt == edt == f32 else "bf16"]
            a = sigma_inputs(batch, gdt, edt, d, gen, dev)
            for view in ("", "_offset"):
                if view:
                    a = [row_offset_view(x) if x.dim() == 2 and
                         x.shape[1] == d else x for x in a]
                tail = (batch.edge_dst, batch.edge_mask, batch.dst_rowptr, N)
                got, again = (sk.sigma_segsum(*a, *tail) for _ in range(2))
                want = sk.sigma_segsum_plain(*a, *tail[:2], N)
                torch.cuda.synchronize()
                check_outputs(card, "sigma_segsum_fwd",
                              f"d{d}_{str(gdt)[6:]}_{str(edt)[6:]}{view}",
                              ("e_out", "aggr"), got, again, want,
                              lambda _, t=tol: t)
        for dt in (bf, f32):
            tol = CHECK_TOL["sum" if dt == f32 else "bf16"]
            for form in ("perm", "dst"):
                if form == "perm":
                    a = list(seg_args(batch, dt, d, gen, dev))
                else:
                    ct = (torch.randn(E, d, generator=gen).to(dev)
                          * batch.edge_mask[:, None]).to(dt)
                    a = [ct, batch.dst_rowptr, batch.edge_mask]
                for view in ("", "_offset"):
                    if view:
                        a[0] = row_offset_view(a[0])
                    got, again = (k3.segment_sum_csr(*a) for _ in range(2))
                    want = k3.segment_sum_csr_plain(*a)
                    torch.cuda.synchronize()
                    check_outputs(card, "segment_sum_csr",
                                  f"d{d}_{str(dt)[6:]}_{form}{view}",
                                  ("out",), (got,), (again,), (want,),
                                  lambda _, t=tol: t)


def seg_args(batch, dt, width, gen, dev):
    """K3 operands as the eComformer's scatter onto sources gives them:
    random values [E, width], the src sort's rowptr, mask and perm."""
    import torch
    v = torch.randn(batch.num_edges, width, generator=gen).to(dt).to(dev)
    return (v, batch.src_rowptr, batch.edge_mask_src_sorted,
            batch.edge_src_perm)


def seg_cost(args, out, real_edges: int):
    """Bytes: the masked-in value rows (pads are never read), the index
    arrays and the output; one f32 add per value read."""
    v = args[0]
    n_bytes = (real_edges * v.shape[1] * v.element_size()
               + nbytes(*args[1:]) + nbytes(out))
    return bound(n_bytes, real_edges * v.shape[1], "f32")


def tp_args(batch, hdt, adt, d, gen, dev):
    """K7 operands at the batch's shapes: fc hidden h [E, d] (softplus of
    a normal, as the fc gives it), a0 [E, 64], a1/a2 [E, 8], the fc's
    second layer wt [5120, d] and b [5120], U(+-1/sqrt(d))."""
    import torch
    import torch.nn.functional as F
    E = batch.num_edges
    rn = lambda *s: torch.randn(*s, generator=gen)
    ru = lambda *s: (torch.rand(*s, generator=gen) * 2 - 1) / math.sqrt(d)
    vals = dict(h=F.softplus(rn(E, d)).to(hdt), a0=rn(E, 64).to(adt),
                a1=rn(E, 8).to(adt), a2=rn(E, 8).to(adt),
                wt=ru(5120, d).to(hdt), b=ru(5120).to(hdt))
    return {k: v.to(dev) for k, v in vals.items()}


def tp_calls(a):
    """(l1 args, l2 args) of the K7 entries."""
    return ((a["h"], a["a0"], a["wt"], a["b"]),
            (a["h"], a["a0"], a["a1"], a["a2"], a["wt"], a["b"]))


def tp_plain(l2: bool):
    """K7's plain version with an entry's arguments."""
    from cartnet_tpu_torch.ops.kernels import tp_kernels as k7
    if l2:
        return lambda h, a0, a1, a2, wt, b: k7.tp_contract_plain(
            k7.PATHS_L2, h, [a0, a1, a2], wt, b)
    return lambda h, a, wt, b: k7.tp_contract_plain(k7.PATHS_L1, h, [a], wt,
                                                    b)


def tp_cost(args, outs):
    """The weight-generation GEMM (2 E d 5120) and one multiply-add per
    generated weight; bytes: every operand and output once."""
    h = args[0]
    E, d = h.shape
    n_ops = 2 * E * d * 5120 + 2 * E * 5120
    return bound(nbytes(*args) + nbytes(*outs), n_ops,
                 "bf16" if h.dtype.itemsize == 2 else "f32")


TP_BWD_OUT = {False: ("dh", "da", "dwt", "db"),
              True: ("dh", "da0", "da1", "da2", "dwt", "db")}


def tp_bwd_args(targs, l2: bool, mask, gen):
    """K8 operands: K7's (h, a..., wt, b) and random cotangents of its
    outputs ([E,64]/[E,8]/[E,8] for l1, [E,64] for l2) in h's dtype, zero
    on pad-edge rows. -> (paths, h, a_list, wt, b, dc_list)."""
    import torch
    from cartnet_tpu_torch.ops.kernels import tp_kernels as k7
    h = targs["h"]
    E = h.shape[0]
    dc = [(torch.randn(E, w, generator=gen).to(h.device) * mask[:, None])
          .to(h.dtype) for w in ((64,) if l2 else (64, 8, 8))]
    a = [targs["a0"], targs["a1"], targs["a2"]] if l2 else [targs["a0"]]
    return (k7.PATHS_L2 if l2 else k7.PATHS_L1, h, a, targs["wt"],
            targs["b"], dc)


def tp_bwd_flat(out):
    """(dh, [da...], dwt, db) -> a flat list."""
    return [out[0], *out[1], out[2], out[3]]


def tp_bwd_cost(args, outs):
    """The three E x d x 5120 products (the w_all recompute, dh, dwt) and
    a few operations per generated weight; bytes: every operand and output
    once."""
    h = args[1]
    E, d = h.shape
    n_ops = 3 * 2 * E * d * 5120 + 6 * E * 5120
    n_bytes = nbytes(h, *args[2], args[3], args[4], *args[5],
                     *tp_bwd_flat(outs))
    return bound(n_bytes, n_ops, "bf16" if h.dtype.itemsize == 2 else "f32")


@contextlib.contextmanager
def plain_ecomformer_kernels():
    """Route the eComformer's kernel calls, forward and backward, to the
    plain versions (the train path's K1/K2/K4/K5 through plain_kernels)."""
    from cartnet_tpu_torch.models import comformer as cm
    from cartnet_tpu_torch.ops import segment as seg
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    from cartnet_tpu_torch.ops.kernels import segsum_kernels as k3
    from cartnet_tpu_torch.ops.kernels import tp_kernels as k7
    kept = (cm.edge_phase_fwd, cm.sigma_segsum, seg.segment_sum_csr,
            k7.tp_contract_l1, k7.tp_contract_l2, k7.tp_contract_bwd)
    cm.edge_phase_fwd, cm.sigma_segsum = (ek.edge_phase_fwd_plain,
                                          sigma_fwd_plain)
    seg.segment_sum_csr = k3.segment_sum_csr_plain
    k7.tp_contract_l1, k7.tp_contract_l2 = tp_plain(False), tp_plain(True)
    k7.tp_contract_bwd = k7.tp_contract_bwd_plain
    try:
        with plain_kernels():
            yield
    finally:
        (cm.edge_phase_fwd, cm.sigma_segsum, seg.segment_sum_csr,
         k7.tp_contract_l1, k7.tp_contract_l2, k7.tp_contract_bwd) = kept


@contextlib.contextmanager
def plain_kernels():
    """Route the training path's kernel calls (K1, K2, K4, K5 and the
    merged path's K6) to the plain versions."""
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    from cartnet_tpu_torch.ops.kernels import segment_kernels as sk
    kept = (ek.edge_phase_fwd, ek.edge_phase_bwd, ek.merged_bwd,
            sk.sigma_segsum, sk.sigma_segsum_bwd)
    ek.edge_phase_fwd, ek.edge_phase_bwd, ek.merged_bwd = (
        ek.edge_phase_fwd_plain, edge_bwd_plain, merged_bwd_plain)
    sk.sigma_segsum, sk.sigma_segsum_bwd = (sigma_fwd_plain,
                                            sk.sigma_segsum_bwd_plain)
    try:
        yield
    finally:
        (ek.edge_phase_fwd, ek.edge_phase_bwd, ek.merged_bwd,
         sk.sigma_segsum, sk.sigma_segsum_bwd) = kept


@contextlib.contextmanager
def plain_cartnet_forward():
    """Route the CartNet forward's kernel calls (K1, K2) to the plain
    versions."""
    from cartnet_tpu_torch.models import cartnet as model_mod
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    kept = (model_mod.edge_phase_fwd, model_mod.sigma_segsum)
    model_mod.edge_phase_fwd, model_mod.sigma_segsum = (
        ek.edge_phase_fwd_plain, sigma_fwd_plain)
    try:
        yield
    finally:
        model_mod.edge_phase_fwd, model_mod.sigma_segsum = kept


def forward_vs_plain(card, model, batch, plain, expect, tol,
                     phase="widths_forward", **tags) -> None:
    """One eval forward through the kernels (its launch counts must be
    ``expect``) against the same forward through the plain versions
    (``plain``, a context): finite predictions within ``tol`` normalized."""
    import torch
    model.eval()
    with torch.inference_mode():
        launch_counts(reset=True)
        pk, mask = model(batch)
        torch.cuda.synchronize()
        got = launch_counts()
        with plain():
            pp, _ = model(batch)
    m = mask.bool()
    abs_err, rel = normalized_err(pk[m], pp[m])
    finite = bool(torch.isfinite(pk[m]).all())
    emit(phase=phase, card=card, **tags, launches=got,
         expected_launches=expect, max_abs_err=abs_err, max_rel_err=rel,
         tol=tol, finite=finite)
    if got != expect or not finite or not rel <= tol:
        fail(f"forward {tags}: launches {got} (expected {expect}), finite "
             f"{finite}, rel err {rel}")


@contextlib.contextmanager
def merged_path(on: bool = True):
    """Set CARTNET_MERGED (the CartNet train layer reads it at each
    forward) for the enclosed phase and restore it after."""
    kept = os.environ.get("CARTNET_MERGED")
    os.environ["CARTNET_MERGED"] = "1" if on else "0"
    try:
        yield
    finally:
        if kept is None:
            os.environ.pop("CARTNET_MERGED", None)
        else:
            os.environ["CARTNET_MERGED"] = kept


def launch_counts(reset: bool = False) -> dict:
    """Each kernel wrapper's launch count (optionally set to 0 first)."""
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    from cartnet_tpu_torch.ops.kernels import segment_kernels as sk
    from cartnet_tpu_torch.ops.kernels import segsum_kernels as k3
    from cartnet_tpu_torch.ops.kernels import tp_kernels as k7
    if reset:
        ek.launches = sk.launches = ek.bwd_launches = sk.bwd_launches = 0
        k3.launches = k7.launches = k7.bwd_launches = 0
        ek.merged_launches = 0
    return dict(zip(KERNELS, (ek.launches, sk.launches, sk.bwd_launches,
                              ek.bwd_launches, k3.launches, k7.launches,
                              k7.bwd_launches, ek.merged_launches)))


def layer_group(name: str) -> str:
    """The layer a parameter belongs to: encoder, layers.i, head (conv0,
    equi, ... for the eComformer)."""
    return ".".join(name.split(".")[:2 if name.startswith("layers") else 1])


def grad_errors(names, got, want) -> dict:
    """max |kernel - plain| of each gradient over the largest gradient entry
    of its layer (``layer_group``). Per-parameter normalization is
    ill-posed here: under train BN some gradients (the gate MLP's biases)
    cancel to a small remainder of large per-edge terms, and in bf16 that
    remainder is mostly rounding noise."""
    scale = {}
    for n, w in zip(names, want):
        g = layer_group(n)
        scale[g] = max(scale.get(g, 0.0), float(w.float().abs().max()))
    return {n: normalized_err(g, w)[0] / max(scale[layer_group(n)], 1e-30)
            for n, g, w in zip(names, got, want)}


def bf16_grad_gate(names, got, plain, alt, ref, tol) -> dict:
    """The bf16 gradient gate. For each layer group (``layer_group``), with
    distances over all of the group's entries together, each over the norm
    of the group's f32 gradients ``ref`` at the same weights: the kernels'
    gradients (``got``) may differ from the plain versions' (``plain``) by
    ``GATE_SPREAD`` times the distance between two honest plain
    implementations (``alt``: the same step with K1's plain version summing
    in a permuted order, ``plain_k1_permuted``, as the kernel sums in its
    own), plus ``GATE_NOISE`` times the plain versions' distance from the
    f32 gradients, plus ``tol``.
    Under train BN each bf16 gradient carries rounding noise that compounds
    over the layers, at times larger than the gradient itself, and the
    kernels share nearly all of it with the plain versions. Where a BN
    channel's spread is about one bf16 ulp, one rounding taken otherwise
    moves its variance and the kernels part from the plain path; the two
    plain implementations then part as far, and the first term allows it.
    The second allows the other kernels' own roundings, a small share of
    the noise. A whole group, not one parameter, is held: one parameter's
    distance can rest on one such rounding. The distances from f32 are
    reported. -> {"groups": {group: {kernels, plain, kernels_vs_plain,
    plain_vs_alt, limit, share}}, "worst": the group nearest its limit,
    "failed": the groups above it}."""
    import torch
    sums = {}
    for n, k, p, a, r in zip(names, got, plain, alt, ref):
        k, p, a, r = k.double(), p.double(), a.double(), r.double()
        acc = sums.setdefault(layer_group(n), [0.0] * 5)
        for i, (x, y) in enumerate(((k, r), (p, r), (k, p), (a, p))):
            acc[i] += float(torch.sum((x - y) ** 2))
        acc[4] += float(torch.sum(r * r))
    groups = {}
    for g, acc in sums.items():
        norm = max(math.sqrt(acc[4]), 1e-30)
        dk, dp, kp, ap = (math.sqrt(x) / norm for x in acc[:4])
        limit = GATE_SPREAD * ap + GATE_NOISE * dp + tol
        groups[g] = dict(kernels=dk, plain=dp, kernels_vs_plain=kp,
                         plain_vs_alt=ap, limit=limit, share=kp / limit)
    return {"groups": groups,
            "worst": max(groups, key=lambda g: groups[g]["share"]),
            "failed": [g for g, v in groups.items()
                       if not v["share"] <= 1.0]}


@contextlib.contextmanager
def plain_k1_permuted():
    """Inside a plain context: K1's plain version on operands whose inner
    dimensions (e @ We's d, the gate and aggregate halves of h) are
    permuted, its residual permuted back: the same function, a second
    honest implementation of the step whose f32 sums add in another order,
    as the kernel's do."""
    import torch
    from cartnet_tpu_torch.models import comformer as cm
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    plain_k1 = ek.edge_phase_fwd_plain

    def permuted(xi, xj, e, we, b, w1g, b1g, w1a, b1a, dst, src, emask,
                 **kw):
        d, dev = w1g.shape[0], e.device
        gen = torch.Generator().manual_seed(0)
        pd, pg, pa = (torch.randperm(d, generator=gen).to(dev)
                      for _ in range(3))
        p2 = torch.cat([pg, d + pa])
        gate, sender, res, s1w, m2w = plain_k1(
            xi[:, p2], xj[:, p2], e[:, pd], we[pd][:, p2], b[p2], w1g[pg],
            b1g, w1a[pa], b1a, dst, src, emask, **kw)
        if res is not None:  # [pre | sig] or pre, in the original order
            out = torch.empty_like(res)
            for h in range(res.shape[1] // (2 * d)):
                out[:, 2 * d * h + p2] = res[:, 2 * d * h:2 * d * (h + 1)]
            res = out
        return gate, sender, res, s1w, m2w

    kept = (ek.edge_phase_fwd, cm.edge_phase_fwd)
    ek.edge_phase_fwd = cm.edge_phase_fwd = permuted
    try:
        yield
    finally:
        ek.edge_phase_fwd, cm.edge_phase_fwd = kept


def calibrate_bn(model, batch):
    """Give ``model`` BN running stats that describe its activations on
    ``batch``: one f32 train-mode forward of the same weights with momentum
    1, whose stats it loads. With the default stats (mean 0, variance 1)
    the iComformer's four convs grow the activations until its prediction
    reaches ~1e6 at the main path's shapes, and two honest f32 forwards
    (K1's plain version summing in another order, ``plain_k1_permuted``)
    part by 7.5e-4 of it on the CPU: a serving check would measure that,
    not the kernels. Calibrated, they part by 8e-7."""
    import torch
    cfg = dataclasses.replace(model.cfg, bn_momentum=1.0,
                              compute_dtype=torch.float32)
    ref = type(model)(cfg, device=batch.z.device, seed=0)
    ref.load_state_dict(model.state_dict())
    ref.train()
    with torch.no_grad():
        ref(batch)
    model.load_state_dict(ref.state_dict())
    return model


def one_micro(cfg, model, sd, batch):
    """One micro-step of ``cfg`` from the state dict ``sd`` loaded into
    ``model`` -> (loss [1], gradients, BN buffers), all cloned."""
    import torch
    from cartnet_tpu_torch.train import loop
    model.load_state_dict(sd)
    opt = loop.build_optimizer(cfg, model.parameters(), 1)
    st, stats = loop.make_steps(cfg)[0](loop.init_train_state(model, opt),
                                        batch)
    torch.cuda.synchronize()
    return (stats["loss"].reshape(1).clone(),
            [g.clone() for g in st.grad_accum],
            [b.clone() for b in loop.bn_buffers(model)])


def with_dtype(cfg, dt):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=dt))


def train_vs_plain(card, cfg, model, batch, tol, plain=None) -> None:
    """One micro-step from the model's current state through the kernels
    and through the plain versions: loss and BN running stats normalized
    within ``tol``; gradients by grad_errors. In f32 each gradient is held
    to ``tol`` as well. In bf16 the gradients under train BN carry bf16
    rounding noise of order 10% that compounds over the layers in either
    path, so there each layer group's gradients are held to the plain
    path's as far as the plain path and a second honest implementation
    differ, with the f32 gradients at the same weights (plain versions, f32
    compute) as the scale (``bf16_grad_gate``); the per-parameter rule it
    replaced is reported beside it. ``plain``: the context that routes the
    model's kernels to their plain versions (CartNet's training kernels by
    default)."""
    import torch
    plain = plain or plain_kernels
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    pnames = [n for n, _ in model.named_parameters()]
    bnames = [n for n, _ in model.named_buffers()]
    k_loss, k_grads, k_bn = one_micro(cfg, model, sd0, batch)
    with plain():
        p_loss, p_grads, p_bn = one_micro(cfg, model, sd0, batch)
    model.load_state_dict(sd0)
    errs = {"loss": normalized_err(k_loss, p_loss)[1]}
    errs.update({n: normalized_err(a, b)[1]
                 for n, a, b in zip(bnames, k_bn, p_bn)})
    g_err = grad_errors(pnames, k_grads, p_grads)
    line = dict(model=cfg.model.name, dim_in=cfg.model.dim_in,
                merged=os.environ.get("CARTNET_MERGED") == "1",
                compute_dtype=str(cfg.model.compute_dtype), tol=tol,
                loss=float(k_loss), loss_plain=float(p_loss),
                loss_rel_err=errs["loss"],
                bn_stats_max_rel_err=max(errs[n] for n in bnames),
                grads_max_rel_err_per_layer=max(g_err.values()),
                grads_worst=max(g_err, key=g_err.get))
    bad = [n for n, e in errs.items() if e > tol]
    if cfg.model.compute_dtype == torch.float32:
        bad += [n for n, e in g_err.items() if e > tol]
    else:
        cfg32 = with_dtype(cfg, torch.float32)
        with plain():
            _, r_grads, _ = one_micro(cfg32, type(model)(
                cfg32.model, device=batch.z.device, seed=0), sd0, batch)
            with plain_k1_permuted():
                _, a_grads, _ = one_micro(cfg, model, sd0, batch)
        model.load_state_dict(sd0)
        gate = bf16_grad_gate(pnames, k_grads, p_grads, a_grads, r_grads,
                              tol)
        worst = gate["groups"][gate["worst"]]
        # the per-parameter rule the gate replaced, for comparison: each
        # gradient's distance (grad_errors) over its own limit
        k_ref = grad_errors(pnames, k_grads, r_grads)
        p_ref = grad_errors(pnames, p_grads, r_grads)
        share = {n: k_ref[n] / (2 * p_ref[n] + tol) for n in pnames}
        per_param = max(share, key=share.get)
        line.update(grads_gate_worst_group=gate["worst"],
                    grads_vs_plain=worst["kernels_vs_plain"],
                    grads_plain_vs_alt=worst["plain_vs_alt"],
                    grads_gate_limit=worst["limit"],
                    grads_gate_share_of_limit=worst["share"],
                    grads_vs_f32_kernels=worst["kernels"],
                    grads_vs_f32_plain=worst["plain"],
                    grads_gate_groups=gate["groups"],
                    per_param_rule_worst=per_param,
                    per_param_rule_share_of_limit=share[per_param])
        bad += gate["failed"]
    emit(phase="train_vs_plain", card=card, **line, failed=bad)
    if bad:
        fail(f"{cfg.model.name} train step kernels vs plain "
             f"({cfg.model.compute_dtype}): {bad}")


def merged_vs_default(card, cfg, model, batch) -> dict:
    """From the model's state, one CartNet micro-step through the default
    path (K4 + K5) and one through the merged path (K6), in bf16 and f32:
    the forward must be bitwise the same (loss, every BN buffer); the f32
    gradients within F32_STEP_TOL per layer. In bf16, each gradient's
    distance from the f32 gradient at the same weights (default path), per
    layer, through K6 and through K4 + K5: the bf16 rounding of dgate
    before the BN fold (K4 + K5) against a dgate kept in f32 until the
    fold (K6)."""
    import torch
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    pnames = [n for n, _ in model.named_parameters()]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        c = with_dtype(cfg, dt)
        m = type(model)(c.model, device=batch.z.device, seed=0)
        for merged in (False, True):
            with merged_path(merged):
                out[(dt, merged)] = one_micro(c, m, sd0, batch)
    model.load_state_dict(sd0)
    line, bad = {}, []
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        (l0, _, b0), (l1, _, b1) = out[(dt, False)], out[(dt, True)]
        same = bool(torch.equal(l0, l1)) and all(
            torch.equal(a, b) for a, b in zip(b0, b1))
        line[f"forward_bitwise_{name}"] = same
        line[f"loss_{name}"] = float(l0)
        if not same:
            bad.append(f"forward_{name}")
    ref = out[(torch.float32, False)][1]
    f32_err = grad_errors(pnames, out[(torch.float32, True)][1], ref)
    line.update(f32_grads_max_rel_err_per_layer=max(f32_err.values()),
                f32_grads_worst=max(f32_err, key=f32_err.get))
    bad += [n for n, e in f32_err.items() if e > F32_STEP_TOL]
    via_k6 = grad_errors(pnames, out[(torch.bfloat16, True)][1], ref)
    via_k45 = grad_errors(pnames, out[(torch.bfloat16, False)][1], ref)
    k6_k45 = grad_errors(pnames, out[(torch.bfloat16, True)][1],
                         out[(torch.bfloat16, False)][1])
    line.update(
        bf16_k6_vs_k4k5_max=max(k6_k45.values()),
        bf16_k6_vs_k4k5_worst=max(k6_k45, key=k6_k45.get),
        bf16_vs_f32_max_k6=max(via_k6.values()),
        bf16_vs_f32_max_k4k5=max(via_k45.values()),
        bf16_vs_f32_worst_k6=max(via_k6, key=via_k6.get),
        bf16_vs_f32_worst_k4k5=max(via_k45, key=via_k45.get),
        bf16_vs_f32_median_k6=statistics.median(via_k6.values()),
        bf16_vs_f32_median_k4k5=statistics.median(via_k45.values()),
        bf16_vs_f32_k6=via_k6, bf16_vs_f32_k4k5=via_k45)
    emit(phase="merged_vs_default", card=card, tol=F32_STEP_TOL, **line,
         failed=bad)
    if bad:
        fail(f"merged vs default micro-step: {bad}")
    return line


def adpfix_phase(card: str, dev) -> None:
    """8d. The README's product path on the adpfix fixture through the CLI
    (flagship widths, f32, SO(3) augmentation), in the working directory:
    two epochs of 8 / 2 / 2 crystals with batch_accumulation 2 (K1, K2,
    K4, K5 4 launches a micro-step, K1, K2 4 an eval forward), its
    stats.json lines (the JAX package's keys, ``iou`` in test) and both
    checkpoints; ``--resume --epochs 3`` adds exactly epoch 2; two
    Monte-Carlo rounds on best.ckpt give finite stats; one bf16 epoch.
    Then, at the layout of the README's full fixture run (all 240
    crystals, batch 4: 384 / 6144 pads, unaligned, no RCM relabeling), an
    eval forward and a train micro-step of the first augmented train batch
    through K1, K2, K4, K5 against the plain versions, in f32 and bf16."""
    import numpy as np
    import torch
    from cartnet_tpu_torch import cli, runner
    from cartnet_tpu_torch.interop import load_reference_checkpoint
    from cartnet_tpu_torch.models.factory import create_model
    argv = ["--dataset", "adpfix", "--limit", "8", "--augment",
            "--batch_accumulation", "2", "--name", "smoke"]
    run_dir = os.path.join("results", "smoke", "0")
    keys = {"epoch", "time_epoch", "time_iter", "lr", "params", "loss",
            "MAE", "MSE", "volume_percentage_error", "similarity_index",
            "edges_per_sec", "gpu_memory"}
    split_keys = {"train": keys, "val": keys | {"r2", "spearmanr"},
                  "test": keys | {"r2", "spearmanr", "iou"}}

    def per_step(micro: int, evals: int) -> dict:
        want = dict.fromkeys(KERNELS, 0)
        for k in CARTNET_KERNELS:
            want[k] = 4 * micro
        want["edge_phase_fwd"] += 4 * evals
        want["sigma_segsum_fwd"] += 4 * evals
        return want

    def lines(split: str) -> list:
        with open(os.path.join(run_dir, split, "stats.json")) as f:
            return [json.loads(x) for x in f if x.strip()]

    bad = []
    t0 = time.perf_counter()
    launch_counts(reset=True)
    state, test = cli.main(argv + ["--epochs", "2"])
    torch.cuda.synchronize()
    launches = launch_counts()
    expect = per_step(2 * 2, 2 + 1)  # 2 epochs x 2 micro; 2 val, 1 test
    if launches != expect:
        bad.append(f"launches {launches}, expected {expect}")
    got = {s: lines(s) for s in split_keys}
    for s, n in (("train", 2), ("val", 2), ("test", 1)):
        if len(got[s]) != n or any(set(r) != split_keys[s] for r in got[s]):
            bad.append(f"{s} stats.json: {got[s]}")
    best, last = runner.checkpoint_paths(run_dir)
    if not (os.path.isfile(best) and os.path.isfile(last)):
        bad.append("best.ckpt or last.ckpt missing")
    if state.step != 2 or int(state.bad_steps) or not all(
            math.isfinite(v) for v in test.values()):
        bad.append(f"{state.step} updates, {int(state.bad_steps)} bad "
                   f"steps, test {test}")
    launch_counts(reset=True)
    cli.main(argv + ["--epochs", "3", "--resume"])
    launches_resume = launch_counts()
    if launches_resume != per_step(2, 2):
        bad.append(f"resume launches {launches_resume}")
    more = {s: lines(s)[len(got[s]):] for s in split_keys}
    if [r["epoch"] for r in more["train"]] != [2] or \
            [r["epoch"] for r in more["val"]] != [2] or \
            len(more["test"]) != 1:
        bad.append(f"resume added {more}")
    args = cli.build_parser().parse_args(argv)
    cfg = cli.args_to_config(args)
    model = create_model(cfg.model, dev, cfg.seed)
    model.load_state_dict(load_reference_checkpoint(best), strict=True)
    test_pipe = runner.pipelines(cfg, cli.load_datasets(cfg.data, 8))[2]
    launch_counts(reset=True)
    mc = runner.montecarlo(cfg, model, test_pipe, "montecarlo.pkl",
                           iterations=2, device=dev)
    launches_mc = launch_counts()
    if launches_mc != per_step(0, 2 * 2 * len(test_pipe)) or not all(
            np.isfinite(v).all() for v in mc.values()):
        bad.append(f"Monte-Carlo launches {launches_mc}, stats {mc}")
    launch_counts(reset=True)
    bstate, btest = cli.main(["--dataset", "adpfix", "--limit", "8",
                              "--augment", "--batch_accumulation", "2",
                              "--name", "smoke_bf16", "--epochs", "1",
                              "--bf16"])
    launches_bf16 = launch_counts()
    if launches_bf16 != per_step(2, 2) or int(bstate.bad_steps) or not all(
            math.isfinite(v) for v in btest.values()):
        bad.append(f"bf16 run: launches {launches_bf16}, test {btest}")
    torch.cuda.synchronize()
    fcfg = cli.args_to_config(cli.build_parser().parse_args(
        ["--dataset", "adpfix", "--augment", "--batch", "4",
         "--batch_accumulation", "16"]))
    train_pipe = runner.pipelines(fcfg, cli.load_datasets(fcfg.data))[0]
    fbatch = next(iter(train_pipe)).to(dev)
    layout = dict(nodes=int(fbatch.z.shape[0]),
                  edges=int(fbatch.edge_src.shape[0]),
                  edge_align=train_pipe.edge_align)
    if layout != dict(nodes=384, edges=6144, edge_align=0):
        bad.append(f"full fixture layout {layout}")
    want_f = dict.fromkeys(KERNELS, 0)
    want_f.update(edge_phase_fwd=4, sigma_segsum_fwd=4)
    for dt, tol in ((torch.float32, F32_STEP_TOL), (torch.bfloat16,
                                                     PRED_TOL)):
        c = with_dtype(fcfg, dt)
        m = create_model(c.model, dev, c.seed)
        forward_vs_plain(card, m, fbatch, plain_cartnet_forward, want_f,
                         tol, phase="adpfix_forward", **layout,
                         compute_dtype=str(dt))
        train_vs_plain(card, c, m, fbatch, tol)
    emit(phase="adpfix", card=card, launches=launches,
         expected_launches=expect, launches_resume=launches_resume,
         launches_montecarlo=launches_mc, launches_bf16=launches_bf16,
         optimizer_steps=state.step, bad_steps=int(state.bad_steps),
         stats_lines={s: len(lines(s)) for s in split_keys},
         test=test, montecarlo={k: [float(x) for x in v]
                                for k, v in mc.items()},
         test_bf16=btest, failed=bad,
         seconds=round(time.perf_counter() - t0, 3))
    if bad:
        fail(f"adpfix phase: {bad}")


JARVIS_TARGET = "formation_energy_peratom"


def jarvis_argv(data: str) -> list:
    """The CLI flags of the Jarvis path at batch 64 (full width: the
    CLI's defaults, f32)."""
    return ["--dataset", "jarvis", "--dataset_path", data,
            "--figshare_target", JARVIS_TARGET, "--batch", "64",
            "--batch_accumulation", "1"]


def jarvis_layouts(card: str, dev):
    """8e. The Jarvis/MP scalar-property path's data and kernels: the
    committed sample (tests/fixtures/jarvis_sample.json, 100 records)
    staged as ``jarvis_data/raw/dft_3d_2021.json``, its graphs built
    through the native radius graph (``backend="native"``, which raises
    if g++ fails here; src/dst equal to the numpy graph's, dir within
    1e-5), cached for the CLI runs (``jarvis_cli``). At the batch-64
    layouts (CartNet's uncapped graph 640 / 30720, the Comformers' 25
    neighbours 640 / 12800, unaligned, 64 graphs), on the first train
    batch: a CartNet eval forward and micro-step through the kernels
    against the plain versions in f32 and bf16 (scalar head, no
    temperature), and an f32 micro-step of each Comformer. -> (the
    dataset path, the f32 CartNet micro-step on that batch for the time
    phase, its layout)."""
    import shutil
    import numpy as np
    import torch
    from cartnet_tpu_torch import cli, native, runner
    from cartnet_tpu_torch.data import jarvis
    from cartnet_tpu_torch.models.factory import create_model
    from cartnet_tpu_torch.train import loop
    data, data_np = os.path.abspath("jarvis_data"), os.path.abspath(
        "jarvis_data_numpy")
    for root in (data, data_np):
        os.makedirs(os.path.join(root, "raw"), exist_ok=True)
        shutil.copy(os.path.join(REPO, "tests", "fixtures",
                                 "jarvis_sample.json"),
                    os.path.join(root, "raw", "dft_3d_2021.json"))

    def no_download(url, dest):
        raise RuntimeError(f"chip_smoke fetches nothing ({url})")

    jarvis._fetch_with_resume = no_download  # the payload is staged
    bad = []
    t_phase = t0 = time.perf_counter()
    for mn in (-1, 25):  # the caches the CLI runs read
        recs = jarvis.build_dataset("jarvis", JARVIS_TARGET, data, 5.0, mn,
                                    backend="native")
        numpy_recs = jarvis.build_dataset("jarvis", JARVIS_TARGET, data_np,
                                          5.0, mn, backend="numpy")
        for a, b in zip(recs[0], numpy_recs[0]):
            if not (np.array_equal(a["edge_src"], b["edge_src"])
                    and np.array_equal(a["edge_dst"], b["edge_dst"])
                    and np.allclose(a["cart_dir"], b["cart_dir"],
                                    rtol=1e-5, atol=1e-6)):
                bad.append(f"native graph differs from numpy (cap {mn})")
                break
    ingest_s = time.perf_counter() - t0
    layouts, batch_of = {}, {}
    for net, extra in (("cartnet", []), ("ecomformer",
                                         ["--model", "eComformer"]),
                       ("icomformer", ["--model", "iComformer"])):
        cfg = cli.args_to_config(cli.build_parser().parse_args(
            jarvis_argv(data) + extra))
        pipe = runner.pipelines(cfg, cli.load_datasets(cfg.data))[0]
        b = next(iter(pipe)).to(dev)
        batch_of[net] = (cfg, b)
        layouts[net] = dict(nodes=int(b.z.shape[0]),
                            edges=int(b.edge_src.shape[0]),
                            real_edges=int(b.edge_mask.sum()),
                            graphs=int(b.graph_mask.sum()),
                            edge_align=pipe.edge_align)
    want_layouts = {"cartnet": (640, 30720), "ecomformer": (640, 12800),
                    "icomformer": (640, 12800)}
    for net, (n, e) in want_layouts.items():
        lo = layouts[net]
        if (lo["nodes"], lo["edges"], lo["graphs"], lo["edge_align"]) != (
                n, e, 64, 0):
            bad.append(f"{net} layout {lo}")
    emit(phase="jarvis_data", card=card, ingest_seconds=round(ingest_s, 3),
         native_library=os.path.relpath(native.LIB, REPO),
         layouts=layouts, failed=bad)
    if bad:
        fail(f"jarvis data: {bad}")
    cfg, b = batch_of["cartnet"]
    want_f = dict.fromkeys(KERNELS, 0)
    want_f.update(edge_phase_fwd=4, sigma_segsum_fwd=4)
    for dt, tol in ((torch.float32, F32_STEP_TOL), (torch.bfloat16,
                                                     PRED_TOL)):
        c = with_dtype(cfg, dt)
        m = create_model(c.model, dev, c.seed)
        forward_vs_plain(card, m, b, plain_cartnet_forward, want_f, tol,
                         phase="jarvis_forward", **layouts["cartnet"],
                         compute_dtype=str(dt))
        train_vs_plain(card, c, m, b, tol)
    for net in ("ecomformer", "icomformer"):
        c, cb = batch_of[net]
        train_vs_plain(card, c, create_model(c.model, dev, c.seed), cb,
                       F32_STEP_TOL, plain_ecomformer_kernels)
    emit(phase="jarvis_checks", card=card,
         seconds=round(time.perf_counter() - t_phase, 3))
    m32 = create_model(cfg.model, dev, cfg.seed)
    st32 = loop.init_train_state(m32, loop.build_optimizer(
        cfg, m32.parameters(), 1))
    micro32 = loop.make_steps(cfg)[0]
    return data, (lambda: micro32(st32, b)), layouts["cartnet"]


def jarvis_cli(card: str, data: str) -> dict:
    """8e (after the time phase, so that the in-process --profile run
    stays clear of its captures). The Jarvis path through the CLI on the
    staged sample (``jarvis_layouts``) at full width (CartNet, dim 256,
    64 RBF, 4 layers, scalar head, f32, batch 64, batch_accumulation 1,
    two epochs) with --profile and --heartbeat: K1, K2, K4, K5 4 launches
    a micro-step and K1, K2 4 an eval forward, finite stats lines, both
    checkpoints, a trace file and a "stopped" heartbeat; the same with
    --buckets 2; one epoch of the eComformer and the iComformer with
    --max_neighbours 25 (their launches a micro-step and a forward). ->
    the first run's launches."""
    import glob
    import torch
    from cartnet_tpu_torch import cli, runner
    from cartnet_tpu_torch.train.guard import read_heartbeat
    argv = jarvis_argv(data)
    bad = []

    def run_cli(extra, micro_k, fwd_k):
        """One CLI run -> (state, test, launches, expected, run dir)."""
        args = cli.build_parser().parse_args(argv + extra)
        cfg = cli.args_to_config(args)
        pipes = runner.pipelines(cfg, cli.load_datasets(cfg.data))
        micro = args.epochs * len(pipes[0])
        evals = args.epochs * len(pipes[1]) + len(pipes[2])
        want = dict.fromkeys(KERNELS, 0)
        for k, n in micro_k.items():
            want[k] += n * micro
        for k, n in fwd_k.items():
            want[k] += n * evals
        launch_counts(reset=True)
        state, test = cli.main(argv + extra)
        torch.cuda.synchronize()
        got = launch_counts()
        if got != want:
            bad.append(f"{extra}: launches {got}, expected {want}")
        if int(state.bad_steps) or not all(
                math.isfinite(v) for v in test.values()):
            bad.append(f"{extra}: bad steps {int(state.bad_steps)}, "
                       f"test {test}")
        return state, test, got, want, cfg.run_dir

    cartnet_micro = dict.fromkeys(CARTNET_KERNELS, 4)
    cartnet_fwd = dict(edge_phase_fwd=4, sigma_segsum_fwd=4)
    t_phase = t0 = time.perf_counter()
    state, test, launches, expect, run_dir = run_cli(
        ["--epochs", "2", "--name", "jarvis_smoke", "--profile",
         "--heartbeat", "heartbeat.json"], cartnet_micro, cartnet_fwd)
    cli_s = time.perf_counter() - t0
    lines = {}
    for split, n in (("train", 2), ("val", 2), ("test", 1)):
        with open(os.path.join(run_dir, split, "stats.json")) as f:
            lines[split] = [json.loads(x) for x in f if x.strip()]
        if len(lines[split]) != n or not all(
                math.isfinite(r["MAE"]) for r in lines[split]):
            bad.append(f"{split} stats.json: {lines[split]}")
    if not all(os.path.isfile(p) for p in runner.checkpoint_paths(run_dir)):
        bad.append("best.ckpt or last.ckpt missing")
    traces = glob.glob(os.path.join(run_dir, "profile", "*.json"))
    trace_mb = sum(os.path.getsize(t) for t in traces) / 2 ** 20
    heartbeat = read_heartbeat("heartbeat.json") or {}
    if not traces or heartbeat.get("status") != "stopped":
        bad.append(f"trace files {traces}, heartbeat {heartbeat}")
    bstate, btest, blaunches, bexpect, _ = run_cli(
        ["--epochs", "2", "--name", "jarvis_buckets", "--buckets", "2"],
        cartnet_micro, cartnet_fwd)
    comformer_runs = {}
    for net, micro_k, fwd_k in (("eComformer", ECO_MICRO, ECO_FWD),
                                ("iComformer", ICO_MICRO, ICO_FWD)):
        _, ctest, clo, _, _ = run_cli(
            ["--epochs", "1", "--name", f"jarvis_{net}", "--model", net,
             "--max_neighbours", "25"], micro_k, fwd_k)
        comformer_runs[net] = dict(launches=clo, test_MAE=ctest["MAE"])
    emit(phase="jarvis", card=card, launches=launches,
         expected_launches=expect, launches_buckets=blaunches,
         expected_launches_buckets=bexpect, comformers=comformer_runs,
         optimizer_steps=state.step, optimizer_steps_buckets=bstate.step,
         stats_lines={k: len(v) for k, v in lines.items()},
         val_MAE=[r["MAE"] for r in lines["val"]], test=test,
         test_buckets=btest, trace_files=len(traces),
         trace_mb=round(trace_mb, 3), heartbeat=heartbeat.get("status"),
         cli_seconds=round(cli_s, 3),
         seconds=round(time.perf_counter() - t_phase, 3), failed=bad)
    if bad:
        fail(f"jarvis phase: {bad}")
    return launches


ADP_SPLITS = {"train": 24, "val": 4, "test": 4}


def write_adp_dataset(root: str, seed: int = 0) -> dict:
    """The CSD source's layout under ``root`` from the main path's
    ADP-scale synthetic crystals (``ADP_SPLITS``): ``data/<refcode>.pt``
    (the reference's attribute layout, in a SimpleNamespace) and
    ``csv/<split>_files.csv``; about a third of each crystal's atoms are
    hydrogen (z = 1), as in organic CSD crystals. -> the H share."""
    from types import SimpleNamespace
    import numpy as np
    import torch
    from cartnet_tpu_torch.data.synthetic import synthetic_dataset
    recs = synthetic_dataset(sum(ADP_SPLITS.values()), mean_atoms=194,
                             radius=5.0, adp=True, seed=seed)
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    os.makedirs(os.path.join(root, "csv"), exist_ok=True)
    names, n_h, n_all = [], 0, 0
    for i, r in enumerate(recs):
        z = np.where(rng.uniform(size=len(r["z"])) < 1 / 3, 1, r["z"])
        n_h, n_all = n_h + int((z == 1).sum()), n_all + len(z)
        names.append(f"SMOKE{i:03d}")
        torch.save(SimpleNamespace(
            x=torch.tensor(z, dtype=torch.long), pos=torch.tensor(r["pos"]),
            cell=torch.tensor(r["cell"]).reshape(1, 3, 3),
            edge_index=torch.tensor(np.stack([r["edge_src"],
                                              r["edge_dst"]])),
            cart_dist=torch.tensor(r["cart_dist"]).unsqueeze(-1),
            cart_dir=torch.tensor(r["cart_dir"]), y=torch.tensor(r["y"]),
            temperature=torch.tensor([r["temperature"]])),
            os.path.join(root, "data", names[-1] + ".pt"))
    i = 0
    for split, n in ADP_SPLITS.items():
        with open(os.path.join(root, "csv", f"{split}_files.csv"), "w") as f:
            f.write("\n".join(names[i:i + n]) + "\n")
        i += n
    return {"h_share": n_h / n_all, "atoms": n_all}


def adp_phase(card: str, dev) -> dict:
    """8f. The CSD ADP source (``--dataset ADP``, the CLI's default) on
    reference-layout ``.pt`` files written here (``write_adp_dataset``:
    24 / 4 / 4 ADP-scale crystals, a third of the atoms H), through the
    CLI: the JAX README's ADP command at full width (dim 256, 64 RBF, 4
    layers, Cholesky head, batch 4, batch_accumulation 16, --augment), f32,
    two epochs (K1, K2, K4, K5 4 launches a micro-step and K1, K2 4 an
    eval forward; finite stats lines with the JAX keys; both
    checkpoints), then one bf16 epoch; an --inference sweep on best.ckpt;
    one epoch with --disable_H (the node counts drop by the H share; the
    first train batch's forward and micro-step through the kernels against
    the plain versions at that layout, f32 and bf16); one epoch each of
    the eComformer (re-edged to 25 neighbours) and the iComformer (its
    cells canonicalized). Also: LazyRecords' sizing seconds (a scan of the
    train split, then from the sidecar) and one train pass of the
    pipeline with the fetch pool off and with 4 workers (the same batches).
    -> the first run's launches."""
    import numpy as np
    import torch
    from cartnet_tpu_torch import cli, runner
    from cartnet_tpu_torch.models.factory import create_model
    t_phase = time.perf_counter()
    data = os.path.abspath("adp_smoke_data")
    written = write_adp_dataset(data)
    write_s = time.perf_counter() - t_phase
    argv = ["--dataset", "ADP", "--dataset_path", data, "--batch", "4",
            "--batch_accumulation", "16", "--augment"]
    keys = {"epoch", "time_epoch", "time_iter", "lr", "params", "loss",
            "MAE", "MSE", "volume_percentage_error", "similarity_index",
            "edges_per_sec", "gpu_memory"}
    split_keys = {"train": keys, "val": keys | {"r2", "spearmanr"},
                  "test": keys | {"r2", "spearmanr", "iou"}}
    micro = ADP_SPLITS["train"] // 4
    evals = ADP_SPLITS["val"] // 4
    bad = []

    def expect(micro_k, fwd_k, micro_steps, forwards) -> dict:
        want = dict.fromkeys(KERNELS, 0)
        for k, n in micro_k.items():
            want[k] += n * micro_steps
        for k, n in fwd_k.items():
            want[k] += n * forwards
        return want

    def run(extra, epochs, micro_k, fwd_k, name):
        launch_counts(reset=True)
        t0 = time.perf_counter()
        state, test = cli.main(argv + extra + ["--epochs", str(epochs),
                                               "--name", name])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launch_counts()
        want = expect(micro_k, fwd_k, epochs * micro, epochs * evals + 1)
        if got != want:
            bad.append(f"{name}: launches {got}, expected {want}")
        if int(state.bad_steps) or not all(math.isfinite(v)
                                           for v in test.values()):
            bad.append(f"{name}: bad steps {int(state.bad_steps)}, test "
                       f"{test}")
        run_dir = os.path.join("results", name, "0")
        lines = {}
        for split, n in (("train", epochs), ("val", epochs), ("test", 1)):
            with open(os.path.join(run_dir, split, "stats.json")) as f:
                lines[split] = [json.loads(x) for x in f if x.strip()]
            if len(lines[split]) != n or any(
                    set(r) != split_keys[split] or not all(
                        math.isfinite(v) for v in r.values()
                        if isinstance(v, float)) for r in lines[split]):
                bad.append(f"{name} {split} stats.json: {lines[split]}")
        return dict(state=state, test=test, launches=got, seconds=seconds,
                    lines=lines, run_dir=run_dir,
                    epoch_s=[r["time_epoch"] for r in lines["train"]])

    cartnet_micro = dict.fromkeys(CARTNET_KERNELS, 4)
    cartnet_fwd = dict(edge_phase_fwd=4, sigma_segsum_fwd=4)
    f32 = run([], 2, cartnet_micro, cartnet_fwd, "adp_smoke")
    best, last = runner.checkpoint_paths(f32["run_dir"])
    if not (os.path.isfile(best) and os.path.isfile(last)):
        bad.append("best.ckpt or last.ckpt missing")
    bf16 = run(["--bf16"], 1, cartnet_micro, cartnet_fwd, "adp_smoke_bf16")
    # the inference sweep on best.ckpt
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = cli.main(argv + ["--inference", "--checkpoint_path", best,
                           "--inference_output", "adp_inference.pkl"])
    torch.cuda.synchronize()
    inf_s = time.perf_counter() - t0
    inf_launches = launch_counts()
    if (inf_launches != expect({}, cartnet_fwd, 0, 1)
            or len(out["pred"]) != ADP_SPLITS["test"]
            or not all(np.isfinite(p).all() for p in out["pred"])):
        bad.append(f"inference: launches {inf_launches}, "
                   f"{len(out['pred'])} structures")
    # --disable_H: fewer nodes, the kernels against plain at that layout
    noh = run(["--disable_H"], 1, cartnet_micro, cartnet_fwd, "adp_smoke_noh")
    cfg_h = cli.args_to_config(cli.build_parser().parse_args(argv))
    cfg_noh = cli.args_to_config(cli.build_parser().parse_args(
        argv + ["--disable_H"]))
    nodes_h, edges_h = (int(np.sum(x)) for x in
                        cli.load_datasets(cfg_h.data)[0].counts())
    noh_pipe = runner.pipelines(cfg_noh, cli.load_datasets(cfg_noh.data))[0]
    nodes_noh, edges_noh = (int(np.sum(x)) for x in
                            noh_pipe.records.counts())
    drop = 1 - nodes_noh / nodes_h
    if abs(drop - written["h_share"]) > 0.05:
        bad.append(f"--disable_H removed {drop:.3f} of the nodes, the H "
                   f"share is {written['h_share']:.3f}")
    nbatch = next(iter(noh_pipe)).to(dev)
    nlayout = dict(nodes=int(nbatch.z.shape[0]),
                   edges=int(nbatch.edge_src.shape[0]),
                   real_nodes=int(nbatch.node_mask.sum()),
                   real_edges=int(nbatch.edge_mask.sum()))
    want_f = dict.fromkeys(KERNELS, 0)
    want_f.update(edge_phase_fwd=4, sigma_segsum_fwd=4)
    for dt, tol in ((torch.float32, F32_STEP_TOL),
                    (torch.bfloat16, PRED_TOL)):
        c = with_dtype(cfg_noh, dt)
        m = create_model(c.model, dev, c.seed)
        forward_vs_plain(card, m, nbatch, plain_cartnet_forward, want_f,
                         tol, phase="adp_noh_forward", **nlayout,
                         compute_dtype=str(dt))
        train_vs_plain(card, c, m, nbatch, tol)
    # the Comformers: re-edged to 25 neighbours; the iComformer's cells
    # canonicalized
    eco = run(["--model", "eComformer"], 1, ECO_MICRO, ECO_FWD,
              "adp_smoke_ecomformer")
    ico = run(["--model", "iComformer"], 1, ICO_MICRO, ICO_FWD,
              "adp_smoke_icomformer")
    if not os.listdir(os.path.join(data, "data_25_5.0")):
        bad.append("no re-edge cache for the Comformers")
    # LazyRecords sizing: a scan (the sidecar removed), then the sidecar
    train_recs = cli.load_datasets(cfg_h.data)[0]
    os.remove(train_recs.sidecar_path())
    t0 = time.perf_counter()
    scanned = train_recs.counts()
    scan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cached = train_recs.counts()
    sidecar_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(scanned, cached)):
        bad.append("the sidecar's counts differ from the scan's")
    # one train pass with the fetch pool off and with 4 workers
    pass_s, firsts = {}, {}
    for workers in (0, 4):
        pipe = runner.pipelines(cfg_h, cli.load_datasets(cfg_h.data))[0]
        pipe.workers = workers
        t0 = time.perf_counter()
        got = list(pipe)
        pass_s[workers] = time.perf_counter() - t0
        firsts[workers] = got
    if any(not np.array_equal(getattr(a, f), getattr(b, f))
           for a, b in zip(firsts[0], firsts[4])
           for f in ("z", "pos", "cart_dir", "edge_src", "y")):
        bad.append("workers 4 gave other batches than workers 0")
    emit(phase="adp", card=card, crystals=ADP_SPLITS, atoms=written["atoms"],
         h_share=round(written["h_share"], 4), write_seconds=round(write_s, 3),
         launches=f32["launches"],
         expected_launches=expect(cartnet_micro, cartnet_fwd, 2 * micro,
                                  2 * evals + 1),
         epoch_seconds_f32=f32["epoch_s"], epoch_seconds_bf16=bf16["epoch_s"],
         cli_seconds_f32=round(f32["seconds"], 3),
         cli_seconds_bf16=round(bf16["seconds"], 3),
         val_MAE=[r["MAE"] for r in f32["lines"]["val"]], test=f32["test"],
         test_bf16=bf16["test"], inference_launches=inf_launches,
         inference_seconds=round(inf_s, 3),
         inference_mean_mae=float(np.mean(out["mae"])),
         disable_h=dict(nodes=nodes_noh, nodes_with_h=nodes_h,
                        dropped=round(drop, 4), edges=edges_noh,
                        edges_with_h=edges_h, launches=noh["launches"],
                        layout=nlayout, test=noh["test"]),
         ecomformer=dict(launches=eco["launches"], test_MAE=eco["test"]["MAE"],
                         epoch_seconds=eco["epoch_s"]),
         icomformer=dict(launches=ico["launches"], test_MAE=ico["test"]["MAE"],
                         epoch_seconds=ico["epoch_s"]),
         sizing_seconds=dict(scan=round(scan_s, 4),
                             sidecar=round(sidecar_s, 5)),
         train_pass_seconds={f"workers_{k}": round(v, 3)
                             for k, v in pass_s.items()},
         seconds=round(time.perf_counter() - t_phase, 3), failed=bad)
    if bad:
        fail(f"adp phase: {bad}")
    return f32["launches"]


DP_CASES = (("cartnet", "f32"), ("cartnet", "bf16"), ("ecomformer", "f32"))
DP_TIMED = 5


def dp_config(net: str, dt: str):
    """The dp phase's configs: flagship widths, Cholesky head."""
    import torch
    from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
    return Config(model=ModelConfig(
        name=net, dim_in=256, dim_rbf=64, num_layers=4, cholesky=True,
        compute_dtype=torch.bfloat16 if dt == "bf16" else torch.float32),
        optim=OptimConfig(max_epoch=1, batch_accumulation=TRAIN_ACCUM))


def dp_rank(rank: int, coordinator: str, batches, out_dir: str,
            device: str) -> None:
    """One of the dp phase's two ranks (a process of its own on the one
    card, in an explicit gloo group): for each case, one micro-step on
    batch ``rank`` from seed 0 and the update, its launches, then the wall
    time of ``DP_TIMED`` more micro-steps; saved to ``out_dir``."""
    import torch
    from cartnet_tpu_torch.models.factory import create_model
    from cartnet_tpu_torch.parallel import dist as pdist
    from cartnet_tpu_torch.parallel.step import make_parallel_steps
    from cartnet_tpu_torch.train import loop
    from cartnet_tpu_torch.config import resolve_device
    dev = resolve_device(pdist.rank_device(device, 0))  # both on card 0
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = pdist.initialize_distributed(coordinator, 2, rank, dev,
                                         backend="gloo")
    batch = batches[rank].to(dev)
    res = {}
    for net, dt in DP_CASES:
        cfg = dp_config(net, dt)
        model = create_model(cfg.model, dev, 0)
        opt = loop.build_optimizer(cfg, model.parameters(), 1)
        state = loop.init_train_state(model, opt)
        micro, update, _ = make_parallel_steps(cfg, group)
        launch_counts(reset=True)
        state, stats = micro(state, batch)
        torch.cuda.synchronize()
        host = lambda ts: [t.detach().to("cpu", copy=True) for t in ts]
        r = {"launches": launch_counts(), "loss": float(stats["loss"]),
             "grads": host(state.grad_accum),
             "bn": host(loop.bn_buffers(model))}
        state = update(state)
        r["params"] = host(state.optimizer.params)
        times = []
        for _ in range(DP_TIMED + 1):
            torch.distributed.barrier(group)
            t0 = time.perf_counter()
            state, _ = micro(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        r["step_ms"] = statistics.median(times[1:])
        # the collectives of one micro-step: their number and elements
        sizes, real = [], torch.distributed.all_reduce

        def counted(t, *a, **k):
            sizes.append(t.numel())
            return real(t, *a, **k)
        torch.distributed.all_reduce = counted
        try:
            micro(state, batch)
        finally:
            torch.distributed.all_reduce = real
        r["collectives"], r["collective_elems"] = len(sizes), sum(sizes)
        res[f"{net}_{dt}"] = r
    # one small gloo all-reduce of a CUDA tensor, synchronized
    t, times = torch.ones(513, device=dev), []
    for _ in range(30):
        t0 = time.perf_counter()
        torch.distributed.all_reduce(t, group=group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["all_reduce_ms"] = statistics.median(times[5:])
    torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"dp_rank{rank}.pt"))


def nccl_fused(cfg, dev, group, union) -> dict:
    """A fused chunk (``make_parallel_fused_chunk``, K = 4 over the union
    batch, one update) in the world = 1 NCCL ``group``, its all-reduces
    captured in the CUDA graph, against the single-process fused chunk
    from the same state: each layer's weights and the BN buffers within
    F32_STEP_TOL (grad_errors), the per-step stats, the counters."""
    import torch
    from cartnet_tpu_torch.parallel.step import make_parallel_fused_chunk
    from cartnet_tpu_torch.train import loop
    from cartnet_tpu_torch.train.graphs import ChunkRunner
    k = FUSED_SMALL_K
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, batch_accumulation=k))
    out = {}
    for name, chunk, grp in (
            ("single", loop.make_fused_chunk(cfg, k), None),
            ("nccl", make_parallel_fused_chunk(cfg, group, k), group)):
        st = fused_state(cfg, dev, k)
        stats = ChunkRunner(chunk, k, dev, grp)(st, [union] * k)
        torch.cuda.synchronize()
        out[name] = (st, stats)
    (a, sa), (b, sb) = out["single"], out["nccl"]
    names = [n for n, _ in a.model.named_parameters()]
    p_err = grad_errors(names, [p.detach() for p in b.optimizer.params],
                        [p.detach() for p in a.optimizer.params])
    bufs = zip(loop.bn_buffers(b.model), loop.bn_buffers(a.model))
    b_err = max(normalized_err(x, y)[1] for x, y in bufs
                if x.is_floating_point())
    s_err = max(normalized_err(sb[key], sa[key])[1] for key in sa)
    bitwise = all(torch.equal(x, y) for x, y in
                  zip(b.model.state_dict().values(),
                      a.model.state_dict().values()))
    counts = [int(s.optimizer.count_t) for s in (a, b)]
    failed = []
    if not (max(p_err.values()) <= F32_STEP_TOL and b_err <= F32_STEP_TOL
            and s_err <= F32_STEP_TOL):
        failed.append("nccl vs single")
    if counts != [1, 1]:
        failed.append(f"updates {counts}")
    return dict(world=1, k=k, params_max_rel_err_per_layer=max(
        p_err.values()), bn_stats_max_rel_err=b_err,
        stats_max_rel_err=s_err, bitwise=bitwise, updates=counts,
        tol=F32_STEP_TOL, failed=failed)


def dp_phase(card: str, dev, recs) -> dict:
    """8g. Data parallelism (parallel/step.py) with two ranks on the one
    card: NCCL takes one rank a device, so the ranks join an explicit gloo
    group (which all-reduces CUDA tensors). Each rank takes one micro-step
    on one of the main path's two batches (4 crystals each) through the
    kernels, and the update: CartNet (flagship widths) in f32 and bf16 and
    the eComformer in f32. Held against a single-process step on the union
    batch (the 8 crystals in one batch): the loss, the BN running stats
    and the summed gradients (each over its layer's largest) within 1e-4
    (f32), or through bf16_grad_gate (bf16: the plain versions' union step
    as the second implementation, the f32 union step as the scale); the
    two ranks' updated weights equal to the bit and equal to the update of
    the summed gradients. Launches per rank: one micro-step's. Then one
    step of a world = 1 NCCL group, which must equal the single-process
    step. The dp step's wall time (median of 5, rank 0) beside the
    single-process union step's. -> rank 0's launches per case."""
    import torch
    from cartnet_tpu_torch.data.batching import make_batches
    from cartnet_tpu_torch.models.factory import create_model
    from cartnet_tpu_torch.parallel import dist as pdist
    from cartnet_tpu_torch.parallel.step import make_parallel_steps
    from cartnet_tpu_torch.train import loop
    t_phase = time.perf_counter()
    halves = make_batches(recs, 4)
    union = make_batches(recs, 8)[0].to(dev)
    out_dir = os.path.abspath("dp_smoke")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    pdist.spawn(dp_rank, 2, (halves, out_dir, str(dev)))
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"dp_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    bad, lines = [], {}

    def fresh(cfg):
        model = create_model(cfg.model, dev, 0)
        return loop.init_train_state(model, loop.build_optimizer(
            cfg, model.parameters(), 1))

    def single(cfg, plain=None) -> dict:
        """The single-process micro-step on the union batch from seed 0
        (``plain``: through the plain versions), then the update."""
        state = fresh(cfg)
        micro, update, _ = loop.make_steps(cfg)
        with (plain() if plain else contextlib.nullcontext()):
            state, stats = micro(state, union)
        torch.cuda.synchronize()
        out = dict(loss=stats["loss"].reshape(1).float(),
                   grads=[g.clone() for g in state.grad_accum],
                   bn=[b.clone() for b in loop.bn_buffers(state.model)],
                   names=[n for n, _ in state.model.named_parameters()],
                   state=state, micro=micro)
        update(state)
        return out

    for net, dt in DP_CASES:
        case = f"{net}_{dt}"
        cfg = dp_config(net, dt)
        a, b = ranks[0][case], ranks[1][case]
        ref = single(cfg)
        loss, grads, bn, names = (ref[k] for k in ("loss", "grads", "bn",
                                                     "names"))
        same = all(torch.equal(x, y) for k in ("grads", "bn", "params")
                   for x, y in zip(a[k], b[k]))
        # the update of the summed gradients, here
        upd = fresh(cfg)
        for acc, g in zip(upd.grad_accum, a["grads"]):
            acc.copy_(g)
        loop.make_steps(cfg)[1](upd)
        update_same = all(torch.equal(p.detach().cpu(), q) for p, q in
                          zip(upd.optimizer.params, a["params"]))
        dev_grads = [g.to(dev) for g in a["grads"]]
        loss_err = normalized_err(torch.tensor([a["loss"]]), loss.cpu())[1]
        bn_err = max(normalized_err(x.to(dev), y)[1]
                     for x, y in zip(a["bn"], bn))
        g_err = grad_errors(names, dev_grads, grads)
        line = dict(model=net, compute_dtype=dt, loss=a["loss"],
                    loss_single=float(loss), loss_rel_err=loss_err,
                    bn_stats_max_rel_err=bn_err,
                    grads_max_rel_err_per_layer=max(g_err.values()),
                    grads_worst=max(g_err, key=g_err.get),
                    ranks_bitwise_equal=same,
                    update_equals_single_process_update=update_same,
                    launches_per_rank=a["launches"],
                    dp_step_ms=a["step_ms"], rank1_step_ms=b["step_ms"],
                    collectives_per_step=a["collectives"],
                    collective_elems=a["collective_elems"],
                    small_all_reduce_ms=ranks[0]["all_reduce_ms"])
        tol = 1e-4 if dt == "f32" else PRED_TOL
        want = dict.fromkeys(KERNELS, 0)
        want.update(dict.fromkeys(CARTNET_KERNELS, 4) if net == "cartnet"
                    else ECO_MICRO)
        fails = []
        if a["launches"] != want or b["launches"] != want:
            fails.append(f"launches {a['launches']}, {b['launches']}")
        if not (same and update_same):
            fails.append("ranks or update differ")
        if loss_err > tol or bn_err > tol:
            fails.append(f"loss {loss_err}, bn {bn_err}")
        if dt == "f32":
            fails += [n for n, e in g_err.items() if e > tol]
        else:
            r_grads = single(with_dtype(cfg, torch.float32))["grads"]
            p_grads = single(cfg, plain_kernels)["grads"]
            gate = bf16_grad_gate(names, dev_grads, grads, p_grads, r_grads,
                                  tol)
            worst = gate["groups"][gate["worst"]]
            line.update(grads_gate_worst_group=gate["worst"],
                        grads_gate_share_of_limit=worst["share"],
                        grads_vs_single=worst["kernels_vs_plain"],
                        grads_single_vs_plain=worst["plain_vs_alt"])
            fails += gate["failed"]
        # the single-process union step's wall time
        times, state = [], ref["state"]
        for _ in range(DP_TIMED + 1):
            t0 = time.perf_counter()
            state, _ = ref["micro"](state, union)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        line["single_union_step_ms"] = statistics.median(times[1:])
        lines[case] = line
        emit(phase="dp", card=card, **line, tol=tol, failed=fails)
        bad += [f"{case}: {f}" for f in fails]
    # a world = 1 NCCL group: initializes, and equals the single process;
    # beside it, the single-process step's own repeat from the same state
    # (the gradients that differ between two runs of one step: atomics)
    cfg = dp_config("cartnet", "f32")
    ref = single(cfg)
    loss, grads, names = ref["loss"], ref["grads"], ref["names"]
    again = single(cfg)
    differs = lambda gs: [n for n, x, y in zip(names, gs, grads)
                          if not torch.equal(x, y)]
    repeat_differs = differs(again["grads"])
    repeat_err = max(grad_errors(names, again["grads"], grads).values())
    group = pdist.initialize_distributed(f"localhost:{pdist.free_port()}", 1,
                                         0, dev)
    try:
        backend = torch.distributed.get_backend(group)
        state = fresh(cfg)
        micro, _, _ = make_parallel_steps(cfg, group)
        launch_counts(reset=True)
        state, stats = micro(state, union)
        torch.cuda.synchronize()
        nccl_launches = launch_counts()
        fused_line = nccl_fused(cfg, dev, group, make_batches(recs, 8)[0])
    finally:
        torch.distributed.destroy_process_group()
    nccl_err = max([normalized_err(stats["loss"].reshape(1), loss)[1]]
                   + list(grad_errors(names, state.grad_accum,
                                      grads).values()))
    nccl_differs = differs(state.grad_accum)
    nccl_bitwise = bool(torch.equal(stats["loss"].reshape(1), loss)
                        and not nccl_differs)
    nccl_fail = backend != "nccl" or nccl_err > 1e-4
    emit(phase="dp_nccl", card=card, backend=backend, world=1,
         launches=nccl_launches, max_rel_err=nccl_err, bitwise=nccl_bitwise,
         differs=nccl_differs, single_repeat_bitwise=bool(
             torch.equal(again["loss"], loss) and not repeat_differs),
         single_repeat_differs=repeat_differs,
         single_repeat_max_rel_err=repeat_err,
         differs_within_repeat=set(nccl_differs) <= set(repeat_differs),
         failed=nccl_fail)
    if nccl_fail:
        bad.append(f"nccl world 1: backend {backend}, err {nccl_err}")
    emit(phase="dp_nccl_fused", card=card, **fused_line)
    if fused_line["failed"]:
        bad.append(f"nccl world 1 fused chunk: {fused_line['failed']}")
    emit(phase="dp_summary", card=card, spawn_seconds=round(spawn_s, 3),
         seconds=round(time.perf_counter() - t_phase, 3), failed=bad)
    if bad:
        fail(f"dp phase: {bad}")
    return {f"{n}_{d}": ranks[0][f"{n}_{d}"]["launches"]
            for n, d in DP_CASES}


# 8g2. edge parallelism and halo partitioning: gloo ranks on the one card
EP_JOBS = (("cartnet", "bf16", "ep"), ("cartnet", "f32", "ep"),
           ("merged", "bf16", "ep"), ("ecomformer", "bf16", "ep"),
           ("icomformer", "bf16", "ep"),
           ("cartnet", "bf16", "halo_snapped"),
           ("cartnet", "bf16", "halo_split"),
           ("ecomformer", "bf16", "halo_snapped"),
           ("ecomformer", "bf16", "halo_split"))
EP_TIMED = 3
# a member's launches per train micro-step: the single step's
EP_MICRO = {"cartnet": dict.fromkeys(CARTNET_KERNELS, 4),
            "merged": MERGED_MICRO, "ecomformer": ECO_MICRO,
            "icomformer": ICO_MICRO}


def ep_config(net: str, dt: str):
    """The ep phase's configs: dp_config's (flagship widths, Cholesky
    head); "merged" is CartNet under CARTNET_MERGED=1."""
    return dp_config("cartnet" if net == "merged" else net, dt)


def split_batch(recs):
    """Three of the main path's crystals in a batch of 640 nodes and
    16384 edges: no member of an ep = 2 halo layout (320 rows each) holds
    two of them, so one is cut across the members."""
    from cartnet_tpu_torch.data.batching import (EDGE_ALIGN,
                                                 bandwidth_reorder, collate)
    three = [bandwidth_reorder(r) for r in recs[:3]]
    return collate(three, 640, 16384, 3, edge_align=EDGE_ALIGN)


def ep_rank(rank: int, coordinator: str, world: int, dp: int, jobs,
            out_dir: str, device: str) -> None:
    """One rank of the ep phase (a process of its own on the one card, in
    an explicit gloo group of ``world`` = dp x ep ranks): for each job,
    its share of its dp slice (``runner.ShardedPipeline``'s cut), the eval
    forward's predictions of its own rows, one micro-step from seed 0
    (its launches, loss, gradients, BN buffers), the wall time of
    ``EP_TIMED`` more and the collectives of one; saved to ``out_dir``."""
    import torch
    from cartnet_tpu_torch.config import resolve_device
    from cartnet_tpu_torch.models.factory import create_model
    from cartnet_tpu_torch.parallel import dist as pdist
    from cartnet_tpu_torch.parallel.step import make_parallel_steps
    from cartnet_tpu_torch.runner import ShardedPipeline
    from cartnet_tpu_torch.train import loop
    dev = resolve_device(pdist.rank_device(device, 0))  # all on card 0
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world_group = pdist.initialize_distributed(coordinator, world, rank,
                                               dev, backend="gloo")
    ep = world // dp
    groups = {halo: pdist.make_groups(dp, ep, halo)
              for halo in (False, True)}
    host = lambda ts: [t.detach().to("cpu", copy=True) for t in ts]
    res = {}
    for case, (net, dt, layout), slices, union in jobs:
        halo = layout.startswith("halo")
        cfg = ep_config(net, dt)
        mine = next(iter(ShardedPipeline(slices, dp, rank, ep, halo)))
        n_own = int(mine.node_mask.sum())
        batch = mine.to(dev)
        with merged_path(net == "merged"):
            model = create_model(cfg.model, dev, 0)
            if net == "icomformer":
                calibrate_bn(model, union.to(dev))
            opt = loop.build_optimizer(cfg, model.parameters(), 1)
            state = loop.init_train_state(model, opt)
            micro, _, evals = make_parallel_steps(cfg, groups[halo])
            with torch.no_grad():
                pred = evals(state, batch)[0]
            launch_counts(reset=True)
            state, stats = micro(state, batch)
            torch.cuda.synchronize()
            r = {"launches": launch_counts(), "loss": float(stats["loss"]),
                 "grads": host(state.grad_accum),
                 "bn": host(loop.bn_buffers(model)),
                 "pred": pred[:n_own if halo else None].float().cpu(),
                 "halo_empty": mine.halo_empty,
                 "edges": int(mine.num_edges), "nodes": int(mine.num_nodes)}
            times = []
            for _ in range(EP_TIMED + 1):
                torch.distributed.barrier(world_group)
                t0 = time.perf_counter()
                state, _ = micro(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            r["step_ms"] = statistics.median(times[1:])
            counted = {"all_reduce": [], "all_to_all_single": []}
            real = {k: getattr(torch.distributed, k) for k in counted}

            def counter(k):
                def call(t, *a, **kw):
                    counted[k].append(t.numel())
                    return real[k](t, *a, **kw)
                return call
            for k in counted:
                setattr(torch.distributed, k, counter(k))
            try:
                micro(state, batch)
            finally:
                for k in counted:
                    setattr(torch.distributed, k, real[k])
            r["collectives"] = {k: len(v) for k, v in counted.items()}
            r["collective_elems"] = {k: sum(v) for k, v in counted.items()}
        res[case] = r
    # one all-reduce of an [N, d] f32 aggregate over the ep group
    t, times = torch.ones(896, 256, device=dev), []
    for _ in range(20):
        t0 = time.perf_counter()
        torch.distributed.all_reduce(t, group=groups[False].ep)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["aggregate_all_reduce_ms"] = statistics.median(times[5:])
    torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"ep_rank{rank}.pt"))


def two_count_checks(card, member, gen, dev) -> dict:
    """K5 and K6 on a halo member's shapes (dst rows n_per, src rows
    n_per + ep H: xj over the member's table) against their plain
    versions, bf16 and f32, with bitwise repeats."""
    import torch
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    d, out = 256, {}
    sums = ("dxi", "dxj", "dwe", "db", "dw1g", "db1g", "dw1a", "db1a")
    for dt in (torch.bfloat16, torch.float32):
        tol_of = (lambda o: CHECK_TOL["bf16"]) if dt == torch.bfloat16 else (
            lambda o: CHECK_TOL["sum" if o in sums else "f32"])
        eargs, _ = backward_inputs(member, dt, d, gen, dev)
        margs, _ = merged_inputs(member, dt, d, gen, dev)
        for kname, fn, plain, a in (
                ("edge_phase_bwd", ek.edge_phase_bwd, edge_bwd_plain, eargs),
                ("edge_phase_merged_bwd", ek.merged_bwd, merged_bwd_plain,
                 margs)):
            got, again, want = fn(*a), fn(*a), plain(*a)
            torch.cuda.synchronize()
            case = f"halo_two_counts_{str(dt)[6:]}"
            out[f"{kname} {case}"] = check_outputs(
                card, kname, case, EDGE_BWD_OUT, got, again, want, tol_of,
                dst_rows=int(member.num_nodes),
                src_rows=int(member.src_rowptr.shape[0] - 1))
    return out


def member_kernel_ms(full, member, gen, dev) -> dict:
    """K1 (training layout: saved residual and moments) and K5's device
    ms a call at a full batch's shapes and at an ep member's (its half of
    the edges), bf16 and f32."""
    import torch
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for name, b in (("full", full), ("member", member)):
            args = edge_inputs(b, dt, dt, 256, gen, dev)
            idx = (b.edge_dst, b.edge_src, b.edge_mask)
            eargs, _ = backward_inputs(b, dt, 256, gen, dev)
            key = f"{name}_{str(dt)[6:]}"
            out[f"K1 {key}"] = device_ms(
                lambda a=args, i=idx: ek.edge_phase_fwd(
                    *a, *i, saved=True, moments=True),
                kernels=launches_of("edge_phase_fwd", dt))
            out[f"K5 {key}"] = device_ms(
                lambda a=eargs: ek.edge_phase_bwd(*a),
                kernels=launches_of("edge_phase_bwd", dt))
    return out


def ep_phase(card: str, dev, recs, batches) -> dict:
    """8g2. Edge parallelism and halo partitioning (parallel/), gloo
    ranks on the one card (NCCL takes one rank a device): ep = 2 on the
    main path's first batch (CartNet bf16 and f32, merged bf16, the
    eComformer and the iComformer bf16), ep = 2 halo on it (its crystals
    fit whole members: an empty halo, no exchange) and on three crystals
    one of which is cut across the members (CartNet and the eComformer
    bf16), and dp 2 x ep 2 on the main path's two batches (CartNet f32).
    Each case against a single-process step on the same data: the loss
    and BN running stats within 1e-5 (f32; bf16 PRED_TOL), each layer's
    f32 gradients within the dp phase's 1e-4, bf16 gradients through
    bf16_grad_gate; the eval forward's predictions (each member's own
    rows, put together) within 1e-4 (f32) or PRED_TOL (bf16); a member's
    launches those of the single step; the micro-step's wall time beside
    the single step's and its collectives. Then K5 and K6 with separate
    dst and src row counts on a halo member's shapes against their plain
    versions, and the halo bytes a layer (comms_bytes_per_layer).
    -> rank 0's launches per case."""
    import torch
    from cartnet_tpu_torch.data.batching import make_batches
    from cartnet_tpu_torch.models.factory import create_model
    from cartnet_tpu_torch.parallel import dist as pdist
    from cartnet_tpu_torch.parallel.halo import comms_bytes_per_layer, to_halo
    from cartnet_tpu_torch.parallel.partition import ep_member, halo_member
    from cartnet_tpu_torch.train import loop
    t_phase = time.perf_counter()
    main_b = batches[0]
    split = split_batch(recs)
    data = {"ep": main_b, "halo_snapped": main_b, "halo_split": split}
    jobs2 = [(f"{net}_{dt}_{layout}", (net, dt, layout), [data[layout]],
              data[layout]) for net, dt, layout in EP_JOBS]
    union = make_batches(recs, 8)[0]
    jobs4 = [("dp2_cartnet_f32_ep", ("cartnet", "f32", "ep"),
              list(batches), union)]
    emit(phase="ep_kernels", card=card, full_edges=int(main_b.num_edges),
         device_ms=member_kernel_ms(
             main_b.to(dev), ep_member(main_b, 2, 0).to(dev),
             torch.Generator().manual_seed(2), dev))
    ranks, spawn_s, agg_ms = {}, {}, {}
    for world, dp, jobs in ((2, 1, jobs2), (4, 2, jobs4)):
        out_dir = os.path.abspath(f"ep_smoke_{world}")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        pdist.spawn(ep_rank, world, (world, dp, jobs, out_dir, str(dev)))
        spawn_s[world] = round(time.perf_counter() - t0, 3)
        got = [torch.load(os.path.join(out_dir, f"ep_rank{r}.pt"),
                          weights_only=False) for r in range(world)]
        for job in jobs:
            ranks[job[0]] = (world, [g[job[0]] for g in got], job)
        agg_ms[world] = got[0]["aggregate_all_reduce_ms"]
    bad, launches = [], {}

    def single(cfg, net, batch, plain=None) -> dict:
        """The single-process eval forward and micro-step on ``batch``
        from seed 0 (``plain``: through the plain versions)."""
        with merged_path(net == "merged"):
            model = create_model(cfg.model, dev, 0)
            if net == "icomformer":
                calibrate_bn(model, batch)
            state = loop.init_train_state(model, loop.build_optimizer(
                cfg, model.parameters(), 1))
            micro, _, evals = loop.make_steps(cfg)
            with (plain() if plain else contextlib.nullcontext()):
                with torch.no_grad():
                    pred, mask, _ = evals(state, batch)
                state, stats = micro(state, batch)
            torch.cuda.synchronize()
            out = dict(loss=stats["loss"].reshape(1).float(),
                       grads=[g.clone() for g in state.grad_accum],
                       bn=[b.clone() for b in loop.bn_buffers(model)],
                       names=[n for n, _ in model.named_parameters()],
                       pred=pred.float(), mask=mask, state=state,
                       micro=micro)
        return out

    for case, (world, rr, job) in ranks.items():
        _, (net, dt, layout), slices, ubatch = job
        halo = layout.startswith("halo")
        cfg = ep_config(net, dt)
        ub = ubatch.to(dev)
        ref = single(cfg, net, ub)
        a = rr[0]
        names = ref["names"]
        dev_grads = [g.to(dev) for g in a["grads"]]
        same = all(torch.equal(x, y) for b in rr[1:]
                   for k in ("grads", "bn") for x, y in zip(a[k], b[k]))
        loss_err = normalized_err(torch.tensor([a["loss"]]),
                                  ref["loss"].cpu())[1]
        bn_err = max(normalized_err(x.to(dev), y)[1]
                     for x, y in zip(a["bn"], ref["bn"])
                     if y.is_floating_point())
        # eval: each member's own rows (ep: copied, all of them), in the
        # slices' order; against the single eval's real rows
        m = ub.node_mask.bool()
        want = ref["pred"][m]
        if halo:
            got = torch.cat([r["pred"] for r in rr]).to(dev)
        else:
            got = torch.cat([rr[i * (world // len(slices))]["pred"][
                torch.as_tensor(s.node_mask)] for i, s in
                enumerate(slices)]).to(dev)
        keep = ref["mask"][m].bool()
        pred_err = normalized_err(got[keep], want[keep])[1]
        line = dict(model=net, compute_dtype=dt, layout=layout,
                    world=world, dp=len(slices), ep=world // len(slices),
                    loss=a["loss"], loss_single=float(ref["loss"]),
                    loss_rel_err=loss_err, bn_stats_max_rel_err=bn_err,
                    pred_rel_err=pred_err, ranks_bitwise_equal=same,
                    launches_per_rank=a["launches"],
                    member_edges=a["edges"], member_nodes=a["nodes"],
                    ep_step_ms=a["step_ms"],
                    rank_step_ms=[r["step_ms"] for r in rr],
                    collectives_per_step=a["collectives"],
                    collective_elems=a["collective_elems"])
        if halo:
            line["halo_empty"] = [r["halo_empty"] for r in rr]
        f32 = dt == "f32"
        tol = 1e-5 if f32 else PRED_TOL
        fails = []
        want_l = dict.fromkeys(KERNELS, 0)
        want_l.update(EP_MICRO[net])
        if any(r["launches"] != want_l for r in rr):
            fails.append(f"launches {[r['launches'] for r in rr]}")
        if not same:
            fails.append("ranks differ")
        if loss_err > tol or bn_err > tol:
            fails.append(f"loss {loss_err}, bn {bn_err}")
        if not pred_err <= (1e-4 if f32 else PRED_TOL):
            fails.append(f"eval predictions {pred_err}")
        if halo and any(r["halo_empty"] != (layout == "halo_snapped")
                        for r in rr):
            fails.append("halo emptiness")
        if f32:
            g_err = grad_errors(names, dev_grads, ref["grads"])
            line.update(grads_max_rel_err_per_layer=max(g_err.values()),
                        grads_worst=max(g_err, key=g_err.get))
            fails += [n for n, e in g_err.items() if e > 1e-4]
        else:
            plain = (plain_kernels if net in ("cartnet", "merged")
                     else plain_ecomformer_kernels)
            r_grads = single(with_dtype(cfg, torch.float32), net,
                             ub)["grads"]
            p_grads = single(cfg, net, ub, plain)["grads"]
            gate = bf16_grad_gate(names, dev_grads, ref["grads"], p_grads,
                                  r_grads, PRED_TOL)
            worst = gate["groups"][gate["worst"]]
            line.update(grads_gate_worst_group=gate["worst"],
                        grads_gate_share_of_limit=worst["share"],
                        grads_vs_single=worst["kernels_vs_plain"],
                        grads_single_vs_plain=worst["plain_vs_alt"])
            fails += gate["failed"]
        times, state = [], ref["state"]
        with merged_path(net == "merged"):
            for _ in range(EP_TIMED + 1):
                t0 = time.perf_counter()
                state, _ = ref["micro"](state, ub)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        line["single_step_ms"] = statistics.median(times[1:])
        emit(phase="ep", card=card, **line, tol=tol, failed=fails)
        bad += [f"{case}: {f}" for f in fails]
        launches[case] = a["launches"]
    # K5/K6 with two row counts, on member 0 of the split batch's layout
    hb = to_halo(split, 2)
    member = halo_member(hb, 2, 0).to(dev)
    two_counts = two_count_checks(card, member, torch.Generator().manual_seed(
        1), dev)
    halo_b = {it: comms_bytes_per_layer(hb, 256, it) for it in (2, 4)}
    emit(phase="halo_bytes", card=card, batch="split", ep=2, d=256,
         nodes=int(split.num_nodes), real_nodes=int(split.node_mask.sum()),
         sent_rows=int(hb.halo_send_mask.sum()),
         halo_bytes_bf16=halo_b[2][0], all_reduce_bytes_bf16=halo_b[2][1],
         halo_bytes_f32=halo_b[4][0], all_reduce_bytes_f32=halo_b[4][1],
         snapped_sent_rows=int(to_halo(main_b, 2).halo_send_mask.sum()))
    emit(phase="ep_summary", card=card, spawn_seconds=spawn_s,
         aggregate_all_reduce_ms=agg_ms,
         two_count_max_abs_err=two_counts,
         seconds=round(time.perf_counter() - t_phase, 3), failed=bad)
    if bad:
        fail(f"ep phase: {bad}")
    return launches


# 8g3. chunked execution: --chunks K, one kernel call a layer over the K
# chunks of each batch
CHUNK_KS = (2, 4)
CHUNK_TIMED = 5
# the rounding floor's shifts: the flat batch's edges moved this many
# places on, which regroups them into other 64-edge BN moment tiles
CHUNK_SHIFTS = (8, 16, 32, 48)


def shifted(batch, s: int):
    """A host batch with ``s`` masked pad edges (dst = src = 0) in front
    and ``s`` of its tail pads dropped: the same function, its real edges
    in other 64-edge tiles."""
    import numpy as np
    from cartnet_tpu_torch.parallel.partition import EDGE_FIELDS, src_plan
    if np.asarray(batch.edge_mask)[-s:].any():
        fail(f"no {s} tail pad edges to shift")
    edges = {f: np.concatenate([np.zeros_like(getattr(batch, f)[:s]),
                                getattr(batch, f)[:-s]])
             for f in EDGE_FIELDS}
    n = batch.num_nodes
    return dataclasses.replace(
        batch, **edges, dst_rowptr=np.searchsorted(
            edges["edge_dst"], np.arange(n + 1)).astype(np.int32),
        **src_plan(edges["edge_src"], edges["edge_mask"], n))


def chunk_kernel_checks(card, batch, layout, gen, dev) -> dict:
    """K1 (training layout: saved residual and moments), K2, K4 and K5 on
    a chunk layout's batch against their plain versions, in the bf16 and
    the f32 training dtypes, with bitwise repeats -> their largest abs
    errors."""
    import torch
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    from cartnet_tpu_torch.ops.kernels import segment_kernels as sk
    d, n, out = 256, batch.num_nodes, {}
    idx = (batch.edge_dst, batch.edge_src, batch.edge_mask)
    sums = ("dxi", "dxj", "dwe", "db", "dw1g", "db1g", "dw1a", "db1a",
            "dscale", "dshift")
    for dt in (torch.bfloat16, torch.float32):
        case = f"{layout}_{str(dt)[6:]}"
        tol_of = (lambda o: CHECK_TOL["bf16"]) if dt == torch.bfloat16 \
            else (lambda o: CHECK_TOL["sum" if o in sums else "f32"])
        args = edge_inputs(batch, dt, dt, d, gen, dev)
        kw = dict(saved=True, moments=True)
        sargs = sigma_inputs(batch, dt, dt, d, gen, dev)
        eargs, bargs = backward_inputs(batch, dt, d, gen, dev)
        for kname, fn, plain, names in (
                ("edge_phase_fwd",
                 lambda: ek.edge_phase_fwd(*args, *idx, **kw),
                 lambda: ek.edge_phase_fwd_plain(*args, *idx,
                                                 tile=ek.TILE_EDGES, **kw),
                 ("gate", "sender", "saved", "s1_w", "M2_w")),
                ("sigma_segsum_fwd",
                 lambda: sk.sigma_segsum(*sargs, batch.edge_dst,
                                         batch.edge_mask, batch.dst_rowptr,
                                         n),
                 lambda: sk.sigma_segsum_plain(*sargs, batch.edge_dst,
                                               batch.edge_mask, n),
                 ("e_out", "aggr")),
                ("edge_phase_bwd", lambda: ek.edge_phase_bwd(*eargs),
                 lambda: edge_bwd_plain(*eargs), EDGE_BWD_OUT),
                ("sigma_segsum_bwd", lambda: sk.sigma_segsum_bwd(*bargs),
                 lambda: sk.sigma_segsum_bwd_plain(*bargs), SIGMA_BWD_OUT)):
            got, again, want = fn(), fn(), plain()
            torch.cuda.synchronize()
            out[f"{kname} {case}"] = check_outputs(
                card, kname, case, names, got, again, want, tol_of,
                nodes=n, edges=int(batch.num_edges))
    return out


def chunks_phase(card: str, dev, recs) -> dict:
    """8g3. Chunked single-device execution (``--chunks K``,
    parallel/chunk.py) at the flagship CartNet training config (dp_config:
    dim 256, 64 RBF, 4 layers, Cholesky head), bf16 and f32: the main
    path's eight crystals through ``runner.pipelines`` with K = 1, 2 and 4
    (the JAX runner's chunk slack on the pads, reported beside the
    prediction from the crystals' mean counts), the first test batch laid
    out by ``to_chunked``; one micro-step on the chunk layout against the
    flat step on the same crystals at the same pads (that batch before
    ``to_chunked``) from the same weights (loss and BN running stats
    within 1e-5 in f32, PRED_TOL in bf16; f32 gradients within the dp
    phase's 1e-4 a layer, or 1.5 times the flat step's own rounding floor
    where that is larger: its largest distance from the same step on the
    flat batch shifted by CHUNK_SHIFTS edges, which regroups the BN moment
    tiles as the chunk layout does; bf16 gradients through bf16_grad_gate)
    with the flat step's launches (K1, K2, K4, K5 4 each); the f32
    gradients' distance from the flat step at the flat pads (K = 1), from
    the chunk layout and from its flat batch; each micro-step's wall
    (median of CHUNK_TIMED) and device busy time (profile_call) beside the
    flat step's at the flat pads and at the same pads. K1, K2, K4 and K5
    against their plain versions on the K = 2 and 4 layouts and on the
    split batch's (split_batch: one crystal cut across the two chunks,
    whose src rows cross the chunks' blocks), which also takes the
    micro-step comparison. Then ``--dataset ADP --chunks 2`` through the
    CLI for one epoch on the adp phase's files (K1, K2, K4, K5 4 launches
    a micro-step, K1 and K2 4 an eval forward; finite stats with S12 and
    the IoU). -> launches per micro-step of each case."""
    import numpy as np
    import torch
    from cartnet_tpu_torch import cli, runner
    from cartnet_tpu_torch.data.pipeline import record_counts
    from cartnet_tpu_torch.models.factory import create_model
    from cartnet_tpu_torch.parallel.chunk import to_chunked
    from cartnet_tpu_torch.parallel.partition import pad_multiples
    from cartnet_tpu_torch.train import loop
    t_phase = time.perf_counter()
    bad, launches = [], {}
    micro_want = dict.fromkeys(KERNELS, 0)
    micro_want.update(dict.fromkeys(CARTNET_KERNELS, 4))
    splits = (recs, recs, recs)
    nodes, edges = record_counts(recs)

    def chunked_cfg(cfg, k):
        return dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, chunks=k))

    def first_test_batch(cfg):
        pipe = runner.pipelines(cfg, splits)[2]
        return next(iter(pipe)), (pipe.max_nodes, pipe.max_edges)

    def step(cfg, sd, batch, plain=None) -> dict:
        """One micro-step from ``sd`` on ``batch`` (``plain``: through
        the plain versions) with its launches."""
        model = create_model(cfg.model, dev, 0)
        launch_counts(reset=True)
        with (plain() if plain else contextlib.nullcontext()):
            loss, grads, bn = one_micro(cfg, model, sd, batch)
        return dict(loss=loss, grads=grads, bn=bn, launches=launch_counts(),
                    names=[n for n, _ in model.named_parameters()])

    def timed(cfg, sd, batch) -> dict:
        """The micro-step's wall ms (median of CHUNK_TIMED after a warm
        one) and one profiled call's device busy ms and kernels."""
        model = create_model(cfg.model, dev, 0)
        model.load_state_dict(sd)
        state = loop.init_train_state(model, loop.build_optimizer(
            cfg, model.parameters(), 1))
        micro = loop.make_steps(cfg)[0]
        run = lambda: micro(state, batch)
        times = []
        for _ in range(CHUNK_TIMED + 1):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof = profile_call(run)
        return dict(step_ms=statistics.median(times[1:]),
                    device_busy_ms=prof["device_busy_ms"],
                    device_kernels=prof["device_kernels"],
                    device_idle_share=prof["device_idle_share"])

    def floor_of(cfg, sd, host, flat) -> dict:
        """The flat step's own rounding floor: each gradient's largest
        distance (grad_errors) between the flat step and the same step
        on the batch shifted by CHUNK_SHIFTS edges."""
        errs = [grad_errors(flat["names"],
                            step(cfg, sd, shifted(host, n).to(dev))["grads"],
                            flat["grads"]) for n in CHUNK_SHIFTS]
        return {n: max(e[n] for e in errs) for n in flat["names"]}

    def compare(cfg, got, flat, alt=None, ref32=None, floor=None) -> tuple:
        """``got`` (the chunk layout's step) against the flat step: the
        line's numbers and what failed."""
        f32 = cfg.model.compute_dtype == torch.float32
        tol = 1e-5 if f32 else PRED_TOL
        loss_err = normalized_err(got["loss"], flat["loss"])[1]
        bn_err = max(normalized_err(x, y)[1]
                     for x, y in zip(got["bn"], flat["bn"])
                     if y.is_floating_point())
        line = dict(loss=float(got["loss"]), loss_flat=float(flat["loss"]),
                    loss_rel_err=loss_err, bn_stats_max_rel_err=bn_err,
                    launches_per_micro_step=got["launches"])
        fails = []
        if got["launches"] != micro_want or flat["launches"] != micro_want:
            fails.append(f"launches {got['launches']}, flat "
                         f"{flat['launches']}")
        if not (loss_err <= tol and bn_err <= tol):
            fails.append(f"loss {loss_err}, bn {bn_err}")
        if f32:
            g_err = grad_errors(got["names"], got["grads"], flat["grads"])
            worst = max(floor, key=floor.get)
            line.update(grads_max_rel_err_per_layer=max(g_err.values()),
                        grads_worst=max(g_err, key=g_err.get),
                        grads_over_1e4={n: e for n, e in g_err.items()
                                        if e > 1e-4},
                        floor_max=floor[worst], floor_worst=worst,
                        floor_of_worst=floor[max(g_err, key=g_err.get)])
            fails += [n for n, e in g_err.items()
                      if e > max(1e-4, 1.5 * floor[n])]
        else:
            gate = bf16_grad_gate(got["names"], got["grads"], flat["grads"],
                                  alt["grads"], ref32["grads"], PRED_TOL)
            worst = gate["groups"][gate["worst"]]
            line.update(grads_gate_worst_group=gate["worst"],
                        grads_gate_share_of_limit=worst["share"],
                        grads_vs_flat=worst["kernels_vs_plain"],
                        grads_flat_vs_plain=worst["plain_vs_alt"])
            fails += gate["failed"]
        return line, fails

    def layout_facts(flat, chunked, k) -> dict:
        n_per = chunked.num_nodes // k
        real = chunked.edge_mask.astype(bool)
        cross = int(np.sum(chunked.edge_src[real] // n_per
                           != chunked.edge_dst[real] // n_per))
        same = (int(flat.node_mask.sum()) == int(chunked.node_mask.sum())
                and int(flat.edge_mask.sum()) == int(real.sum()))
        return dict(flat_nodes=int(flat.num_nodes),
                    flat_edges=int(flat.num_edges),
                    nodes=int(chunked.num_nodes),
                    edges=int(chunked.num_edges),
                    real_nodes=int(chunked.node_mask.sum()),
                    real_edges=int(real.sum()), same_crystals=same,
                    halo_empty=bool(chunked.halo_empty),
                    edges_across_chunks=cross)

    def references(cfg, sd, host) -> dict:
        """The flat step on the host batch ``host`` and what a comparison
        with it needs: in bf16 the same step through the plain versions
        and in f32, in f32 its rounding floor."""
        hb = host.to(dev)
        out = dict(flat=step(cfg, sd, hb), alt=None, ref32=None, floor=None)
        if cfg.model.compute_dtype == torch.bfloat16:
            out.update(alt=step(cfg, sd, hb, plain_kernels),
                       ref32=step(with_dtype(cfg, torch.float32), sd, hb))
        else:
            out["floor"] = floor_of(cfg, sd, host, out["flat"])
        return out

    checks = {}
    gen = torch.Generator().manual_seed(3)
    for dt in ("bf16", "f32"):
        cfg = dp_config("cartnet", dt)
        sd = {k: v.clone() for k, v in
              create_model(cfg.model, dev, 0).state_dict().items()}
        flat_host, flat_pads = first_test_batch(cfg)
        fb = flat_host.to(dev)
        flat = step(cfg, sd, fb)
        flat_t = timed(cfg, sd, fb)
        for k in CHUNK_KS:
            host, pads = first_test_batch(chunked_cfg(cfg, k))
            t0 = time.perf_counter()
            chunked = to_chunked(host, k)
            layout_s = time.perf_counter() - t0
            node_mult, edge_mult = pad_multiples(k)
            slack = lambda mean, mult: -(-int(k * mean / 2 + mult)
                                         // mult) * mult
            predicted = (slack(np.mean(nodes), node_mult),
                         slack(np.mean(edges), edge_mult))
            facts = layout_facts(flat_host, chunked, k)
            b = chunked.to(dev)
            if dt == "bf16":
                checks.update(chunk_kernel_checks(card, b, f"chunks{k}",
                                                  gen, dev))
            ref = references(cfg, sd, host)
            got = step(cfg, sd, b)
            line, fails = compare(cfg, got, ref["flat"], ref["alt"],
                                  ref["ref32"], ref["floor"])
            # beside it: the flat step at the flat pads (K = 1), from the
            # chunk layout and from the same layout's flat batch
            names = got["names"]
            line.update(
                grads_vs_flat_pads=max(grad_errors(
                    names, got["grads"], flat["grads"]).values()),
                same_pads_vs_flat_pads=max(grad_errors(
                    names, ref["flat"]["grads"], flat["grads"]).values()))
            if not facts["same_crystals"] or not facts["halo_empty"]:
                fails.append(f"layout {facts}")
            case = f"chunks{k}_{dt}"
            launches[case] = line["launches_per_micro_step"]
            emit(phase="chunks", card=card, case=case, chunks=k,
                 compute_dtype=dt, **facts, flat_pads=flat_pads, pads=pads,
                 added=[pads[0] - flat_pads[0], pads[1] - flat_pads[1]],
                 slack_predicted=predicted, layout_seconds=layout_s, **line,
                 timing=timed(cfg, sd, b), flat_timing=flat_t,
                 same_pads_timing=timed(cfg, sd, host.to(dev)),
                 tol=1e-5 if dt == "f32" else PRED_TOL, failed=fails)
            bad += [f"{case}: {f}" for f in fails]
    # the split batch: one crystal cut across the two chunks
    split = split_batch(recs)
    chunked = to_chunked(split, 2)
    facts = layout_facts(split, chunked, 2)
    b = chunked.to(dev)
    checks.update(chunk_kernel_checks(card, b, "split", gen, dev))
    for dt in ("bf16", "f32"):
        cfg = dp_config("cartnet", dt)
        sd = {k: v.clone() for k, v in
              create_model(cfg.model, dev, 0).state_dict().items()}
        ref = references(cfg, sd, split)
        line, fails = compare(cfg, step(cfg, sd, b), ref["flat"],
                              ref["alt"], ref["ref32"], ref["floor"])
        if facts["halo_empty"] or not facts["edges_across_chunks"] \
                or not facts["same_crystals"]:
            fails.append(f"layout {facts}")
        case = f"split_{dt}"
        launches[case] = line["launches_per_micro_step"]
        emit(phase="chunks", card=card, case=case, chunks=2,
             compute_dtype=dt, **facts, **line,
             tol=1e-5 if dt == "f32" else PRED_TOL, failed=fails)
        bad += [f"{case}: {f}" for f in fails]
    # the CLI: one epoch of the ADP command with --chunks 2 on the adp
    # phase's files (24 / 4 / 4 crystals: 6 micro-steps, 2 eval forwards)
    data = os.path.abspath("adp_smoke_data")
    launch_counts(reset=True)
    t0 = time.perf_counter()
    state, test = cli.main(["--dataset", "ADP", "--dataset_path", data,
                            "--batch", "4", "--batch_accumulation", "16",
                            "--augment", "--chunks", "2", "--epochs", "1",
                            "--name", "adp_smoke_chunks"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    got = launch_counts()
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(CARTNET_KERNELS,
                              4 * (ADP_SPLITS["train"] // 4)))
    for k in ("edge_phase_fwd", "sigma_segsum_fwd"):
        want[k] += 4 * 2
    with open(os.path.join("results", "adp_smoke_chunks", "0", "train",
                           "stats.json")) as f:
        epoch_s = [json.loads(x)["time_epoch"] for x in f if x.strip()]
    if got != want:
        bad.append(f"cli: launches {got}, expected {want}")
    if int(state.bad_steps) or not {"similarity_index", "iou"} <= test.keys() \
            or not all(math.isfinite(v) for v in test.values()):
        bad.append(f"cli: bad steps {int(state.bad_steps)}, test {test}")
    emit(phase="chunks_summary", card=card, check_max_abs_err=checks,
         cli_launches=got, cli_expected_launches=want, cli_test=test,
         cli_seconds=round(cli_s, 3), cli_epoch_seconds=epoch_s,
         seconds=round(time.perf_counter() - t_phase, 3), failed=bad)
    if bad:
        fail(f"chunks phase: {bad}")
    return launches


# 8h. fused epochs: K micro-steps a CUDA-graph replay
FUSED_K = 16  # the main chunk: two replays = the train phase's 32 steps
FUSED_SMALL_K = 4  # f32, merged and Comformer chunks (one update each)
# per-micro-step launches of the fused chunks' wrappers, by case
FUSED_MICRO = {"cartnet": dict.fromkeys(CARTNET_KERNELS, 4),
               "merged": MERGED_MICRO, "ecomformer": ECO_MICRO,
               "icomformer": ICO_MICRO}


def fused_config(net: str, dt, accum: int = TRAIN_ACCUM):
    """The fused phase's flagship training configs (dim 256, 64 RBF, 4
    layers, Cholesky head, temperature and atom-type inputs)."""
    from cartnet_tpu_torch.config import Config, ModelConfig, OptimConfig
    return Config(model=ModelConfig(name=net, dim_in=256, dim_rbf=64,
                                    num_layers=4, cholesky=True,
                                    compute_dtype=dt),
                  optim=OptimConfig(max_epoch=1, batch_accumulation=accum))


def fused_state(cfg, dev, steps: int):
    """A fresh train state of ``cfg`` from seed 0."""
    from cartnet_tpu_torch.models.factory import create_model
    from cartnet_tpu_torch.train import loop
    model = create_model(cfg.model, dev, 0)
    return loop.init_train_state(model, loop.build_optimizer(
        cfg, model.parameters(), steps))


def fused_launches(case: str, per_steps: int) -> dict:
    """Each wrapper's expected launch count over ``per_steps`` micro-steps
    of ``case`` (FUSED_MICRO)."""
    out = dict.fromkeys(KERNELS, 0)
    out.update({k: v * per_steps for k, v in FUSED_MICRO[case].items()})
    return out


def fused_by_name(case: str, dt, steps: int) -> dict:
    """The CUDA kernels, by a piece of their names, that ``steps``
    CartNet micro-steps launch (LAUNCHES per wrapper call and dtype)."""
    out = {}
    for kname, n in FUSED_MICRO[case].items():
        for sub, m in launches_of(kname, dt).items():
            out[sub] = out.get(sub, 0) + n * m * steps
    return out


def replay_vs_eager(card, dev, net, dt, case, group, k, accum) -> dict:
    """One chunk of ``k`` micro-steps from one state (seed 0), run eagerly
    (``make_fused_chunk`` itself) and as a CUDA-graph replay
    (``ChunkRunner``: warm-up, capture, replay): the count of state
    tensors equal to the bit, each layer's weights and the BN buffers
    (their largest error over the layer's largest entry, as grad_errors),
    the per-step stats, the counters; the wrappers' launches during the
    runner's first call (the warm-up and the capture: 2 k micro-steps) ->
    {runner, state, line}."""
    import torch
    from cartnet_tpu_torch.train import loop
    from cartnet_tpu_torch.train.graphs import ChunkRunner, state_tensors
    cfg = fused_config(net, dt, accum)
    st = fused_state(cfg, dev, 2 * k)
    chunk = loop.make_fused_chunk(cfg, k)
    runner = ChunkRunner(chunk, k, dev)
    with merged_path(case == "merged"):
        kept = [t.detach().clone() for t in state_tensors(st)]
        e_stats = chunk(st, loop.stack_batches(group).to(dev))
        torch.cuda.synchronize()
        eager = [t.detach().clone() for t in state_tensors(st)]
        with torch.no_grad():
            for t, v in zip(state_tensors(st), kept):
                t.copy_(v)
        launch_counts(reset=True)
        t0 = time.perf_counter()
        r_stats = runner(st, group)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = launch_counts()
    replay = [t.detach().clone() for t in state_tensors(st)]
    names = [n for n, _ in st.model.named_parameters()]
    n_p = len(names)
    same = sum(bool(torch.equal(a, b)) for a, b in zip(eager, replay))
    p_err = grad_errors(names, replay[:n_p], eager[:n_p])
    bufs = loop.bn_buffers(st.model)
    b_err = max((normalized_err(a, b)[1] for a, b in
                 zip(replay[-len(bufs):], eager[-len(bufs):])
                 if a.is_floating_point()), default=0.0)
    s_err = max(normalized_err(r_stats[key], e_stats[key])[1]
                for key in e_stats)
    counters_same = all(torch.equal(a, b) for a, b in
                        zip(replay[n_p:n_p + 1], eager[n_p:n_p + 1])) and \
        int(st.accum_count) == 0 and int(st.bad_steps) == 0
    expect = fused_launches(case, 2 * k)
    tol = F32_STEP_TOL if dt == torch.float32 else PRED_TOL
    line = dict(model=net, case=case, compute_dtype=str(dt), k=k,
                batch_accumulation=accum, tensors=len(eager),
                tensors_bitwise=same, bitwise=same == len(eager),
                params_max_rel_err_per_layer=max(p_err.values()),
                params_worst=max(p_err, key=p_err.get),
                bn_stats_max_rel_err=b_err, stats_max_rel_err=s_err,
                updates=int(st.optimizer.count_t),
                launches_warmup_and_capture=launches,
                expected_launches=expect, first_call_seconds=first_s,
                capture=runner.captures[-1], tol=tol)
    fails = []
    if launches != expect:
        fails.append("launches")
    if not (max(p_err.values()) <= tol and b_err <= tol and s_err <= tol):
        fails.append("replay vs eager")
    if not counters_same or line["updates"] != k // accum:
        fails.append("counters")
    emit(phase="fused_replay_vs_eager", card=card, **line, failed=fails)
    return {"runner": runner, "state": st, "line": line, "fails": fails,
            "cfg": cfg}


def fused_phase(card: str, dev, batches) -> dict:
    """8h. Fused epochs (``--fused_steps``, train/graphs.py): K micro-steps
    of the training path as one CUDA-graph replay, at the flagship CartNet
    training config (dim 256, 64 RBF, 4 layers, Cholesky head, temperature
    and atom types, batch_accumulation 16) on the main path's two batches:

      * 32 micro-steps of ``train_epoch_fused`` with K = 16 (two replays,
        two updates on the device) against ``train_epoch`` from seed 0, in
        bf16 and f32: the update counts (2), the per-step losses, and each
        layer group's weight change through bf16_grad_gate (its second
        honest implementation the same fused epoch run eagerly, whose
        device update rounds otherwise than torch.optim.Adam, its scale
        the f32 unfused change; in f32 with F32_STEP_TOL and the f32
        change itself); the wrappers' launches (the warm-up and the
        capture);
      * one chunk's replay against the same chunk run eagerly from the same
        state (``replay_vs_eager``): bf16 K = 16, then K = 4 (one update)
        in f32, on the merged path and for the eComformer and the
        iComformer (bf16);
      * a ragged tail and a guard-rejected micro-step: K = 4 over 6
        batches (the third with a non-finite target), batch_accumulation
        2: the per-step valid flags, accum_count, bad_steps and the device
        update count against a host replay of the rule, then the flush;
      * one replay profiled: each CartNet kernel by CUDA name K times its
        launches a micro-step (bf16 K = 16; f32 and merged K = 4);
      * times (CUDA events, the card's name and power limit on each line):
        the wall a micro-step fused (a chunk's copy-in and replay over K)
        and unfused (``train_epoch`` over K host batches), the device busy
        time and idle share of one replay, each capture's seconds and pool
        bytes;
      * the CLI with ``--fused_steps 16`` on the adp phase's .pt files (two
        f32 epochs, then ``--resume`` one more with ``--profile``): stats
        lines with the unfused keys, a trace file.
    -> the launches of the main chunk (capture) and of one replay by name.
    """
    import torch
    from cartnet_tpu_torch import cli
    from cartnet_tpu_torch.train import loop
    from cartnet_tpu_torch.train.graphs import ChunkRunner
    t_phase = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    bad = []
    epoch = batches * (TRAIN_MICRO_STEPS // len(batches))
    group = epoch[:FUSED_K]

    # fused epoch against unfused epoch, bf16 and f32
    deltas, runs = {}, {}
    for dt in (f32, bf):
        cfg = fused_config("cartnet", dt)
        micro, update, _ = loop.make_steps(cfg)

        def unfused():
            st = fused_state(cfg, dev, len(epoch))
            p0 = [p.detach().clone() for p in st.optimizer.params]
            st, rows = loop.train_epoch(st, epoch, micro, update,
                                        TRAIN_ACCUM, dev)
            return st, [p.detach() - q for p, q in
                        zip(st.optimizer.params, p0)], rows

        ust, udelta, urows = unfused()
        # the second honest implementation: the same fused epoch run
        # eagerly (the device update, no graph), whose Adam rounds
        # otherwise than torch.optim.Adam's foreach path
        est = fused_state(cfg, dev, len(epoch))
        e0 = [p.detach().clone() for p in est.optimizer.params]
        echunk = loop.make_fused_chunk(cfg, FUSED_K)
        est, _ = loop.train_epoch_fused(
            est, epoch, lambda s, bs: echunk(s, loop.stack_batches(bs).to(
                dev)), FUSED_K, update, TRAIN_ACCUM, dev)
        edelta = [p.detach() - q for p, q in zip(est.optimizer.params, e0)]
        fst = fused_state(cfg, dev, len(epoch))
        p0 = [p.detach().clone() for p in fst.optimizer.params]
        runner = ChunkRunner(loop.make_fused_chunk(cfg, FUSED_K), FUSED_K,
                             dev)
        launch_counts(reset=True)
        t0 = time.perf_counter()
        fst, frows = loop.train_epoch_fused(fst, epoch, runner, FUSED_K,
                                            update, TRAIN_ACCUM, dev)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t0
        launches = launch_counts()
        fdelta = [p.detach() - q for p, q in zip(fst.optimizer.params, p0)]
        deltas[dt] = udelta
        runs[dt] = (fst, runner)
        names = [n for n, _ in fst.model.named_parameters()]
        ref = udelta if dt == f32 else deltas[f32]
        tol = F32_STEP_TOL if dt == f32 else PRED_TOL
        gate = bf16_grad_gate(names, fdelta, udelta, edelta, ref, tol)
        replay_err = max(g["kernels_vs_plain"] for g in bf16_grad_gate(
            names, fdelta, edelta, edelta, ref, tol)["groups"].values())
        worst = gate["groups"][gate["worst"]]
        loss_err = max(abs(float(a["loss"]) - b["loss"])
                       / max(abs(float(a["loss"])), 1e-30)
                       for (a, _), (b, _) in zip(urows, frows))
        expect = fused_launches("cartnet", 2 * FUSED_K)
        line = dict(compute_dtype=str(dt), micro_steps=len(epoch),
                    k=FUSED_K, batch_accumulation=TRAIN_ACCUM,
                    updates=fst.step, updates_unfused=ust.step,
                    accum_count=int(fst.accum_count),
                    bad_steps=int(fst.bad_steps),
                    loss_max_rel_err=loss_err,
                    delta_gate_worst_group=gate["worst"],
                    delta_fused_vs_unfused=worst["kernels_vs_plain"],
                    delta_eager_vs_unfused=worst["plain_vs_alt"],
                    delta_replay_vs_eager=replay_err,
                    delta_gate_limit=worst["limit"],
                    delta_gate_share_of_limit=worst["share"],
                    delta_gate_groups=gate["groups"],
                    launches=launches, expected_launches=expect,
                    seconds=fused_s, captures=runner.captures, tol=tol)
        fails = list(gate["failed"])
        if fst.step != 2 or ust.step != 2 or int(fst.accum_count) \
                or int(fst.bad_steps):
            fails.append("cadence")
        if not loss_err <= tol:
            fails.append("losses")
        if launches != expect:
            fails.append("launches")
        emit(phase="fused_epoch", card=card, **line, failed=fails)
        bad += [f"epoch {dt}: {f}" for f in fails]
    main_launches = launches  # bf16, the last of the loop

    # replay against eager
    cases = [("cartnet", bf, "cartnet", FUSED_K, TRAIN_ACCUM),
             ("cartnet", f32, "cartnet", FUSED_SMALL_K, FUSED_SMALL_K),
             ("cartnet", bf, "merged", FUSED_SMALL_K, FUSED_SMALL_K),
             ("ecomformer", bf, "ecomformer", FUSED_SMALL_K, FUSED_SMALL_K),
             ("icomformer", bf, "icomformer", FUSED_SMALL_K, FUSED_SMALL_K)]
    rve = {}
    for net, dt, case, k, accum in cases:
        r = replay_vs_eager(card, dev, net, dt, case, epoch[:k], k, accum)
        rve[(case, str(dt))] = r
        bad += [f"replay {case} {dt}: {f}" for f in r["fails"]]

    # a ragged tail and a guard-rejected micro-step: K = 4 over 6 batches
    cfg = fused_config("cartnet", bf, accum=2)
    st = fused_state(cfg, dev, 6)
    poison = batches[0].y.copy()
    poison[0] = float("nan")
    six = [batches[0], batches[1],
           dataclasses.replace(batches[0], y=poison), batches[1],
           batches[0], batches[1]]
    valid_want = [1, 1, 0, 1, 1, 1]
    runner = ChunkRunner(loop.make_fused_chunk(cfg, FUSED_SMALL_K),
                         FUSED_SMALL_K, dev)
    from cartnet_tpu_torch.data.batching import all_masked
    pad = [all_masked(six[-1])] * (2 * FUSED_SMALL_K - len(six))
    valid = []
    for c in range(2):
        part = (six + pad)[c * FUSED_SMALL_K:(c + 1) * FUSED_SMALL_K]
        valid += [int(v) for v in runner(st, part)["valid"].cpu()]
    count, acc, host_updates = int(st.optimizer.count_t), 0, 0
    for v in valid_want:  # the rule, replayed on the host
        acc += v
        if acc >= 2:
            host_updates, acc = host_updates + 1, 0
    dev_acc, dev_bad = int(st.accum_count), int(st.bad_steps)
    loop.sync_step(st)
    if dev_acc > 0:
        st = loop.make_steps(cfg)[1](st)
    finite = all(bool(torch.isfinite(p).all()) for p in st.optimizer.params)
    line = dict(k=FUSED_SMALL_K, batches=len(six), batch_accumulation=2,
                valid=valid[:len(six)], valid_pads=valid[len(six):],
                valid_expected=valid_want, accum_count=dev_acc,
                accum_count_expected=acc, bad_steps=dev_bad,
                device_updates=count, host_rule_updates=host_updates,
                updates_after_flush=st.step, params_finite=finite)
    fails = []
    if (valid != valid_want + [0, 0] or dev_acc != acc or dev_bad != 1
            or count != host_updates or st.step != host_updates + 1
            or not finite):
        fails.append("cadence")
    emit(phase="fused_ragged_guard", card=card, **line, failed=fails)
    bad += [f"ragged/guard: {f}" for f in fails]

    # one replay's kernels by CUDA name
    by_name = {}
    for case, dt, key in (("cartnet", bf, ("cartnet", str(bf))),
                          ("cartnet", f32, ("cartnet", str(f32))),
                          ("merged", bf, ("merged", str(bf)))):
        r = rve[key]
        k = r["line"]["k"]
        want = fused_by_name(case, dt, k)
        st, runner = r["state"], r["runner"]
        grp = epoch[:k]
        with merged_path(case == "merged"):
            evs = cuda_events(lambda: runner(st, grp), 1, want)
        got = {sub: sum(sub in ev.name for ev in evs) for sub in want}
        by_name[f"{case}_{str(dt).split('.')[-1]}"] = got
        emit(phase="fused_launches_by_name", card=card, case=case,
             compute_dtype=str(dt), k=k, kernels_per_replay=len(evs),
             by_name=got, expected=want, failed=got != want)
        if got != want:
            bad.append(f"by name {case} {dt}: {got}")

    # times: fused against unfused a micro-step, busy and idle of a replay
    st, runner = runs[bf]
    cfg = fused_config("cartnet", bf)
    micro, update, _ = loop.make_steps(cfg)
    ust = fused_state(cfg, dev, len(epoch))
    fused_ms = cuda_median_ms(lambda: runner(st, group), 10) / FUSED_K
    unfused_ms = cuda_median_ms(lambda: loop.train_epoch(
        ust, group, micro, update, TRAIN_ACCUM, dev), 5) / FUSED_K
    prof = profile_call(lambda: runner(st, group))
    emit(phase="fused_time", card=card, model="cartnet",
         compute_dtype="bf16", k=FUSED_K,
         micro_step_ms_fused=fused_ms, micro_step_ms_unfused=unfused_ms,
         replay_wall_ms=prof["wall_ms"],
         replay_device_busy_ms=prof["device_busy_ms"],
         replay_device_idle_share=prof["device_idle_share"],
         replay_kernels=prof["device_kernels"],
         busy_ms_per_micro_step=prof["device_busy_ms"] / FUSED_K,
         top_kernels_ms=prof["top_kernels_ms"],
         captures=[c for _, (_, rn) in runs.items() for c in rn.captures]
         + [r["line"]["capture"] for r in rve.values()])

    # the CLI on the adp phase's .pt files
    data = os.path.abspath("adp_smoke_data")
    argv = ["--dataset", "ADP", "--dataset_path", data, "--batch", "4",
            "--batch_accumulation", "16", "--augment", "--fused_steps",
            str(FUSED_K), "--name", "adp_fused"]
    t0 = time.perf_counter()
    cstate, ctest = cli.main(argv + ["--epochs", "2"])
    rstate, rtest = cli.main(argv + ["--epochs", "3", "--resume",
                                     "--profile"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    run_dir = os.path.join("results", "adp_fused", "0")
    keys = {"epoch", "time_epoch", "time_iter", "lr", "params", "loss",
            "MAE", "MSE", "volume_percentage_error", "similarity_index",
            "edges_per_sec", "gpu_memory"}
    with open(os.path.join(run_dir, "train", "stats.json")) as f:
        lines = [json.loads(x) for x in f]
    traces = [n for _, _, fs in os.walk(os.path.join(run_dir, "profile"))
              for n in fs]
    line = dict(epochs=[x["epoch"] for x in lines],
                train_keys_match=all(set(x) == keys for x in lines),
                updates=[cstate.step, rstate.step],
                finite=all(math.isfinite(x["loss"]) for x in lines)
                and all(math.isfinite(v) for v in rtest.values()),
                trace_files=len(traces), seconds=round(cli_s, 3))
    fails = []
    if (line["epochs"] != [0, 1, 2] or not line["train_keys_match"]
            or line["updates"] != [2, 3] or not line["finite"]
            or not traces):
        fails.append("cli")
    emit(phase="fused_cli", card=card, **line, failed=fails)
    bad += fails
    emit(phase="fused_summary", card=card,
         seconds=round(time.perf_counter() - t_phase, 3), failed=bad)
    if bad:
        fail(f"fused phase: {bad}")
    return {"capture": main_launches, "replay": by_name,
            "comformers": {c: rve[(c, str(bf))]["line"][
                "launches_warmup_and_capture"]
                for c in ("ecomformer", "icomformer")}}


# ----------------------------------------------------------------- main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from cartnet_tpu_torch.ops.kernels import _build
    except ImportError as err:
        print(f"chip_smoke: the cartnet_tpu_torch package is not beside this "
              f"script ({err})", file=sys.stderr)
        return 2
    # the CLI runs write run dirs (results/<name>/<seed>): all of them land
    # in a temporary directory, removed at exit, never in the checkout
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, \
            contextlib.chdir(tmp):
        return phases(_build)


def phases(_build) -> int:
    """Every phase after the checks of ``main``, in the working
    directory it set."""
    import torch
    from cartnet_tpu_torch import cli, runner
    from cartnet_tpu_torch.config import (Config, ModelConfig, OptimConfig,
                                          resolve_device)
    from cartnet_tpu_torch.data.batching import make_batches
    from cartnet_tpu_torch.data.synthetic import synthetic_dataset
    from cartnet_tpu_torch.models import cartnet as model_mod
    from cartnet_tpu_torch.models.factory import create_model
    from cartnet_tpu_torch.nn.norm import combine_window_moments
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    from cartnet_tpu_torch.ops.kernels import segment_kernels as sk
    from cartnet_tpu_torch.ops.kernels import segsum_kernels as k3
    from cartnet_tpu_torch.ops.kernels import tp_kernels as k7
    from cartnet_tpu_torch.train import loop

    # the default phases run the default CartNet train path; the merged
    # phases set CARTNET_MERGED=1 themselves (merged_path)
    os.environ["CARTNET_MERGED"] = "0"

    # 1. device
    dev = resolve_device("cuda")
    card = card_label()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    emit(phase="device", card=card, kind=name,
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for src in SOURCES:
        log = (_build.BUILD_DIR / f"{src}.log")
        ptxas[src] = ptxas_report(log.read_text()) if log.exists() else []
    emit(phase="build", card=card, seconds=round(build_s, 3), ptxas=ptxas)
    # the CPU tests' mirrors of the shared-memory plans against the CUDA
    # sources' own (K1 per edge dtype; K8 per pass and layer, at every
    # padded width; K7 per dtype and layer at every width it runs: its bf16
    # block of warpgroup tiles and wt ring, its f32 tile), and of K4's
    # scratch rows (one per row-pass block) at a few E
    plans, bad_plans = [], []
    for wp in range(ek.GRANULE, ek.MAX_WIDTH + 1, ek.GRANULE):
        for is_bf in (1, 0):
            plans.append(("K1", wp, is_bf, ek._lib().edge_phase_fwd_smem(
                wp, is_bf), ek.fwd_smem_plan(wp, bool(is_bf))["total"]))
            for l2 in (0, 1):
                plan = k7.bwd_smem_plan(wp, bool(l2))
                for kind, key in ((0, "tile"), (1, "weights")) if is_bf \
                        else ((2, "tile_f32"), (3, "weights_f32")):
                    plans.append((f"K8 l{l2 + 1} {key}", wp, is_bf,
                                  k7._lib_bwd().tp_contract_bwd_smem(
                                      wp, kind, l2), plan[key]))
    for wp in range(k7.TC_MIN_WIDTH, k7.MAX_WIDTH + 1, k7.GRANULE):
        for is_bf in (1, 0):
            for l2 in (0, 1):
                plans.append((f"K7 l{l2 + 1}", wp, is_bf,
                              k7._lib().tp_contract_fwd_smem(wp, is_bf, l2),
                              k7.fwd_smem_bytes(wp, bool(is_bf), bool(l2))))
    for n_e in (1, 5, 20993, E_MAIN):
        plans.append(("K4 parts", n_e, None,
                      sk._lib_bwd().sigma_segsum_bwd_parts(n_e),
                      sk.bwd_parts(n_e, n_sm)))
    bad_plans = [p for p in plans
                 if p[3] != p[4] or not 0 < p[3] <= 232448]
    emit(phase="smem_plans", card=card, checked=len(plans),
         mismatched=bad_plans)
    if bad_plans:
        fail(f"shared-memory plans or scratch rows differ from their "
             f"Python mirrors or exceed a block: {bad_plans}")

    # main-path data: 8 ADP-scale crystals, RCM, 2 batches of 4
    d = 256
    recs = synthetic_dataset(8, mean_atoms=194, radius=5.0, adp=True, seed=0)
    batches = make_batches(recs, 4)
    b0 = batches[0].to(dev)
    N, E = b0.num_nodes, b0.num_edges
    idx = (b0.edge_dst, b0.edge_src, b0.edge_mask)
    gen = torch.Generator().manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    # (node tables / gate dtype, edge dtype, calls per forward at bf16)
    cases = {"layer0_bf16": (bf, bf, 1), "layers1to3_bf16": (f32, bf, 3),
             "f32_config": (f32, f32, 0)}
    # training: one dtype throughout (calls per micro-step at bf16)
    train_cases = {"train_bf16": (bf, 4), "f32_config": (f32, 0)}
    # eComformer, calls per bf16 forward: K3 (values dtype, width), K7
    # (h / W dtype, a dtype; one l1 and one l2 call each)
    seg_cases = {"f32_128": (f32, 128, 1), "bf16_64": (bf, 64, 1),
                 "bf16_128": (bf, 128, 0)}
    tp_cases = {"bf16_f32a": (bf, f32, 1), "bf16": (bf, bf, 0),
                "f32_config": (f32, f32, 0)}
    # eComformer training, calls per bf16 micro-step: K3's perm=None form as
    # the sorted gather's backward (dtype, width: q, s_node, cat1), K8
    # (dtype; one l1 and one l2 call each)
    gather_cases = {"gather_bf16_256": (bf, 256, 3),
                    "gather_bf16_64": (bf, 64, 1),
                    "gather_bf16_128": (bf, 128, 1),
                    "gather_f32_256": (f32, 256, 0)}
    tp_bwd_cases = {"bf16": (bf, 1), "f32_config": (f32, 0)}

    # 3. kernel checks
    check_err = dict.fromkeys(KERNELS, 0.0)
    timing_inputs = {}
    for case, (tdt, edt, _) in cases.items():
        tol = CHECK_TOL["f32" if tdt == edt == f32 else "bf16"]
        args = edge_inputs(b0, tdt, edt, d, gen, dev)
        for extras in (False, True):
            kw = dict(saved=extras, moments=extras)
            got = ek.edge_phase_fwd(*args, *idx, **kw)
            again = ek.edge_phase_fwd(*args, *idx, **kw)
            want = ek.edge_phase_fwd_plain(*args, *idx, tile=ek.TILE_EDGES,
                                           **kw)
            torch.cuda.synchronize()
            names = ("gate", "sender", "saved", "s1_w", "M2_w")
            if any((g is None) != (w is None) for g, w in zip(got, want)):
                fail("edge_phase_fwd returned optional outputs unasked")
            keep = [i for i, w in enumerate(want) if w is not None]
            err = check_outputs(card, "edge_phase_fwd", case,
                                [names[i] for i in keep],
                                [got[i] for i in keep],
                                [again[i] for i in keep],
                                [want[i] for i in keep], lambda _: tol,
                                optional_outputs=extras)
            if case != "f32_config":
                check_err["edge_phase_fwd"] = max(
                    check_err["edge_phase_fwd"], err)
        timing_inputs[("edge", case)] = args

        sargs = sigma_inputs(b0, tdt, edt, d, gen, dev)
        got = sk.sigma_segsum(*sargs, b0.edge_dst, b0.edge_mask,
                              b0.dst_rowptr, N)
        again = sk.sigma_segsum(*sargs, b0.edge_dst, b0.edge_mask,
                                b0.dst_rowptr, N)
        want = sk.sigma_segsum_plain(*sargs, b0.edge_dst, b0.edge_mask, N)
        torch.cuda.synchronize()
        err = check_outputs(card, "sigma_segsum_fwd", case, ("e_out", "aggr"),
                            got, again, want, lambda _: tol)
        if case != "f32_config":
            check_err["sigma_segsum_fwd"] = max(
                check_err["sigma_segsum_fwd"], err)
        timing_inputs[("sigma", case)] = sargs

    for case, (dt, _) in train_cases.items():
        eargs, sargs = backward_inputs(b0, dt, d, gen, dev)
        sums = ("dxi", "dxj", "dwe", "db", "dw1g", "db1g", "dw1a", "db1a",
                "dscale", "dshift")
        tol_of = (lambda o: CHECK_TOL["bf16"]) if dt == bf else (
            lambda o: CHECK_TOL["sum" if o in sums else "f32"])
        for kname, fn, plain, names, a in (
                ("edge_phase_bwd", ek.edge_phase_bwd, edge_bwd_plain,
                 EDGE_BWD_OUT, eargs),
                ("sigma_segsum_bwd", sk.sigma_segsum_bwd,
                 sk.sigma_segsum_bwd_plain, SIGMA_BWD_OUT, sargs)):
            got, again, want = fn(*a), fn(*a), plain(*a)
            torch.cuda.synchronize()
            err = check_outputs(card, kname, case, names, got, again, want,
                                tol_of)
            if dt == bf:
                check_err[kname] = max(check_err[kname], err)
        timing_inputs[("edge_bwd", case)] = eargs
        timing_inputs[("sigma_bwd", case)] = sargs
        # K1's pre-only residual (the merged path's forward): gate, sender
        # and moments bitwise those of the [pre | sig] layout, pre its first
        # half; then K6 on it
        margs, kargs = merged_inputs(b0, dt, d, gen, dev)
        kw = dict(saved=True, pre_only=True, moments=True)
        got, again = (ek.edge_phase_fwd(*kargs, *idx, **kw) for _ in range(2))
        want = ek.edge_phase_fwd_plain(*kargs, *idx, **kw)
        full = ek.edge_phase_fwd(*kargs, *idx, saved=True, moments=True)
        torch.cuda.synchronize()
        layout_same = all(torch.equal(got[i], full[i]) for i in (0, 1, 3, 4)) \
            and torch.equal(got[2], full[2][:, :2 * d])
        check_outputs(card, "edge_phase_fwd", f"{case}_pre_only",
                      ("gate", "sender", "pre", "s1_w", "M2_w"), got, again,
                      want, lambda _, t=CHECK_TOL["bf16" if dt == bf
                                                  else "f32"]: t,
                      same_as_pre_sig_layout=layout_same)
        if not layout_same:
            fail(f"edge_phase_fwd {case}: the pre-only layout changed gate, "
                 f"sender or the moments")
        got, again, want = (ek.merged_bwd(*margs), ek.merged_bwd(*margs),
                            merged_bwd_plain(*margs))
        torch.cuda.synchronize()
        err = check_outputs(card, "edge_phase_merged_bwd", case,
                            EDGE_BWD_OUT, got, again, want, tol_of)
        if dt == bf:
            check_err["edge_phase_merged_bwd"] = err
        timing_inputs[("merged_bwd", case)] = margs
        timing_inputs[("merged_fwd", case)] = kargs

    # the f32 passes of K1, K5 and K6 bounded by a batch's live edge counts
    # (edge_kernels.live_edges) at the training cell's pads, with a tail of
    # pads past 41,472 edges, against the plain versions on the same
    # inputs: K1's live rows (its tail is zero, kernel_ab.live_compare),
    # every output of K5 and K6
    from cartnet_tpu_torch.tools import kernel_ab as kab
    n_live = kab.LIVE_COUNTS[1]
    lay = kab.tail_layout(n_live, dev)
    live = ek.live_edges(lay.edge_mask, lay.edge_mask_src_sorted)
    for name, (wrapper, _, fn, plain) in kab.live_calls(lay, gen, d).items():
        got, again, want = (kab.live_rows(name, o, n_live)
                            for o in (fn(live), fn(live), plain()))
        torch.cuda.synchronize()
        check_outputs(card, wrapper, "f32_live_" + name.replace(" ", "_"),
                      list(want), list(got.values()), list(again.values()),
                      list(want.values()),
                      lambda o, k=name: kab.live_tol(k, o),
                      live=[int(v) for v in live], edges=lay.num_edges)
    del lay, live

    # K3 and K7 in the dtype cases of the eComformer forward (calls per
    # bf16 forward); K3's bf16 [E, 128] case is the JAX package's padded
    # width, the port scatters out_e [E, 64] alone
    for case, (dt, width, _) in seg_cases.items():
        sargs = seg_args(b0, dt, width, gen, dev)
        got, again = k3.segment_sum_csr(*sargs), k3.segment_sum_csr(*sargs)
        want = k3.segment_sum_csr_plain(*sargs)
        torch.cuda.synchronize()
        err = check_outputs(card, "segment_sum_csr", case, ("out",), (got,),
                            (again,), (want,),
                            lambda _: CHECK_TOL["sum" if dt == f32
                                                else "bf16"])
        check_err["segment_sum_csr"] = max(check_err["segment_sum_csr"], err)
        timing_inputs[("seg", case)] = sargs
    for case, (hdt, adt, _) in tp_cases.items():
        targs = tp_args(b0, hdt, adt, d, gen, dev)
        tol = CHECK_TOL["sum" if hdt == f32 else "bf16"]
        for l2, names, a in zip((False, True), (("c0", "c1", "c2"), ("out",)),
                                tp_calls(targs)):
            fn = k7.tp_contract_l2 if l2 else k7.tp_contract_l1
            got, again, want = ([o] if l2 else list(o) for o in (
                fn(*a), fn(*a), tp_plain(l2)(*a)))
            torch.cuda.synchronize()
            err = check_outputs(card, "tp_contract_fwd",
                                f"{'l2' if l2 else 'l1'}_{case}", names, got,
                                again, want, lambda _: tol)
            if case == "bf16_f32a":
                check_err["tp_contract_fwd"] = max(
                    check_err["tp_contract_fwd"], err)
        timing_inputs[("tp", case)] = targs
    # K3 over dst_rowptr and the edge mask (gather_sorted's backward), on
    # cotangents that are zero on pad rows, as the model's are
    for case, (dt, width, _) in gather_cases.items():
        ct = (torch.randn(E, width, generator=gen).to(dev)
              * b0.edge_mask[:, None]).to(dt)
        gargs = (ct, b0.dst_rowptr, b0.edge_mask)
        got, again = k3.segment_sum_csr(*gargs), k3.segment_sum_csr(*gargs)
        want = k3.segment_sum_csr_plain(*gargs)
        torch.cuda.synchronize()
        check_outputs(card, "segment_sum_csr", case, ("out",), (got,),
                      (again,), (want,),
                      lambda _: CHECK_TOL["sum" if dt == f32 else "bf16"])
        timing_inputs[("seg", case)] = gargs
    # K2 and K3 at widths that are not a multiple of 8, K2 on each route
    # (a generator of their own: the later phases' inputs stay as they were)
    odd_width_checks(card, b0, torch.Generator().manual_seed(11), dev)
    # K8 on K7's operands (bf16 h, a and W; the f32 config) with random
    # cotangents that are zero on pad rows
    for case, (dt, _) in tp_bwd_cases.items():
        targs = tp_args(b0, dt, dt, d, gen, dev)
        for l2 in (False, True):
            a = tp_bwd_args(targs, l2, b0.edge_mask, gen)
            got, again = (tp_bwd_flat(k7.tp_contract_bwd(*a))
                          for _ in range(2))
            want = tp_bwd_flat(k7.tp_contract_bwd_plain(*a))
            torch.cuda.synchronize()
            tol_of = (lambda o: CHECK_TOL["bf16"]) if dt == bf else (
                lambda o: CHECK_TOL["f32" if o.startswith("da") else "sum"])
            err = check_outputs(card, "tp_contract_bwd",
                                f"{'l2' if l2 else 'l1'}_{case}",
                                TP_BWD_OUT[l2], got, again, want, tol_of)
            if dt == bf:
                check_err["tp_contract_bwd"] = max(
                    check_err["tp_contract_bwd"], err)
            timing_inputs[("tp_bwd", l2, case)] = a

    # 4. main path: the inference sweep through the kernels
    cfg = ModelConfig(dim_in=d, dim_rbf=64, num_layers=4, cholesky=True,
                      compute_dtype=bf)
    model = model_mod.CartNet(cfg, device=dev, seed=0)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_path = str(_build.BUILD_DIR / "chip_smoke_inference.pkl")
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = runner.inference(model, batches, out_path, device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches_inf = launch_counts()
    expect = cfg.num_layers * len(batches)
    expect_inf = dict.fromkeys(KERNELS, 0)
    expect_inf.update(edge_phase_fwd=expect, sigma_segsum_fwd=expect)
    preds = [torch.as_tensor(p) for p in out["pred"]]
    finite = all(bool(torch.isfinite(p).all()) for p in preds)
    n_atoms = sum(p.shape[0] for p in preds)
    emit(phase="main", card=card, batches=len(batches), structures=len(preds),
         atoms=n_atoms, nodes=N, edges=E,
         real_edges=[int(b.edge_mask.sum()) for b in batches],
         launches=launches_inf, expected_launches=expect_inf,
         sweep_seconds=round(sweep_s, 3), finite=finite,
         mean_mae=float(statistics.fmean(out["mae"])))
    if launches_inf != expect_inf:
        fail(f"launch counts {launches_inf}, expected {expect_inf}")
    if not finite or len(preds) != len(recs):
        fail("non-finite or missing predictions")

    # the same model through the plain versions on the card
    kernel_fns = (model_mod.edge_phase_fwd, model_mod.sigma_segsum)

    def use_plain(on: bool):
        model_mod.edge_phase_fwd, model_mod.sigma_segsum = (
            (ek.edge_phase_fwd_plain, sigma_fwd_plain) if on else kernel_fns)

    pred_err = 0.0
    fwd_ms, fwd_plain_ms = [], []
    with torch.inference_mode():
        for b in batches:
            bd = b.to(dev)
            pk, mask = model(bd)
            use_plain(True)
            try:
                pp, _ = model(bd)
                fwd_plain_ms.append(cuda_median_ms(lambda: model(bd), 20))
            finally:
                use_plain(False)
            fwd_ms.append(cuda_median_ms(lambda: model(bd), 20))
            m = mask.bool()
            abs_err, rel = normalized_err(pk[m], pp[m])
            pred_err = max(pred_err, rel)
            emit(phase="main_vs_plain", card=card, max_abs_err=abs_err,
                 max_rel_err=rel, tol=PRED_TOL)
    if pred_err > PRED_TOL:
        fail(f"kernel forward vs plain forward: rel err {pred_err}")

    # 5. train: the flagship training config through make_steps/train_epoch
    tcfg = Config(model=ModelConfig(dim_in=d, dim_rbf=64, num_layers=4,
                                    cholesky=True, use_temperature=True,
                                    use_atom_types=True, compute_dtype=bf),
                  optim=OptimConfig(max_epoch=1,
                                    batch_accumulation=TRAIN_ACCUM))
    tmodel = model_mod.CartNet(tcfg.model, device=dev, seed=0)
    opt = loop.build_optimizer(tcfg, tmodel.parameters(), TRAIN_MICRO_STEPS)
    state = loop.init_train_state(tmodel, opt)
    micro, update, _ = loop.make_steps(tcfg)
    dev_batches = [b.to(dev) for b in batches]
    epoch = dev_batches * (TRAIN_MICRO_STEPS // len(dev_batches))
    bn0 = [t.clone() for t in loop.bn_buffers(tmodel)]
    launch_counts(reset=True)
    t0 = time.perf_counter()
    state, rows = loop.train_epoch(state, epoch, micro, update, TRAIN_ACCUM,
                                   dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches_train = launch_counts()
    losses = [float(r[0]["loss"]) for r in rows]
    bn_moved = all(not torch.equal(a, b)
                   for a, b in zip(bn0, loop.bn_buffers(tmodel)))
    expect_train = dict.fromkeys(KERNELS, 0)
    expect_train.update(dict.fromkeys(CARTNET_KERNELS, 4 * len(epoch)))
    emit(phase="train", card=card, micro_steps=len(epoch),
         batch_accumulation=TRAIN_ACCUM, optimizer_steps=state.step,
         launches=launches_train, expected_launches=expect_train,
         launches_per_micro_step={k: v / len(epoch)
                                  for k, v in launches_train.items()},
         loss_first=losses[0], loss_last=losses[-1],
         finite=all(math.isfinite(x) for x in losses),
         bad_steps=int(state.bad_steps), bn_stats_updated=bn_moved,
         seconds=round(train_s, 3))
    if launches_train != expect_train:
        fail(f"train launch counts {launches_train}, expected "
             f"{expect_train}")
    if not all(math.isfinite(x) for x in losses) or int(state.bad_steps):
        fail("non-finite train losses or skipped steps")
    if state.step != len(epoch) // TRAIN_ACCUM or not bn_moved:
        fail(f"{state.step} optimizer steps, BN stats moved: {bn_moved}")

    # the user's entry point: one short training run through the CLI
    # (flagship widths, the CLI's synthetic splits of 8 / 2 / 2 crystals:
    # 2 train micro-steps, 1 val and 1 test batch)
    launch_counts(reset=True)
    t0 = time.perf_counter()
    cstate, ctest = cli.main(["--dataset", "synthetic", "--cholesky",
                              "--limit", "8", "--epochs", "1",
                              "--batch_accumulation", "2", "--bf16"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches_cli = launch_counts()
    expect_cli = dict(zip(KERNELS, (4 * 4, 4 * 4, 4 * 2, 4 * 2, 0, 0, 0, 0)))
    emit(phase="cli", card=card, launches=launches_cli,
         expected_launches=expect_cli, optimizer_steps=cstate.step,
         bad_steps=int(cstate.bad_steps), test=ctest,
         seconds=round(cli_s, 3))
    if launches_cli != expect_cli or cstate.step != 1 or not all(
            math.isfinite(v) for v in ctest.values()):
        fail(f"CLI training run: launches {launches_cli}, "
             f"{cstate.step} optimizer steps, test stats {ctest}")

    # one micro-step from the same state, kernels vs plain versions: the
    # trained bf16 model, and the f32 config at its initial state
    train_vs_plain(card, tcfg, tmodel, dev_batches[0], PRED_TOL)
    cfg32 = dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, compute_dtype=f32))
    train_vs_plain(card, cfg32, model_mod.CartNet(cfg32.model, device=dev,
                                                  seed=0),
                   dev_batches[0], F32_STEP_TOL)

    # 6. the merged CartNet training path (CARTNET_MERGED=1, the JAX
    # package's fused_edge_sigma with its merged backward): the flagship
    # training config from seed 0, 16 micro-steps = 1 optimizer update
    # through K1 (pre-only residual), K2 and K6, no K4 or K5
    mmodel = model_mod.CartNet(tcfg.model, device=dev, seed=0)
    mopt = loop.build_optimizer(tcfg, mmodel.parameters(), TRAIN_ACCUM)
    mstate = loop.init_train_state(mmodel, mopt)
    mepoch = dev_batches * (TRAIN_ACCUM // len(dev_batches))
    mbn0 = [t.clone() for t in loop.bn_buffers(mmodel)]
    with merged_path():
        launch_counts(reset=True)
        t0 = time.perf_counter()
        mstate, mrows = loop.train_epoch(mstate, mepoch, micro, update,
                                         TRAIN_ACCUM, dev)
        torch.cuda.synchronize()
        mtrain_s = time.perf_counter() - t0
        launches_mtrain = launch_counts()
    mlosses = [float(r[0]["loss"]) for r in mrows]
    mbn_moved = all(not torch.equal(a, b)
                    for a, b in zip(mbn0, loop.bn_buffers(mmodel)))
    expect_mtrain = dict.fromkeys(KERNELS, 0)
    expect_mtrain.update({k: v * len(mepoch) for k, v in MERGED_MICRO.items()})
    emit(phase="merged_train", card=card, micro_steps=len(mepoch),
         batch_accumulation=TRAIN_ACCUM, optimizer_steps=mstate.step,
         launches=launches_mtrain, expected_launches=expect_mtrain,
         launches_per_micro_step={k: v / len(mepoch)
                                  for k, v in launches_mtrain.items()},
         loss_first=mlosses[0], loss_last=mlosses[-1],
         finite=all(math.isfinite(x) for x in mlosses),
         bad_steps=int(mstate.bad_steps), bn_stats_updated=mbn_moved,
         seconds=round(mtrain_s, 3))
    if launches_mtrain != expect_mtrain:
        fail(f"merged train launch counts {launches_mtrain}, expected "
             f"{expect_mtrain}")
    if not all(math.isfinite(x) for x in mlosses) or int(mstate.bad_steps):
        fail("non-finite merged train losses or skipped steps")
    if mstate.step != len(mepoch) // TRAIN_ACCUM or not mbn_moved:
        fail(f"merged: {mstate.step} optimizer steps, BN stats moved: "
             f"{mbn_moved}")

    # the user's entry point with the JAX package's switch set: a short
    # training run through the CLI (2 train micro-steps, 1 val and 1 test
    # forward)
    with merged_path():
        launch_counts(reset=True)
        t0 = time.perf_counter()
        mcstate, mctest = cli.main(["--dataset", "synthetic", "--cholesky",
                                    "--limit", "8", "--epochs", "1",
                                    "--batch_accumulation", "2", "--bf16"])
        torch.cuda.synchronize()
        mcli_s = time.perf_counter() - t0
        launches_mcli = launch_counts()
    expect_mcli = dict.fromkeys(KERNELS, 0)
    expect_mcli.update(edge_phase_fwd=4 * 4, sigma_segsum_fwd=4 * 4,
                       edge_phase_merged_bwd=4 * 2)
    emit(phase="merged_cli", card=card, launches=launches_mcli,
         expected_launches=expect_mcli, optimizer_steps=mcstate.step,
         bad_steps=int(mcstate.bad_steps), test=mctest,
         seconds=round(mcli_s, 3))
    if launches_mcli != expect_mcli or mcstate.step != 1 or not all(
            math.isfinite(v) for v in mctest.values()):
        fail(f"merged CLI training run: launches {launches_mcli}, "
             f"{mcstate.step} optimizer steps, test stats {mctest}")

    # one merged micro-step through the kernels and through the plain
    # versions (the trained bf16 model; the f32 config at its initial
    # state), then merged vs default from the default phase's trained state
    with merged_path():
        train_vs_plain(card, tcfg, mmodel, dev_batches[0], PRED_TOL)
        train_vs_plain(card, cfg32, model_mod.CartNet(cfg32.model,
                                                      device=dev, seed=0),
                       dev_batches[0], F32_STEP_TOL)
    merged_vs_default(card, tcfg, tmodel, dev_batches[0])

    # 6b. widths: the CartNet edge kernels at d = 32, 64, 96 (zero-padded to
    # their 128-column granule inside the wrappers) and 384, 512: K1 in its
    # training layout, K2, K4, K5, K6 against their plain versions with
    # bitwise repeats (K5/K6's passes timed past 256); then one CartNet
    # forward and one micro-step per backward path through the kernels
    # against the plain versions, with their launch counts. Then the
    # eComformer at d = 64, 384, 512: K7 and K8 (l1, l2) against their plain
    # versions with repeats (K8's passes timed at 512), one forward and one
    # micro-step, likewise.
    sums = ("dxi", "dxj", "dwe", "db", "dw1g", "db1g", "dw1a", "db1a",
            "dscale", "dshift")
    for wd in CARTNET_WIDTHS:
        for wdt, wname in ((bf, "bf16"), (f32, "f32")):
            case = f"d{wd}_{wname}"
            tol_of = (lambda o: CHECK_TOL["bf16"]) if wdt == bf else (
                lambda o: CHECK_TOL["sum" if o in sums else "f32"])
            elem_tol = lambda _, t=CHECK_TOL["bf16" if wdt == bf
                                             else "f32"]: t
            kargs = edge_inputs(b0, wdt, wdt, wd, gen, dev)
            kw = dict(saved=True, moments=True)
            got, again = (ek.edge_phase_fwd(*kargs, *idx, **kw)
                          for _ in range(2))
            want = ek.edge_phase_fwd_plain(*kargs, *idx, **kw)
            torch.cuda.synchronize()
            check_outputs(card, "edge_phase_fwd", case,
                          ("gate", "sender", "saved", "s1_w", "M2_w"), got,
                          again, want, elem_tol)
            # device ms per call of each kernel at this width (training
            # layouts), padded copies included
            k1_fn = lambda a=kargs: ek.edge_phase_fwd(*a, *idx, **kw)
            times = {"edge_phase_fwd": device_ms(
                k1_fn, kernels=launches_of("edge_phase_fwd", wdt))}
            sargs = sigma_inputs(b0, wdt, wdt, wd, gen, dev)
            sfn = lambda a=sargs: sk.sigma_segsum(
                *a, b0.edge_dst, b0.edge_mask, b0.dst_rowptr, N)
            got, again = sfn(), sfn()
            want = sk.sigma_segsum_plain(*sargs, b0.edge_dst, b0.edge_mask,
                                         N)
            torch.cuda.synchronize()
            check_outputs(card, "sigma_segsum_fwd", case, ("e_out", "aggr"),
                          got, again, want, elem_tol)
            times["sigma_segsum_fwd"] = device_ms(
                sfn, kernels=launches_of("sigma_segsum_fwd", wdt))
            k2_bound = sigma_cost(
                list(sargs) + [b0.edge_mask, b0.dst_rowptr], got,
                int(b0.edge_mask.sum()))
            eargs, s4args = backward_inputs(b0, wdt, wd, gen, dev)
            margs, _ = merged_inputs(b0, wdt, wd, gen, dev)
            passes = {}
            if wdt == f32 and wd > d:
                passes["edge_phase_fwd"] = pass_device_ms(
                    k1_fn, launches_of("edge_phase_fwd", wdt),
                    passes=K1_PASSES)
            for kname, fn, plain, names, a in (
                    ("sigma_segsum_bwd", sk.sigma_segsum_bwd,
                     sk.sigma_segsum_bwd_plain, SIGMA_BWD_OUT, s4args),
                    ("edge_phase_bwd", ek.edge_phase_bwd, edge_bwd_plain,
                     EDGE_BWD_OUT, eargs),
                    ("edge_phase_merged_bwd", ek.merged_bwd,
                     merged_bwd_plain, EDGE_BWD_OUT, margs)):
                got, again, want = fn(*a), fn(*a), plain(*a)
                torch.cuda.synchronize()
                check_outputs(card, kname, case, names, got, again, want,
                              tol_of)
                times[kname] = device_ms(lambda f=fn, a=a: f(*a),
                                         kernels=launches_of(kname, wdt))
                if kname == "sigma_segsum_bwd":
                    passes[kname] = pass_device_ms(lambda f=fn, a=a: f(*a),
                                                   launches_of(kname, wdt),
                                                   passes=K4_PASSES)
                elif wd > d:
                    passes[kname] = pass_device_ms(lambda f=fn, a=a: f(*a),
                                                   launches_of(kname, wdt))
            # the CPU tests' mirror of the tile pass's shared-memory plan
            wp = ek.padded_width(wd)
            smem = ek._lib_bwd().edge_phase_bwd_smem(wp, int(wdt == bf))
            plan = ek.bwd_smem_plan(wp, wdt == bf)
            emit(phase="widths_time", card=card, case=case, d=wd,
                 padded_to=wp, device_ms=times, passes_device_ms=passes,
                 sigma_segsum_fwd_bound_ms=k2_bound[0], tile_smem=smem,
                 smem_plan=plan)
            if smem != plan["tile"]:
                fail(f"{case}: the tile pass takes {smem} bytes of shared "
                     f"memory, bwd_smem_plan says {plan['tile']}")
            del eargs, s4args, margs
            wcfg = Config(model=ModelConfig(dim_in=wd, dim_rbf=64,
                                            num_layers=4, cholesky=True,
                                            use_temperature=True,
                                            use_atom_types=True,
                                            compute_dtype=wdt),
                          optim=OptimConfig(max_epoch=1,
                                            batch_accumulation=TRAIN_ACCUM))
            wmodel = model_mod.CartNet(wcfg.model, device=dev, seed=0)
            ftol = PRED_TOL if wdt == bf else F32_STEP_TOL
            want_f = dict.fromkeys(KERNELS, 0)
            want_f.update(edge_phase_fwd=4, sigma_segsum_fwd=4)
            forward_vs_plain(card, wmodel, b0, plain_cartnet_forward, want_f,
                             ftol, net="cartnet", case=case, d=wd)
            for merged in (False, True):
                with merged_path(merged):
                    launch_counts(reset=True)
                    train_vs_plain(card, wcfg, wmodel, dev_batches[0], ftol)
                    wl = launch_counts()
                want_l = dict.fromkeys(KERNELS, 0)
                want_l.update(MERGED_MICRO if merged
                              else dict.fromkeys(CARTNET_KERNELS, 4))
                emit(phase="widths_train", card=card, model="cartnet",
                     case=case, d=wd, merged=merged, launches=wl,
                     expected_launches=want_l)
                if wl != want_l:
                    fail(f"widths {case} merged={merged}: launches {wl}, "
                         f"expected {want_l}")
            del wmodel
    for wd in ECO_WIDTHS:
        for wdt, wname in ((bf, "bf16"), (f32, "f32")):
            case = f"d{wd}_{wname}"
            # K7 as the forward feeds it (bf16 h/W with f32 a; f32), K8 on
            # operands of one dtype with cotangents zero on pad rows
            targs = tp_args(b0, wdt, f32, wd, gen, dev)
            tol = CHECK_TOL["sum" if wdt == f32 else "bf16"]
            times, passes = {}, {}
            for l2, names, a in zip((False, True), (("c0", "c1", "c2"),
                                                    ("out",)),
                                    tp_calls(targs)):
                fn = k7.tp_contract_l2 if l2 else k7.tp_contract_l1
                got, again, want = ([o] if l2 else list(o) for o in (
                    fn(*a), fn(*a), tp_plain(l2)(*a)))
                torch.cuda.synchronize()
                check_outputs(card, "tp_contract_fwd",
                              f"{'l2' if l2 else 'l1'}_{case}", names, got,
                              again, want, lambda _: tol)
                k7_name = f"tp_contract_fwd_{'l2' if l2 else 'l1'}"
                times[k7_name] = device_ms(
                    lambda f=fn, a=a: f(*a),
                    kernels=launches_of("tp_contract_fwd", wdt))
                if wdt == f32 and wd > d:
                    passes[k7_name] = pass_device_ms(
                        lambda f=fn, a=a: f(*a),
                        launches_of("tp_contract_fwd", wdt),
                        passes=K7_PASSES)
            targs = tp_args(b0, wdt, wdt, wd, gen, dev)
            for l2 in (False, True):
                a = tp_bwd_args(targs, l2, b0.edge_mask, gen)
                got, again = (tp_bwd_flat(k7.tp_contract_bwd(*a))
                              for _ in range(2))
                want = tp_bwd_flat(k7.tp_contract_bwd_plain(*a))
                torch.cuda.synchronize()
                tol_of = (lambda o: CHECK_TOL["bf16"]) if wdt == bf else (
                    lambda o: CHECK_TOL["f32" if o.startswith("da")
                                        else "sum"])
                check_outputs(card, "tp_contract_bwd",
                              f"{'l2' if l2 else 'l1'}_{case}",
                              TP_BWD_OUT[l2], got, again, want, tol_of)
                k8_launches = launches_of("tp_contract_bwd", wdt)
                times[f"tp_contract_bwd_{'l2' if l2 else 'l1'}"] = device_ms(
                    lambda a=a: k7.tp_contract_bwd(*a), kernels=k8_launches)
                if wd > d:
                    passes["l2" if l2 else "l1"] = pass_device_ms(
                        lambda a=a: k7.tp_contract_bwd(*a), k8_launches,
                        passes=TP_BWD_PASSES)
            emit(phase="widths_time", card=card, net="ecomformer",
                 case=case, d=wd, device_ms=times, passes_device_ms=passes)
            del targs
            ecfg_w = Config(model=ModelConfig(name="ecomformer", dim_in=wd,
                                              cholesky=True,
                                              compute_dtype=wdt),
                            optim=OptimConfig(max_epoch=1,
                                              batch_accumulation=TRAIN_ACCUM))
            ewmodel = create_model(ecfg_w.model, dev, 0)
            ftol = PRED_TOL if wdt == bf else F32_STEP_TOL
            want_f = dict.fromkeys(KERNELS, 0)
            want_f.update(ECO_FWD)
            forward_vs_plain(card, ewmodel, b0, plain_ecomformer_kernels,
                             want_f, ftol, net="ecomformer", case=case,
                             d=wd)
            launch_counts(reset=True)
            train_vs_plain(card, ecfg_w, ewmodel, dev_batches[0], ftol,
                           plain_ecomformer_kernels)
            wl = launch_counts()
            want_l = dict.fromkeys(KERNELS, 0)
            want_l.update(ECO_MICRO)
            emit(phase="widths_train", card=card, model="ecomformer",
                 case=case, d=wd, launches=wl, expected_launches=want_l)
            if wl != want_l:
                fail(f"eComformer widths {case}: launches {wl}, expected "
                     f"{want_l}")
            del ewmodel

    # 6c. the CLI's default head: --dataset synthetic without --cholesky
    # trains the scalar head on scalar targets (the JAX CLI's rule), through
    # the kernels
    launch_counts(reset=True)
    t0 = time.perf_counter()
    sstate, stest = cli.main(["--dataset", "synthetic", "--limit", "8",
                              "--epochs", "1", "--batch_accumulation", "2",
                              "--bf16"])
    torch.cuda.synchronize()
    scli_s = time.perf_counter() - t0
    launches_scli = launch_counts()
    head = type(sstate.model.head).__name__
    emit(phase="cli_scalar", card=card, head=head,
         cholesky=sstate.model.cfg.cholesky, launches=launches_scli,
         expected_launches=expect_cli, optimizer_steps=sstate.step,
         bad_steps=int(sstate.bad_steps), test=stest,
         seconds=round(scli_s, 3))
    if (launches_scli != expect_cli or head != "ScalarHead"
            or sstate.step != 1 or int(sstate.bad_steps)
            or not all(math.isfinite(v) for v in stest.values())):
        fail(f"scalar-head CLI run: head {head}, launches {launches_scli}, "
             f"{sstate.step} optimizer steps, test stats {stest}")

    def serve(net, cli_name, mcfg, fwd, k1_kernels=None):
        """A Comformer's serving phases (``net``, ``net``_vs_plain,
        ``net``_cli): the sweep over both batches with ``fwd`` launches a
        forward, finite predictions, K1's CUDA kernels by name a forward
        (``k1_kernels``, optional), each batch through the kernels against
        the plain versions (``PRED_TOL``) with both timed, and the CLI
        sweep -> (model, launches of the sweep, kernel ms, plain ms)."""
        model = create_model(mcfg, dev, 0)
        if k1_kernels:  # the iComformer: BN stats describing its inputs
            calibrate_bn(model, b0)
        launch_counts(reset=True)
        t0 = time.perf_counter()
        out = runner.inference(
            model, batches, str(_build.BUILD_DIR / f"chip_smoke_{net}.pkl"),
            device=dev)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = launch_counts()
        expect = dict.fromkeys(KERNELS, 0)
        expect.update({k: v * len(batches) for k, v in fwd.items()})
        preds = [torch.as_tensor(p) for p in out["pred"]]
        finite = all(bool(torch.isfinite(p).all()) for p in preds)
        extra = {}
        if k1_kernels:
            # cuda_events fails the run unless each name occurs as stated
            def one_forward():
                with torch.inference_mode():
                    model(b0)

            names = dict.fromkeys(k1_kernels, 0.0)
            for ev in cuda_events(one_forward, 2, k1_kernels):
                for sub in k1_kernels:
                    names[sub] += (sub in ev.name) / 2
            extra["k1_cuda_kernels_per_forward"] = names
        emit(phase=net, card=card, batches=len(batches),
             structures=len(preds), atoms=sum(p.shape[0] for p in preds),
             params=sum(p.numel() for p in model.parameters()),
             launches=launches, expected_launches=expect, **extra,
             sweep_seconds=round(sweep_s, 3), finite=finite,
             mean_mae=float(statistics.fmean(out["mae"])))
        if launches != expect:
            fail(f"{net} launch counts {launches}, expected {expect}")
        if not finite or len(preds) != len(recs):
            fail(f"non-finite or missing {net} predictions")

        worst, ms, ms_plain = 0.0, [], []
        with torch.inference_mode():
            for b in dev_batches:
                pk, mask = model(b)
                with plain_ecomformer_kernels():
                    pp, _ = model(b)
                    ms_plain.append(cuda_median_ms(lambda: model(b), 20))
                ms.append(cuda_median_ms(lambda: model(b), 20))
                m = mask.bool()
                abs_err, rel = normalized_err(pk[m], pp[m])
                worst = max(worst, rel)
                emit(phase=f"{net}_vs_plain", card=card, max_abs_err=abs_err,
                     max_rel_err=rel, tol=PRED_TOL)
        if worst > PRED_TOL:
            fail(f"{net} kernel forward vs plain forward: rel err {worst}")

        # the user's entry point: the CLI sweep over the synthetic test
        # split (2 crystals, 1 batch)
        launch_counts(reset=True)
        t0 = time.perf_counter()
        cout = cli.main(["--dataset", "synthetic", "--cholesky", "--limit",
                         "8", "--inference", "--model", cli_name, "--bf16",
                         "--inference_output",
                         str(_build.BUILD_DIR / f"chip_smoke_cli_{net}.pkl")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches_cli = launch_counts()
        expect_cli = dict.fromkeys(KERNELS, 0)
        expect_cli.update(fwd)
        cfinite = all(bool(torch.isfinite(torch.as_tensor(p)).all())
                      for p in cout["pred"])
        emit(phase=f"{net}_cli", card=card, launches=launches_cli,
             expected_launches=expect_cli, structures=len(cout["pred"]),
             finite=cfinite, mean_mae=float(statistics.fmean(cout["mae"])),
             seconds=round(cli_s, 3))
        if launches_cli != expect_cli or not cfinite or not cout["pred"]:
            fail(f"{net} CLI sweep: launches {launches_cli}, finite "
                 f"{cfinite}")
        return model, launches, ms, ms_plain

    def train(net, cli_name, mcfg, fwd, micro_launches, n_bn):
        """A Comformer's training phases (``net``_train,
        ``net``_cli_train, train_vs_plain): 16 micro-steps = 1 optimizer
        update with ``micro_launches`` a micro-step, finite losses, no
        skipped step, all ``n_bn`` BNs advanced; a short CLI run (2
        micro-steps, a val and a test forward); one micro-step through the
        kernels and the plain versions in bf16 (the trained model) and f32
        (from seed 0) -> (state, micro_step, launches of the 16
        micro-steps, f32 config)."""
        tcfg = Config(model=mcfg, optim=OptimConfig(
            max_epoch=1, batch_accumulation=TRAIN_ACCUM))
        model = create_model(tcfg.model, dev, 0)
        opt = loop.build_optimizer(tcfg, model.parameters(), COMFORMER_STEPS)
        state = loop.init_train_state(model, opt)
        micro, update, _ = loop.make_steps(tcfg)
        epoch = dev_batches * (COMFORMER_STEPS // len(dev_batches))
        bn0 = [t.clone() for t in loop.bn_buffers(model)]
        launch_counts(reset=True)
        t0 = time.perf_counter()
        state, rows = loop.train_epoch(state, epoch, micro, update,
                                       TRAIN_ACCUM, dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = launch_counts()
        losses = [float(r[0]["loss"]) for r in rows]
        moved = all(not torch.equal(a, b)
                    for a, b in zip(bn0, loop.bn_buffers(model)))
        bns = sum(isinstance(mod, torch.nn.BatchNorm1d)
                  for mod in model.modules())
        expect = dict.fromkeys(KERNELS, 0)
        expect.update({k: v * len(epoch) for k, v in micro_launches.items()})
        emit(phase=f"{net}_train", card=card, micro_steps=len(epoch),
             batch_accumulation=TRAIN_ACCUM, optimizer_steps=state.step,
             launches=launches, expected_launches=expect,
             launches_per_micro_step={k: v / len(epoch)
                                      for k, v in launches.items()},
             loss_first=losses[0], loss_last=losses[-1],
             finite=all(math.isfinite(x) for x in losses),
             bad_steps=int(state.bad_steps), bn_layers=bns,
             bn_stats_updated=moved, seconds=round(train_s, 3))
        if launches != expect:
            fail(f"{net} train launch counts {launches}, expected {expect}")
        if not all(math.isfinite(x) for x in losses) or int(state.bad_steps):
            fail(f"non-finite {net} train losses or skipped steps")
        if state.step != len(epoch) // TRAIN_ACCUM or not moved \
                or bns != n_bn:
            fail(f"{net}: {state.step} optimizer steps, {bns} BNs, BN stats "
                 f"moved: {moved}")

        # the user's entry point: a short training run through the CLI
        launch_counts(reset=True)
        t0 = time.perf_counter()
        cstate, ctest = cli.main(["--dataset", "synthetic", "--cholesky",
                                  "--limit", "8", "--epochs", "1",
                                  "--batch_accumulation", "2", "--model",
                                  cli_name, "--bf16"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches_cli = launch_counts()
        expect_cli = {k: 2 * micro_launches.get(k, 0) + 2 * fwd.get(k, 0)
                      for k in KERNELS}
        emit(phase=f"{net}_cli_train", card=card, launches=launches_cli,
             expected_launches=expect_cli, optimizer_steps=cstate.step,
             bad_steps=int(cstate.bad_steps), test=ctest,
             seconds=round(cli_s, 3))
        if launches_cli != expect_cli or cstate.step != 1 or \
                not all(math.isfinite(v) for v in ctest.values()):
            fail(f"{net} CLI training run: launches {launches_cli}, "
                 f"{cstate.step} optimizer steps, test stats {ctest}")

        train_vs_plain(card, tcfg, model, dev_batches[0], PRED_TOL,
                       plain_ecomformer_kernels)
        cfg32 = with_dtype(tcfg, f32)
        train_vs_plain(card, cfg32, create_model(cfg32.model, dev, 0),
                       dev_batches[0], F32_STEP_TOL, plain_ecomformer_kernels)
        return state, micro, launches, cfg32

    # 7-8. the eComformer: serving through K1, K2, K3, K7; bench.py's
    # eComformer training
    ecfg = ModelConfig(name="ecomformer", dim_in=d, cholesky=True,
                       compute_dtype=bf)
    emodel, launches_eco, efwd_ms, efwd_plain_ms = serve(
        "ecomformer", "eComformer", ecfg, ECO_FWD)
    estate, emicro, launches_etrain, ecfg32 = train(
        "ecomformer", "eComformer", ecfg, ECO_FWD, ECO_MICRO, 7)

    # 8b-8c. the iComformer: serving through K1, K2 (conv1-conv3 on K1's
    # f32 route); training through K1-K5
    icfg = dataclasses.replace(ecfg, name="icomformer")
    imodel, launches_ico, ifwd_ms, ifwd_plain_ms = serve(
        "icomformer", "iComformer", icfg, ICO_FWD, ICO_K1_BF16_FWD)
    istate, imicro, launches_itrain, icfg32 = train(
        "icomformer", "iComformer", icfg, ICO_FWD, ICO_MICRO, 10)

    def iforward():
        with torch.inference_mode():
            imodel(b0)

    # 8d. the adpfix product path through the CLI
    adpfix_phase(card, dev)

    # 8e. the Jarvis/MP scalar-property path: data and kernels (its CLI
    # runs follow the time phase)
    jdata, jstep, jlayout = jarvis_layouts(card, dev)

    # 9. times at the main paths' shapes
    rows_t = {k: {} for k in KERNELS}

    def time_row(kname, case, fk, fp, t_bound, by, calls, dt, passes=None,
                 **others):
        """Kernel and plain times (plain before and after), and those of
        ``others`` (name_ms -> fn), at warm L2: CUDA events around one
        call, and the device time alone (``device_ms``; the kernel's
        captures hold each of its launches in ``dt``, ``launches_of``);
        with ``passes``, the device time of each of them too
        (``pass_device_ms``)."""
        plain1 = cuda_median_ms(fp)
        kern = cuda_median_ms(fk)
        plain2 = cuda_median_ms(fp)
        launches = launches_of(kname, dt)
        row = dict(ms=kern, plain_ms=statistics.fmean([plain1, plain2]),
                   bound_ms=t_bound, bound_by=by, calls=calls,
                   device_ms=device_ms(fk, kernels=launches),
                   plain_device_ms=device_ms(fp))
        if passes:
            row["passes_device_ms"] = pass_device_ms(fk, launches,
                                                     passes=passes)
        for k, fn in others.items():
            row[k] = cuda_median_ms(fn)
            row[k.replace("_ms", "_device_ms")] = device_ms(fn)
        rows_t[kname][case] = row
        emit(phase="time", card=card, kernel=kname, case=case, runs=RUNS,
             **row, share_of_bound=t_bound / kern if kern else None,
             device_share_of_bound=t_bound / row["device_ms"]
             if row["device_ms"] else None)

    def k1_products(args):
        """cuBLAS's three products of K1 alone on operands of its shapes
        and edge dtype: e @ We, h_g @ W1g, h_a @ W1a (a yardstick; no
        single call computes K1)."""
        e, we, w1g, w1a = args[2], args[3], args[5], args[7]
        hg, ha = (torch.randn(E, d, generator=gen).to(e.dtype).to(dev)
                  for _ in range(2))
        return lambda: (torch.matmul(e, we), torch.matmul(hg, w1g),
                        torch.matmul(ha, w1a))

    def k5_products(args):
        """cuBLAS's six products of K5/K6 alone on operands of their shapes
        and dtype: dh = [dg @ W1g^T | ds @ W1a^T], de = dpre @ We^T, dWe =
        e^T dpre, dW1g = h_g^T dg, dW1a = h_a^T ds (a yardstick; no single
        call computes K5 or K6)."""
        e, we, w1g, w1a = args[:4]
        rn = lambda *sh: torch.randn(*sh, generator=gen).to(e.dtype).to(dev)
        dg, ds, dpre, h = rn(E, d), rn(E, d), rn(E, 2 * d), rn(E, 2 * d)
        return lambda: (torch.matmul(dg, w1g.t()), torch.matmul(ds, w1a.t()),
                        torch.matmul(dpre, we.t()), torch.matmul(e.t(), dpre),
                        torch.matmul(h[:, :d].t(), dg),
                        torch.matmul(h[:, d:].t(), ds))

    for case, (tdt, edt, calls) in cases.items():
        args = timing_inputs[("edge", case)]
        ops_dt = "f32" if edt == f32 else "bf16"
        t_bound, by = edge_cost(list(args) + list(idx),
                                ek.edge_phase_fwd(*args, *idx)[:2], d, E,
                                ops_dt)
        time_row("edge_phase_fwd", case,
                 lambda a=args: ek.edge_phase_fwd(*a, *idx),
                 lambda a=args: ek.edge_phase_fwd_plain(*a, *idx),
                 t_bound, by, calls, edt,
                 K1_PASSES if edt == f32 else None,
                 products_ms=k1_products(args))
        args = timing_inputs[("sigma", case)]
        extra = (b0.edge_mask, b0.dst_rowptr)
        fk = lambda a=args: sk.sigma_segsum(*a, b0.edge_dst, b0.edge_mask,
                                            b0.dst_rowptr, N)
        t_bound, by = sigma_cost(list(args) + list(extra), fk(),
                                 int(b0.edge_mask.sum()))
        time_row("sigma_segsum_fwd", case, fk,
                 lambda a=args: sk.sigma_segsum_plain(*a, b0.edge_dst,
                                                      b0.edge_mask, N),
                 t_bound, by, calls, tdt)
    # the training cases of K1 (saved residual and moments on), bf16 and
    # f32, and of K2
    kw = dict(saved=True, moments=True)
    for case, src in (("train_bf16", "layer0_bf16"),
                      ("train_f32", "f32_config")):
        args = timing_inputs[("edge", src)]
        edt = args[2].dtype
        t_bound, by = edge_cost(list(args) + list(idx),
                                ek.edge_phase_fwd(*args, *idx, **kw), d, E,
                                "bf16" if edt == bf else "f32")
        time_row("edge_phase_fwd", case,
                 lambda a=args: ek.edge_phase_fwd(*a, *idx, **kw),
                 lambda a=args: ek.edge_phase_fwd_plain(*a, *idx, **kw),
                 t_bound, by, 4 if edt == bf else 0, edt,
                 K1_PASSES if edt == f32 else None,
                 products_ms=k1_products(args))
    rows_t["sigma_segsum_fwd"]["train_bf16"] = dict(
        rows_t["sigma_segsum_fwd"]["layer0_bf16"], calls=4)
    for case, (dt, calls) in train_cases.items():
        eargs = timing_inputs[("edge_bwd", case)]
        t_bound, by = edge_bwd_cost(eargs, ek.edge_phase_bwd(*eargs), d, E,
                                    "bf16" if dt == bf else "f32")
        time_row("edge_phase_bwd", case,
                 lambda a=eargs: ek.edge_phase_bwd(*a),
                 lambda a=eargs: edge_bwd_plain(*a), t_bound, by, calls, dt,
                 BWD_PASSES, products_ms=k5_products(eargs))
        sargs = timing_inputs[("sigma_bwd", case)]
        t_bound, by = sigma_bwd_cost(sargs, sk.sigma_segsum_bwd(*sargs), E, d)
        time_row("sigma_segsum_bwd", case,
                 lambda a=sargs: sk.sigma_segsum_bwd(*a),
                 lambda a=sargs: sk.sigma_segsum_bwd_plain(*a), t_bound, by,
                 calls, dt, K4_PASSES)
        # K6: K5's products (8 E d^2 multiply-adds) over its own operands
        margs = timing_inputs[("merged_bwd", case)]
        t_bound, by = edge_bwd_cost(margs, ek.merged_bwd(*margs), d, E,
                                    "bf16" if dt == bf else "f32")
        time_row("edge_phase_merged_bwd", case,
                 lambda a=margs: ek.merged_bwd(*a),
                 lambda a=margs: merged_bwd_plain(*a), t_bound, by, calls, dt,
                 BWD_PASSES, products_ms=k5_products(margs))
        emit(phase="time_passes", card=card, case=case, passes_device_ms={
            k: rows_t[k][case]["passes_device_ms"]
            for k in ("edge_phase_bwd", "edge_phase_merged_bwd",
                      "sigma_segsum_bwd")})
    # one CartNet layer's whole backward (autograd through the layer's
    # Functions, bf16, random cotangents zero on pad rows): default (K4, the
    # window-moment merge's backward, K5) beside merged (phase A', the
    # merge's VJP, K6), in turns default, merged, merged, default
    layer_ms = {False: [], True: []}
    layer_dev = {False: [], True: []}
    lgen = torch.Generator().manual_seed(1)
    deout_l = (torch.randn(E, d, generator=lgen).to(dev)
               * b0.edge_mask[:, None]).to(bf)
    daggr_l = torch.randn(N, d, generator=lgen).to(dev).to(bf)
    env_l = torch.rand(E, 1, generator=lgen).to(dev).to(bf)
    norm_p = [(1.0 + 0.1 * torch.randn(d, generator=lgen)).to(dev).to(bf),
              (0.1 * torch.randn(d, generator=lgen)).to(dev).to(bf)]
    idx6 = (*idx, b0.dst_rowptr, b0.edge_src_perm, b0.src_rowptr)
    n_w = b0.edge_mask.reshape(-1, ek.TILE_EDGES).sum(
        dim=1, dtype=torch.float32)[:, None]

    def layer_backward(merged):
        ins = [t.detach().clone().requires_grad_()
               for t in timing_inputs[("merged_fwd", "train_bf16")]]
        ins += [t.clone().requires_grad_() for t in norm_p]
        if merged:
            outs = ek.FusedEdgeSigma.apply(*ins, env_l, *idx6, 1e-5)[:2]
        else:
            gate, sender, e_res, s1w, m2w = ek.EdgePhase.apply(*ins[:9],
                                                               *idx6)
            (scale, shift), _ = combine_window_moments(*ins[9:], s1w, m2w,
                                                       n_w)
            outs = sk.SigmaSegsum.apply(gate, scale, shift, env_l, sender,
                                        e_res, b0.edge_dst, b0.edge_mask,
                                        b0.dst_rowptr, N)
        return lambda: torch.autograd.grad(outs, ins, (deout_l, daggr_l),
                                           retain_graph=True)

    for merged in (False, True, True, False):
        fn = layer_backward(merged)
        layer_ms[merged].append(cuda_median_ms(fn))
        layer_dev[merged].append(device_ms(fn))
    emit(phase="layer_backward", card=card, runs=RUNS,
         default_ms=layer_ms[False], merged_ms=layer_ms[True],
         default_device_ms=layer_dev[False], merged_device_ms=layer_dev[True])
    # K3 beside one index_add_ of the same values into an [N + 1, D] table
    # of their dtype (pads to row N; preallocated, zeroing not timed)
    real0 = int(b0.edge_mask.sum())
    ids_lib = torch.where(b0.edge_mask, b0.edge_src,
                          torch.full_like(b0.edge_src, N))
    for case, (dt, width, calls) in seg_cases.items():
        sargs = timing_inputs[("seg", case)]
        t_bound, by = seg_cost(sargs, k3.segment_sum_csr(*sargs), real0)
        table = torch.zeros((N + 1, width), dtype=dt, device=dev)
        time_row("segment_sum_csr", case,
                 lambda a=sargs: k3.segment_sum_csr(*a),
                 lambda a=sargs: k3.segment_sum_csr_plain(*a), t_bound, by,
                 calls, dt, library_ms=lambda a=sargs, t=table: t.index_add_(
                     0, ids_lib, a[0]))
    # K7 beside the [E, d] x [d, 5120] GEMM alone (a note: no single call
    # computes K7)
    for case, (hdt, adt, calls) in tp_cases.items():
        targs = timing_inputs[("tp", case)]
        wt_t = targs["wt"].t()
        for l2, a in zip((False, True), tp_calls(targs)):
            fn = k7.tp_contract_l2 if l2 else k7.tp_contract_l1
            outs = fn(*a)
            t_bound, by = tp_cost(a, [outs] if l2 else outs)
            time_row("tp_contract_fwd", f"{'l2' if l2 else 'l1'}_{case}",
                     lambda a=a, fn=fn: fn(*a), lambda a=a, l2=l2:
                     tp_plain(l2)(*a), t_bound, by, calls, hdt,
                     K7_PASSES if hdt == f32 else None,
                     gemm_ms=lambda h=targs["h"]: torch.matmul(h, wt_t))
    # K3 as the gather backward beside one index_add_ of the same
    # cotangents onto edge_dst (the JAX package's function: every edge,
    # pads adding zeros)
    for case, (dt, width, calls) in gather_cases.items():
        gargs = timing_inputs[("seg", case)]
        t_bound, by = seg_cost(gargs, k3.segment_sum_csr(*gargs), real0)
        table = torch.zeros((N, width), dtype=dt, device=dev)
        time_row("segment_sum_csr", case,
                 lambda a=gargs: k3.segment_sum_csr(*a),
                 lambda a=gargs: k3.segment_sum_csr_plain(*a), t_bound, by,
                 calls, dt, library_ms=lambda a=gargs, t=table: t.index_add_(
                     0, b0.edge_dst, a[0]))
    # K8 beside cuBLAS's three products alone on operands of the same
    # shapes and dtype: dwall @ wt, dwall^T h and the recompute h @ W
    for case, (dt, calls) in tp_bwd_cases.items():
        for l2 in (False, True):
            a = timing_inputs[("tp_bwd", l2, case)]
            h, wt = a[1], a[3]
            dwall = torch.randn(E, 5120, generator=gen).to(dt).to(dev)
            t_bound, by = tp_bwd_cost(a, k7.tp_contract_bwd(*a))

            def cublas(h=h, wt=wt, dwall=dwall):
                torch.matmul(dwall, wt)
                torch.matmul(dwall.t(), h)
                torch.matmul(h, wt.t())

            kcase = f"{'l2' if l2 else 'l1'}_{case}"
            time_row("tp_contract_bwd", kcase,
                     lambda a=a: k7.tp_contract_bwd(*a),
                     lambda a=a: k7.tp_contract_bwd_plain(*a), t_bound, by,
                     calls, dt, TP_BWD_PASSES, products_ms=cublas)
            emit(phase="time_passes", card=card, kernel="tp_contract_bwd",
                 case=kcase, passes_device_ms=rows_t["tp_contract_bwd"][
                     kcase]["passes_device_ms"])
            del dwall
    emit(phase="forward", card=card, batch_ms_kernels=fwd_ms,
         batch_ms_plain=fwd_plain_ms, runs=20)
    emit(phase="forward", card=card, model="ecomformer",
         batch_ms_kernels=efwd_ms, batch_ms_plain=efwd_plain_ms, runs=20)
    emit(phase="forward", card=card, model="icomformer",
         batch_ms_kernels=ifwd_ms, batch_ms_plain=ifwd_plain_ms, runs=20)

    def forward():
        with torch.inference_mode():
            model(b0)

    def eforward():
        with torch.inference_mode():
            emodel(b0)

    emit(phase="profile", card=card, what="forward", **profile_call(forward))
    emit(phase="profile", card=card, what="ecomformer_forward",
         **profile_call(eforward))
    emit(phase="profile", card=card, what="icomformer_forward",
         **profile_call(iforward))
    # the f32 forwards (the CLI's default dtype: K1 and K7 on their f32
    # passes) per batch, through the kernels and through the plain
    # versions, held to each other and timed and profiled as the bf16 ones
    for net, mcfg, plain, want in (
            ("cartnet", dataclasses.replace(cfg, compute_dtype=f32),
             plain_cartnet_forward,
             dict(edge_phase_fwd=4, sigma_segsum_fwd=4)),
            ("ecomformer", dataclasses.replace(ecfg, compute_dtype=f32),
             plain_ecomformer_kernels, ECO_FWD),
            ("icomformer", dataclasses.replace(icfg, compute_dtype=f32),
             plain_ecomformer_kernels, ICO_FWD)):
        m32 = create_model(mcfg, dev, 0).eval()
        if net == "icomformer":
            calibrate_bn(m32, dev_batches[0])
        expect = dict.fromkeys(KERNELS, 0)
        expect.update(want)
        ms, ms_plain, errs = [], [], []
        with torch.inference_mode():
            for b in dev_batches:
                launch_counts(reset=True)
                pk, mask = m32(b)
                torch.cuda.synchronize()
                got = launch_counts()
                with plain():
                    pp, _ = m32(b)
                    ms_plain.append(cuda_median_ms(lambda: m32(b), 20))
                ms.append(cuda_median_ms(lambda: m32(b), 20))
                m = mask.bool()
                errs.append(normalized_err(pk[m], pp[m])[1])
                if (got != expect or not bool(torch.isfinite(pk[m]).all())
                        or not errs[-1] <= F32_STEP_TOL):
                    fail(f"{net} f32 forward: launches {got} (expected "
                         f"{expect}), rel err {errs[-1]}")
        emit(phase="forward", card=card, model=net, compute_dtype="f32",
             batch_ms_kernels=ms, batch_ms_plain=ms_plain, runs=20,
             max_rel_err=errs, tol=F32_STEP_TOL, launches=got)

        def fwd32(m=m32):
            with torch.inference_mode():
                m(dev_batches[0])

        emit(phase="profile", card=card, what=f"{net}_forward_f32",
             **profile_call(fwd32))
        del m32
    step = lambda: micro(state, dev_batches[0])
    step_ms = cuda_median_ms(step, 20)
    with plain_kernels():
        step_plain_ms = cuda_median_ms(step, 20)
    real_edges = statistics.fmean(int(b.edge_mask.sum()) for b in batches)
    emit(phase="train_step", card=card, micro_step_ms=step_ms,
         micro_step_ms_plain=step_plain_ms, runs=20,
         mean_real_edges=real_edges,
         edges_per_s=real_edges / (step_ms / 1e3),
         edges_per_s_plain=real_edges / (step_plain_ms / 1e3))
    emit(phase="profile", card=card, what="train_micro_step",
         **profile_call(step))
    # the CartNet micro-step through the merged path beside the default
    # one, from the same state, in turns default, merged, merged, default
    paired = {False: [], True: []}
    for merged in (False, True, True, False):
        with merged_path(merged):
            paired[merged].append(cuda_median_ms(step, 20))
    emit(phase="train_step_merged", card=card, runs=20,
         micro_step_ms_default=paired[False],
         micro_step_ms_merged=paired[True], mean_real_edges=real_edges,
         edges_per_s_default=real_edges / (statistics.fmean(paired[False])
                                           / 1e3),
         edges_per_s_merged=real_edges / (statistics.fmean(paired[True])
                                          / 1e3))
    with merged_path():
        emit(phase="profile", card=card, what="merged_train_micro_step",
             **profile_call(step))
    estep = lambda: emicro(estate, dev_batches[0])
    estep_ms = cuda_median_ms(estep, 20)
    with plain_ecomformer_kernels():
        estep_plain_ms = cuda_median_ms(estep, 20)
    emit(phase="train_step", card=card, model="ecomformer",
         micro_step_ms=estep_ms, micro_step_ms_plain=estep_plain_ms, runs=20,
         mean_real_edges=real_edges,
         edges_per_s=real_edges / (estep_ms / 1e3),
         edges_per_s_plain=real_edges / (estep_plain_ms / 1e3))
    emit(phase="profile", card=card, what="ecomformer_train_micro_step",
         **profile_call(estep))
    istep = lambda: imicro(istate, dev_batches[0])
    istep_ms = cuda_median_ms(istep, 20)
    with plain_ecomformer_kernels():
        istep_plain_ms = cuda_median_ms(istep, 20)
    emit(phase="train_step", card=card, model="icomformer",
         micro_step_ms=istep_ms, micro_step_ms_plain=istep_plain_ms, runs=20,
         mean_real_edges=real_edges,
         edges_per_s=real_edges / (istep_ms / 1e3),
         edges_per_s_plain=real_edges / (istep_plain_ms / 1e3))
    emit(phase="profile", card=card, what="icomformer_train_micro_step",
         **profile_call(istep))
    # the f32 micro-steps (the CLI's default dtype: K5 and K8 on their f32
    # passes), CartNet default and eComformer, from a fresh state at seed 0,
    # beside the bf16 ones above
    for net, f32cfg, plain in (("cartnet", cfg32, plain_kernels),
                               ("ecomformer", ecfg32,
                                plain_ecomformer_kernels),
                               ("icomformer", icfg32,
                                plain_ecomformer_kernels)):
        m32 = create_model(f32cfg.model, dev, 0)
        st32 = loop.init_train_state(m32, loop.build_optimizer(
            f32cfg, m32.parameters(), 1))
        micro32 = loop.make_steps(f32cfg)[0]
        step32 = lambda: micro32(st32, dev_batches[0])
        ms32 = cuda_median_ms(step32, 20)
        with plain():
            ms32_plain = cuda_median_ms(step32, 20)
        emit(phase="train_step", card=card, model=net, compute_dtype="f32",
             micro_step_ms=ms32, micro_step_ms_plain=ms32_plain, runs=20,
             mean_real_edges=real_edges,
             edges_per_s=real_edges / (ms32 / 1e3),
             edges_per_s_plain=real_edges / (ms32_plain / 1e3))
        emit(phase="profile", card=card,
             what=f"{'' if net == 'cartnet' else net + '_'}"
                  f"train_micro_step_f32", **profile_call(step32))
        del m32, st32

    # the Jarvis batch-64 f32 CartNet micro-step (640 / 30720, scalar head)
    jstep_ms = cuda_median_ms(jstep, 20)
    with plain_kernels():
        jstep_plain_ms = cuda_median_ms(jstep, 20)
    emit(phase="train_step", card=card, model="cartnet", path="jarvis",
         compute_dtype="f32", micro_step_ms=jstep_ms,
         micro_step_ms_plain=jstep_plain_ms, runs=20, **jlayout,
         edges_per_s=jlayout["real_edges"] / (jstep_ms / 1e3),
         edges_per_s_plain=jlayout["real_edges"] / (jstep_plain_ms / 1e3))
    emit(phase="profile", card=card, what="jarvis_train_micro_step_f32",
         **profile_call(jstep))
    # 8e. the Jarvis path through the CLI (its --profile run after the
    # time phase's captures)
    launches_jarvis = jarvis_cli(card, jdata)
    # 8f. the CSD ADP source through the CLI; 8g. data parallelism, two
    # ranks on the card
    launches_adp = adp_phase(card, dev)
    launches_dp = dp_phase(card, dev, recs)
    # 8g2. edge parallelism and halo partitioning, ranks on the card
    launches_ep = ep_phase(card, dev, recs, batches)
    # 8g3. chunked execution (--chunks)
    launches_chunks = chunks_phase(card, dev, recs)
    # 8h. fused epochs: K micro-steps a CUDA-graph replay
    launches_fused = fused_phase(card, dev, batches)

    # 10. summary: K1, K2, K4, K5 per launch on the CartNet training path
    # (all four run in every micro-step, in the bf16 training case), K6 on
    # the merged CartNet training path (its 16 micro-steps); K3 and
    # K7 per launch on the eComformer serving path, in its first call's
    # case (K3 on the f32 [E, 128] irreps, K7 l1 with bf16 h/W and f32 a);
    # K8 per launch on the eComformer training path (l1, bf16), with the
    # launches of its 16 micro-steps
    def f32_rows(kname, cases):
        """A kernel's times in its other cases (the f32 ones, K7's other
        bf16 ones), beside its line."""
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
                "plain_device_ms", "passes_device_ms", "products_ms",
                "products_device_ms", "gemm_ms", "gemm_device_ms")
        return {c: {k: rows_t[kname][c].get(k) for k in keys} for c in cases
                if c in rows_t[kname]}

    def fused_rows(kname):
        """A kernel's launches on the fused path: at the main chunk's
        warm-up and capture (bf16 CartNet, 2 x 16 micro-steps; the
        Comformers' chunks, 2 x 4), and in one replay by CUDA name."""
        rows = {"launches_fused_capture": launches_fused["capture"][kname],
                "launches_fused_comformers_capture": {
                    c: v[kname]
                    for c, v in launches_fused["comformers"].items()}}
        if kname in CARTNET_KERNELS or kname == "edge_phase_merged_bwd":
            rows["launches_fused_replay_by_name"] = {
                case: {sub: got[sub] for sub in launches_of(
                    kname, torch.float32 if case.endswith("32")
                    else torch.bfloat16) if sub in got}
                for case, got in launches_fused["replay"].items()
                # K5 and K6 share their passes' names
                if kname not in ("edge_phase_bwd", "edge_phase_merged_bwd")
                or case.startswith("merged") == (
                    kname == "edge_phase_merged_bwd")}
        return rows

    kernels = []
    for kname, src, replaces, run in (
            ("edge_phase_fwd", "cartnet_tpu_torch/csrc/edge_phase_fwd.cu",
             "cartnet_tpu/ops/pallas/edge_kernels.py:162", launches_train),
            ("sigma_segsum_fwd", "cartnet_tpu_torch/csrc/sigma_segsum_fwd.cu",
             "cartnet_tpu/ops/pallas/segment_kernels.py:191",
             launches_train),
            ("sigma_segsum_bwd", "cartnet_tpu_torch/csrc/sigma_segsum_bwd.cu",
             "cartnet_tpu/ops/pallas/segment_kernels.py:223",
             launches_train),
            ("edge_phase_bwd", "cartnet_tpu_torch/csrc/edge_phase_bwd.cu",
             "cartnet_tpu/ops/pallas/edge_kernels.py:269", launches_train),
            ("edge_phase_merged_bwd",
             "cartnet_tpu_torch/csrc/edge_phase_bwd.cu",
             "cartnet_tpu/ops/pallas/edge_kernels.py:961", launches_mtrain)):
        r = rows_t[kname]["train_bf16"]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": run[kname],
            "launches_merged_train": launches_mtrain[kname],
            "launches_inference": launches_inf[kname],
            "launches_icomformer_inference": launches_ico[kname],
            "launches_icomformer_train": launches_itrain[kname],
            "launches_jarvis_cli": launches_jarvis[kname],
            "launches_adp_cli": launches_adp[kname],
            "launches_dp_per_rank": {k: v[kname]
                                     for k, v in launches_dp.items()},
            "launches_ep_per_rank": {k: v[kname]
                                     for k, v in launches_ep.items()},
            "launches_chunks_per_micro_step": {
                k: v[kname] for k, v in launches_chunks.items()},
            **fused_rows(kname),
            "max_abs_err": check_err[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "passes_device_ms": r.get("passes_device_ms"),
            "products_ms": r.get("products_ms"),
            "products_device_ms": r.get("products_device_ms"),
            "f32": f32_rows(kname, ("f32_config", "train_f32"))})
    for kname, src, replaces, case in (
            ("segment_sum_csr", "cartnet_tpu_torch/csrc/segment_sum_csr.cu",
             "cartnet_tpu/ops/pallas/segment_kernels.py:38", "f32_128"),
            ("tp_contract_fwd", "cartnet_tpu_torch/csrc/tp_contract_fwd.cu",
             "cartnet_tpu/ops/pallas/tp_kernels.py:88", "l1_bf16_f32a"),
            ("tp_contract_bwd", "cartnet_tpu_torch/csrc/tp_contract_bwd.cu",
             "cartnet_tpu/ops/pallas/tp_kernels.py:113", "l1_bf16")):
        r = rows_t[kname][case]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": (launches_etrain if kname == "tp_contract_bwd"
                         else launches_eco)[kname],
            "launches_ecomformer_train": launches_etrain[kname],
            "launches_icomformer_inference": launches_ico[kname],
            "launches_icomformer_train": launches_itrain[kname],
            "launches_jarvis_cli": launches_jarvis[kname],
            "launches_adp_cli": launches_adp[kname],
            "launches_dp_per_rank": {k: v[kname]
                                     for k, v in launches_dp.items()},
            "launches_ep_per_rank": {k: v[kname]
                                     for k, v in launches_ep.items()},
            "launches_chunks_per_micro_step": {
                k: v[kname] for k, v in launches_chunks.items()},
            **fused_rows(kname),
            "case": case, "max_abs_err": check_err[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            "library_device_ms": r.get("library_device_ms"),
            "gemm_ms": r.get("gemm_ms"),
            "gemm_device_ms": r.get("gemm_device_ms"),
            "products_ms": r.get("products_ms"),
            "products_device_ms": r.get("products_device_ms"),
            "passes_device_ms": r.get("passes_device_ms"),
            "cases": f32_rows(kname, ("l2_bf16_f32a", "l1_bf16", "l2_bf16")
                              if kname == "tp_contract_fwd" else ()),
            "f32": f32_rows(kname, ("l1_f32_config", "l2_f32_config"))})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
