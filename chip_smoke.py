#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cartnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (every line names the card and its power limit):
  1. device   the card (nvidia-smi name and power limit, also printed raw)
  2. build    nvcc builds both kernels from csrc/ (one process per source)
  3. check    each kernel against its plain PyTorch version on the card, at
              the main path's shapes, in every dtype combination the main path
              feeds it, with the edge kernel's optional outputs off and on;
              plus a bitwise repeat of every kernel run
  4. main     the ADP inference sweep (runner.inference) over 2 batches of 4
              synthetic ADP-scale crystals, flagship model (dim 256, 64 RBF,
              4 layers, Cholesky head, bf16 compute, random weights from seed
              0): launch counts per kernel, finite predictions, and agreement
              with the same model run through the plain versions
  5. time     CUDA-event medians (>= 20 runs after warm-up) of each kernel
              and its plain version, the bound for the same work, the
              forward time per batch, and one profiled forward (device time
              by kernel, idle share of the device)
  6. kernels  the summary line {"kernels": [...]}
The last line is {"ok": true, "device": {...}}; any failure raises before it
(exit code != 0). Without a GPU, or without the repository beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}  # tensor-core bf16; f32 FMA
CHECK_TOL = {"f32": 1e-5, "bf16": 1e-2}  # max |kernel - plain| / max |plain|
PRED_TOL = 3e-2  # bf16 forward, kernels vs plain versions, normalized
RUNS = 30


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: int, n_ops: int, op_dtype: str) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- inputs

def edge_inputs(batch, table_dt, edge_dt, d, gen, dev):
    """Random K1 operands at the batch's shapes: node tables [N, 2d],
    edge features [E, d], weights U(+-1/sqrt(fan_in))."""
    import torch
    N, E = batch.num_nodes, batch.num_edges
    rn = lambda *s: torch.randn(*s, generator=gen).mul_(0.3)
    ru = lambda fan, *s: (torch.rand(*s, generator=gen) * 2 - 1) / math.sqrt(
        fan)
    vals = [rn(N, 2 * d).to(table_dt), rn(N, 2 * d).to(table_dt),
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


def sigma_cost(args, outs, E, d):
    # per element: scale, shift, exp, add, divide, envelope, residual add,
    # sender product, accumulate
    return bound(nbytes(*args) + nbytes(*outs), 9 * E * d, "f32")


def profile_forward(model, batch, top: int = 10) -> dict:
    """One profiled forward after warm-up: device time by kernel name, the
    device's busy time against the wall time, and the host launch count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kern = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kern[ev.name] = kern.get(ev.name, 0.0) + ev.device_time / 1e3
    busy = sum(kern.values())
    ranked = sorted(kern.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall_ms) if wall_ms else None,
            "device_kernels": sum(1 for ev in prof.events()
                                  if ev.device_type
                                  == torch.autograd.DeviceType.CUDA),
            "top_kernels_ms": [[name[:80], ms] for name, ms in ranked]}


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
    from cartnet_tpu_torch import runner
    from cartnet_tpu_torch.config import ModelConfig, resolve_device
    from cartnet_tpu_torch.data.batching import make_batches
    from cartnet_tpu_torch.data.synthetic import synthetic_dataset
    from cartnet_tpu_torch.models import cartnet as model_mod
    from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
    from cartnet_tpu_torch.ops.kernels import segment_kernels as sk

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
    t0 = time.perf_counter()
    _build.build_all(["edge_phase_fwd", "sigma_segsum_fwd"])
    build_s = time.perf_counter() - t0
    ptxas = {}
    for src in ("edge_phase_fwd", "sigma_segsum_fwd"):
        log = (_build.BUILD_DIR / f"{src}.log")
        ptxas[src] = [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln] \
            if log.exists() else []
    emit(phase="build", card=card, seconds=round(build_s, 3), ptxas=ptxas)

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

    # 3. kernel checks
    check_err = {"edge_phase_fwd": 0.0, "sigma_segsum_fwd": 0.0}
    timing_inputs = {}
    for case, (tdt, edt, _) in cases.items():
        args = edge_inputs(b0, tdt, edt, d, gen, dev)
        for extras in (False, True):
            kw = dict(saved=extras, moments=extras)
            got = ek.edge_phase_fwd(*args, *idx, **kw)
            again = ek.edge_phase_fwd(*args, *idx, **kw)
            want = ek.edge_phase_fwd_plain(*args, *idx, tile=ek.TILE_EDGES,
                                           **kw)
            torch.cuda.synchronize()
            tol = CHECK_TOL["f32" if tdt == edt == f32 else "bf16"]
            for oname, g, a, w in zip(("gate", "sender", "saved", "s1_w",
                                       "M2_w"), got, again, want):
                if w is None:
                    if g is not None:
                        fail(f"edge_phase_fwd returned {oname} unasked")
                    continue
                if g.dtype != w.dtype or g.shape != w.shape:
                    fail(f"edge_phase_fwd {case} {oname}: {g.dtype}"
                         f"{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
                abs_err, rel = normalized_err(g, w)
                bitwise = bool(torch.equal(g, a))
                emit(phase="check", card=card, kernel="edge_phase_fwd",
                     case=case, optional_outputs=extras, output=oname,
                     dtype=str(g.dtype), max_abs_err=abs_err,
                     max_rel_err=rel, tol=tol, bitwise_repeat=bitwise)
                if not (rel <= tol and bitwise and math.isfinite(abs_err)):
                    fail(f"edge_phase_fwd {case} {oname} rel err {rel} "
                         f"(tol {tol}), bitwise repeat {bitwise}")
                if case != "f32_config":
                    check_err["edge_phase_fwd"] = max(
                        check_err["edge_phase_fwd"], abs_err)
        timing_inputs[("edge", case)] = args

        sargs = sigma_inputs(b0, tdt, edt, d, gen, dev)
        got = sk.sigma_segsum(*sargs, b0.edge_dst, b0.edge_mask,
                              b0.dst_rowptr, N)
        again = sk.sigma_segsum(*sargs, b0.edge_dst, b0.edge_mask,
                                b0.dst_rowptr, N)
        want = sk.sigma_segsum_plain(*sargs, b0.edge_dst, b0.edge_mask, N)
        torch.cuda.synchronize()
        tol = CHECK_TOL["f32" if tdt == edt == f32 else "bf16"]
        for oname, g, a, w in zip(("e_out", "aggr"), got, again, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"sigma_segsum {case} {oname}: dtype/shape mismatch")
            abs_err, rel = normalized_err(g, w)
            bitwise = bool(torch.equal(g, a))
            emit(phase="check", card=card, kernel="sigma_segsum_fwd",
                 case=case, output=oname, dtype=str(g.dtype),
                 max_abs_err=abs_err, max_rel_err=rel, tol=tol,
                 bitwise_repeat=bitwise)
            if not (rel <= tol and bitwise and math.isfinite(abs_err)):
                fail(f"sigma_segsum {case} {oname} rel err {rel} (tol {tol})"
                     f", bitwise repeat {bitwise}")
            if case != "f32_config":
                check_err["sigma_segsum_fwd"] = max(
                    check_err["sigma_segsum_fwd"], abs_err)
        timing_inputs[("sigma", case)] = sargs

    # 4. main path: the inference sweep through the kernels
    cfg = ModelConfig(dim_in=d, dim_rbf=64, num_layers=4, cholesky=True,
                      compute_dtype=bf)
    model = model_mod.CartNet(cfg, device=dev, seed=0)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_path = str(_build.BUILD_DIR / "chip_smoke_inference.pkl")
    ek.launches = sk.launches = 0
    t0 = time.perf_counter()
    out = runner.inference(model, batches, out_path, device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = {"edge_phase_fwd": ek.launches,
                "sigma_segsum_fwd": sk.launches}
    per_forward = cfg.num_layers
    expect = per_forward * len(batches)
    preds = [torch.as_tensor(p) for p in out["pred"]]
    finite = all(bool(torch.isfinite(p).all()) for p in preds)
    n_atoms = sum(p.shape[0] for p in preds)
    emit(phase="main", card=card, batches=len(batches), structures=len(preds),
         atoms=n_atoms, nodes=N, edges=E,
         real_edges=[int(b.edge_mask.sum()) for b in batches],
         launches=launches, expected_launches_each=expect,
         sweep_seconds=round(sweep_s, 3), finite=finite,
         mean_mae=float(statistics.fmean(out["mae"])))
    if any(v != expect for v in launches.values()):
        fail(f"launch counts {launches}, expected {expect} each")
    if not finite or len(preds) != len(recs):
        fail("non-finite or missing predictions")

    # the same model through the plain versions on the card
    def plain_sigma(gate, scale, shift, env, sender, e_in, dst, mask, rowptr,
                    n):
        return sk.sigma_segsum_plain(gate, scale, shift, env, sender, e_in,
                                     dst, mask, n)

    kernel_fns = (model_mod.edge_phase_fwd, model_mod.sigma_segsum)

    def use_plain(on: bool):
        model_mod.edge_phase_fwd, model_mod.sigma_segsum = (
            (ek.edge_phase_fwd_plain, plain_sigma) if on else kernel_fns)

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

    # 5. times at the main path's shapes
    rows = {}
    for kname in ("edge_phase_fwd", "sigma_segsum_fwd"):
        rows[kname] = {}
        for case, (tdt, edt, calls) in cases.items():
            if kname == "edge_phase_fwd":
                args = timing_inputs[("edge", case)]
                fk = lambda a=args: ek.edge_phase_fwd(*a, *idx)
                fp = lambda a=args: ek.edge_phase_fwd_plain(*a, *idx)
                outs = fk()[:2]
                ops_dt = "f32" if edt == f32 else "bf16"
                t_bound, by = edge_cost(list(args) + list(idx), outs, d, E,
                                        ops_dt)
            else:
                args = timing_inputs[("sigma", case)]
                extra = (b0.edge_mask, b0.dst_rowptr)
                fk = lambda a=args: sk.sigma_segsum(
                    *a, b0.edge_dst, b0.edge_mask, b0.dst_rowptr, N)
                fp = lambda a=args: sk.sigma_segsum_plain(
                    *a, b0.edge_dst, b0.edge_mask, N)
                outs = fk()
                t_bound, by = sigma_cost(list(args) + list(extra), outs, E, d)
            plain1 = cuda_median_ms(fp)
            kern = cuda_median_ms(fk)
            plain2 = cuda_median_ms(fp)
            row = dict(ms=kern, plain_ms=statistics.fmean([plain1, plain2]),
                       bound_ms=t_bound, bound_by=by, calls=calls)
            rows[kname][case] = row
            emit(phase="time", card=card, kernel=kname, case=case,
                 runs=RUNS, **row,
                 share_of_bound=t_bound / kern if kern else None)
    emit(phase="forward", card=card, batch_ms_kernels=fwd_ms,
         batch_ms_plain=fwd_plain_ms, runs=20)
    emit(phase="profile", card=card, **profile_forward(model, b0))

    # 6. summary: per launch, averaged over one bf16 forward's launches
    # (layer 0 with bf16 node tables, layers 1-3 with f32 ones)
    def mix(kname, key):
        rs = rows[kname].values()
        return (sum(r[key] * r["calls"] for r in rs)
                / sum(r["calls"] for r in rs))

    kernels = []
    for kname, src, replaces in (
            ("edge_phase_fwd", "cartnet_tpu_torch/csrc/edge_phase_fwd.cu",
             "cartnet_tpu/ops/pallas/edge_kernels.py:162"),
            ("sigma_segsum_fwd", "cartnet_tpu_torch/csrc/sigma_segsum_fwd.cu",
             "cartnet_tpu/ops/pallas/segment_kernels.py:191")):
        by_ops = sum(r["calls"] for r in rows[kname].values()
                     if r["bound_by"] == "operations")
        by_bytes = sum(r["calls"] for r in rows[kname].values()
                       if r["bound_by"] == "bytes")
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": check_err[kname], "ms": mix(kname, "ms"),
            "plain_ms": mix(kname, "plain_ms"),
            "bound_ms": mix(kname, "bound_ms"),
            "bound_by": "operations" if by_ops > by_bytes else "bytes",
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
