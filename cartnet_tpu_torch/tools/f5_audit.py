"""Where bf16 training's late val gap on the adpfix fixture sits.

    python -m cartnet_tpu_torch.tools.f5_audit [--out DIR] [--seed 0] \
        [--epochs 300] [--device cuda|cpu] [-- extra CLI flags]

Runs the README's fixture command (``--dataset adpfix --batch 4
--batch_accumulation 16 --augment``) in f32 and with ``--bf16``, the two
runs at once as two processes, in a temporary directory. Then it reads
each run's ``last.ckpt`` and ``best.ckpt`` and measures the val MAE of
their weights four ways:

  (a) the bf16 eval forward with the checkpoint's BN running stats;
  (b) the f32 eval forward with the same stats;
  (c) the bf16 eval forward with running stats re-estimated in f32: f32
      train-mode forwards over one augmented pass of the train split (the
      run's own pipeline, same seed), the batches' moments averaged with
      equal weight (a cumulative average);
  (d) the f32 eval forward with those stats.

Writes ``DIR/f5_audit.json`` (the four MAEs a checkpoint, the last val
line each run logged, the card), each run's ``stats.json`` files under
``DIR/<run>/`` and each checkpoint's ``model_state`` as
``DIR/<run>_{last,best}.pt``, and prints the JSON. Flags after ``--``
go to both runs (a narrow CPU rehearsal: ``--device cpu -- --limit 8
--dim_in 32 --dim_rbf 16 --num_layers 2``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types

import torch

from cartnet_tpu_torch import cli, runner
from cartnet_tpu_torch.config import resolve_device
from cartnet_tpu_torch.models.factory import create_model
from cartnet_tpu_torch.train import loop

FIXTURE = ["--dataset", "adpfix", "--batch", "4", "--batch_accumulation",
           "16", "--augment"]
WAYS = {"a_bf16_logged_stats": (torch.bfloat16, False),
        "b_f32_logged_stats": (torch.float32, False),
        "c_bf16_f32_stats": (torch.bfloat16, True),
        "d_f32_f32_stats": (torch.float32, True)}


def _cfg(argv, dtype):
    cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=dtype))


def val_mae(cfg, state_dict, val_pipe, device) -> float:
    """The weighted val MAE of the eval forward, as the run's logger
    computes it."""
    model = create_model(cfg.model, device, cfg.seed)
    model.load_state_dict(state_dict, strict=True)
    evals = loop.make_steps(cfg)[2]
    rows = loop.eval_epoch(types.SimpleNamespace(model=model), val_pipe,
                           evals, device)
    return loop.epoch_means(rows)["MAE"]


def f32_running_stats(cfg, state_dict, train_pipe, device) -> dict:
    """``state_dict`` with every BN running mean and variance replaced by
    the equal-weight average of f32 train-mode batch moments over one pass
    of ``train_pipe``."""
    c = dataclasses.replace(cfg.model, compute_dtype=torch.float32,
                            bn_momentum=1.0)
    model = create_model(c, device, cfg.seed)
    keys = [k for k in state_dict
            if k.endswith(("running_mean", "running_var"))]
    sums, n = {k: torch.zeros_like(state_dict[k], dtype=torch.float64,
                                   device=device) for k in keys}, 0
    for batch in train_pipe:
        model.load_state_dict(state_dict, strict=True)
        model.train()
        with torch.no_grad():
            model(batch.to(device))
        sd = model.state_dict()
        for k in keys:
            sums[k] += sd[k].double()
        n += 1
    out = dict(state_dict)
    for k in keys:
        out[k] = (sums[k] / max(n, 1)).to(state_dict[k].dtype).cpu()
    return out


def audit(run_dir, argv, device) -> dict:
    """The four val MAEs of the run's last and best checkpoints."""
    cfg32 = _cfg(argv, torch.float32)
    splits = cli.load_datasets(cfg32.data, cli.build_parser().parse_args(
        argv).limit)
    train_pipe, val_pipe, _ = runner.pipelines(cfg32, splits)
    out = {}
    best, last = runner.checkpoint_paths(run_dir)
    for tag, path in (("last", last), ("best", best)):
        sd = torch.load(path, map_location="cpu",
                        weights_only=True)["model_state"]
        sd_f32 = f32_running_stats(cfg32, sd, train_pipe, device)
        out[tag] = {way: val_mae(_cfg(argv, dt), sd_f32 if est else sd,
                                 val_pipe, device)
                    for way, (dt, est) in WAYS.items()}
    return out


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("f5_audit")
    p.add_argument("--out", default="f5_audit")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--device", default="cuda")
    p.add_argument("extra", nargs="*")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    base = FIXTURE + ["--epochs", str(args.epochs), "--seed",
                      str(args.seed), "--device", args.device] + args.extra
    runs = {"f32": base + ["--name", "f5_f32"],
            "bf16": base + ["--bf16", "--name", "f5_bf16"]}
    result = {"card": _card(), "seed": args.seed, "epochs": args.epochs,
              "argv": base, "runs": {}}
    if device.type == "cuda":  # build once, before both runs start
        from cartnet_tpu_torch.ops.kernels import _build
        _build.build_all(["edge_phase_fwd", "sigma_segsum_fwd",
                          "sigma_segsum_bwd", "edge_phase_bwd"])
    with tempfile.TemporaryDirectory(prefix="f5_audit_") as tmp:
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))]
            + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
        procs = {}
        for name, run_argv in runs.items():
            log = open(os.path.join(out_dir, f"{name}.log"), "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "cartnet_tpu_torch.cli"] + run_argv,
                cwd=tmp, env=env, stdout=log, stderr=subprocess.STDOUT),
                log)
        for name, (proc, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc:
                raise RuntimeError(f"the {name} fixture run exited {rc}")
        for name, run_argv in runs.items():
            parsed = cli.build_parser().parse_args(run_argv)
            run_dir = os.path.join(tmp, "results", parsed.name,
                                   str(args.seed))
            for split in ("train", "val", "test"):
                dst = os.path.join(out_dir, name, split)
                os.makedirs(dst, exist_ok=True)
                shutil.copy(os.path.join(run_dir, split, "stats.json"), dst)
            with open(os.path.join(run_dir, "val", "stats.json")) as f:
                val_lines = [json.loads(x) for x in f if x.strip()]
            best, last = runner.checkpoint_paths(run_dir)
            for tag, path in (("last", last), ("best", best)):
                sd = torch.load(path, map_location="cpu",
                                weights_only=True)["model_state"]
                torch.save(sd, os.path.join(out_dir, f"{name}_{tag}.pt"))
            result["runs"][name] = {
                "logged_last_val_MAE": val_lines[-1]["MAE"],
                "logged_best_val_MAE": min(r["MAE"] for r in val_lines),
                "val_MAE": audit(run_dir, run_argv, device)}
    with open(os.path.join(out_dir, "f5_audit.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
