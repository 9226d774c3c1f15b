"""Readings for a cell's correctness limits, on the card at the cell's
own size (PERF.md gives those the committed limits were set from).

    python3 bench_h100/calibrate.py --workload <cell> --mode <mode> \
        --seeds <n> [<n> ...] [--seconds <s>]

Modes, each seed in turn in this one process, one JSON line a seed:

* ``sound``: the program, as ``run.py`` runs it (training: set-up and the
  comparison, no window; the sweep: a ``--seconds`` window), against the
  plain reference: the lower readings;
* ``control``: the reference in TF32 put in the program's place, against
  the reference in float32 (TF32 off, as the configurations state);
* ``half_batch``: the reference with half of each batch left out (the
  training loss over the rest; the sweep's answers of the second half
  zeroed), against the whole;
* ``witness`` (training): the float32 reference against the reference in
  float64, its own rounding beside the program's (``sound``).

A training cell's state left unchanged reads 1 by ``change_gap`` and
``bn_gap`` without a run.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def inputs(r):
    """The run's records and weights, as the drivers make them."""
    from bench_h100.harness import cells, crystals
    from bench_h100.harness.weights import make_weights
    cfg = cells.port_config(r.config, r.mix, r.job_seed)
    records = crystals.make_pool(r.mix["pool"], cfg.data.radius,
                                 cfg.data.max_neighbors, r.seed, r.cache_dir)
    ref = cells.reference_model(r.config)(**r.config["model"])
    return records, make_weights(ref, r.weight_seed, r.device)


def reading(r, mode: str) -> dict:
    from bench_h100.harness import compare, core
    from bench_h100.harness.drivers import infer_sweep as infer_driver
    from bench_h100.harness.drivers import train_fused as train_driver
    if mode == "sound":
        _, numbers, attempted, failed, _ = core.driver_module(
            r.mix["driver"]).run(r)
        return {**numbers, "attempted": attempted, "failed": failed}
    records, weights = inputs(r)
    if r.mix["driver"] == "train_fused":
        base = train_driver.reference_side(r, records, weights)
        if mode == "witness":
            import torch
            other, base = base, train_driver.reference_side(
                r, records, weights, dtype=torch.float64)
        elif mode == "control":
            other = train_driver.reference_side(r, records, weights,
                                                tf32=True)
        else:
            other = train_driver.reference_side(
                r, records, weights,
                keep_graphs=r.config["data"]["batch_size"] // 2)
        return compare.train_numbers(other, base,
                                     r.config["optim"]["batch_accumulation"])
    size = r.mix["batch_size"]
    positions = range(-(-len(records) // size))
    want = infer_driver.reference_predictions(r, records, weights,
                                              positions)
    other = (infer_driver.reference_predictions(r, records, weights,
                                                positions, tf32=True)
             if mode == "control" else None)
    worst = 0.0
    for pos in positions:
        got = other[pos] if other is not None else want[pos].copy()
        if other is None:  # the crystals of the second half: no answer
            recs = records[pos * size:(pos + 1) * size]
            first = sum(len(x["z"]) for x in recs[:len(recs) // 2])
            got[first:] = 0.0
        keep = infer_driver.non_h(records, pos, size)
        worst = max(worst, compare.pred_gap(got[keep], want[pos][keep]))
    return {"pred_gap": worst}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("sound", "control", "half_batch",
                                      "witness"),
                   required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from bench_h100.harness import cells, core
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    bench = cells.benchmark(ROOT)
    rows = []
    for seed in args.seeds:
        r = core.Run(bench=bench, cell=args.workload, seed=seed,
                     seconds=args.seconds, trace=False,
                     device=torch.device("cuda", 0), started=time.time())
        row = {"workload": args.workload, "mode": args.mode, "seed": seed,
               **reading(r, args.mode)}
        rows.append(row)
        print(json.dumps(core.finite(row)), flush=True)
    keys = [k for k in rows[0] if isinstance(rows[0][k], (int, float))
            and k != "seed"]
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "seeds": len(rows),
                      "max": {k: max(x[k] for x in rows) for k in keys},
                      "min": {k: min(x[k] for x in rows) for k in keys}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
