"""Multi-seed result aggregation (port of cartnet_tpu/aggregate.py).

Reads ``results/<name>/<seed>/<split>/stats.json`` across seeds and prints
the mean, std, max and min of each metric of the last line (the final
test), MAE always, S12 / IoU and the rest where present. With ``--epochs
LO HI`` each seed contributes instead the median of each metric (epoch
times included) over its lines of epochs LO <= epoch < HI, as in the
val curve of a training run.

    python -m cartnet_tpu_torch.aggregate --name NAME [--seeds 0 1 2 3]
        [--split val --epochs 150 300]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def load_stats(path: str) -> List[Dict]:
    """stats.json holds one JSON line per epoch."""
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().splitlines() if ln.strip()]


def load_last_stats(path: str) -> Dict:
    """The last line of a stats.json: the final eval."""
    return load_stats(path)[-1]


def epoch_medians(rows: List[Dict], lo: int, hi: int) -> Dict:
    """Median of each metric over the lines of epochs lo <= epoch < hi."""
    rows = [r for r in rows if lo <= r["epoch"] < hi]
    if not rows:
        raise ValueError(f"no lines of epochs {lo}-{hi - 1}")
    keys = set().union(*[r.keys() for r in rows]) - {"epoch"}
    return {k: float(np.median([r[k] for r in rows if k in r]))
            for k in keys}


def aggregate(name: str, seeds: List[int], results_dir: str = "results",
              split: str = "test", epochs: Optional[Tuple[int, int]] = None
              ) -> Dict[str, Dict[str, float]]:
    rows = []
    for seed in seeds:
        p = os.path.join(results_dir, name, str(seed), split, "stats.json")
        if not os.path.exists(p):
            print(f"warning: missing {p}")
            continue
        rows.append(load_last_stats(p) if epochs is None
                    else epoch_medians(load_stats(p), *epochs))
    if not rows:
        raise FileNotFoundError(f"no {split} stats for {name} in "
                                f"{results_dir}")
    skip = {"epoch", "lr"} | ({"time_epoch"} if epochs is None else set())
    keys = sorted(set().union(*[r.keys() for r in rows]) - skip)
    out = {}
    for k in keys:
        vals = np.array([r[k] for r in rows if k in r], dtype=np.float64)
        out[k] = {"mean": float(vals.mean()), "std": float(vals.std()),
                  "max": float(vals.max()), "min": float(vals.min()),
                  "n": int(len(vals))}
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("cartnet_tpu_torch.aggregate")
    ap.add_argument("--name", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--results_dir", default="results")
    ap.add_argument("--split", default="test")
    ap.add_argument("--epochs", type=int, nargs=2, metavar=("LO", "HI"),
                    help="medians over epochs LO <= epoch < HI instead of "
                         "the last line")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    stats = aggregate(args.name, args.seeds, args.results_dir, args.split,
                      args.epochs)
    for k, v in stats.items():
        print(f"{k:<24} mean {v['mean']:.6g}  std {v['std']:.3g}  "
              f"max {v['max']:.6g}  min {v['min']:.6g}  (n={v['n']})")
    return stats


if __name__ == "__main__":
    main()
