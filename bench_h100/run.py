"""Runs one cell of the benchmark once and prints its result line.

    python3 bench_h100/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, this folder and
the program (``cartnet_tpu_torch``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number the correctness check compared, beside its limit (also the last
lines of standard error). Without a CUDA card, or with fewer than the cell
asks for, it exits with code 2 and prints no result; if JAX or the JAX
package is loaded once the window has closed, with code 3.
"""

import os
import time


def _process_start() -> float:
    """The process's start on the wall clock (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(ln.split()[1]) for ln in f
                        if ln.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


STARTED = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "cartnet_tpu"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every compile cache of the run at a fixed path inside the checkout
    # (the program's nvcc builds go to cartnet_tpu_torch/_build/)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                      "torch_extensions")
    sys.path.insert(0, ROOT)
    from bench_h100.harness import cells, core

    bench = cells.benchmark(ROOT)
    chips = cells.workload(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"needs {chips} CUDA card(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    run = core.Run(bench=bench, cell=args.workload, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   device=torch.device("cuda", 0), started=STARTED)
    out = core.execute(run)
    loaded = sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    if loaded:
        core.log(f"the run loaded {loaded}: the benchmark runs the port "
                 "without JAX")
        return 3
    print(json.dumps(core.finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
