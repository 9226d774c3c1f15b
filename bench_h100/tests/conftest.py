"""CPU tests of the benchmark (``python -m pytest bench_h100/tests``).

Tests that need a CUDA card carry the ``card`` marker and skip inside the
test where there is none; the card decides nothing at import time."""

import copy
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_run(cell: str, tmp_path, seed: int = 2**31 + 7, seconds=0.5,
             trace=False, device="cpu"):
    """A ``core.Run`` of ``cell`` at a test size: width 32, two layers, a
    pool of 24 small crystals, 4 micro-steps a chunk and an update."""
    import torch
    from bench_h100.harness import cells, core
    r = core.Run(bench=cells.benchmark(ROOT), cell=cell, seed=seed,
                 seconds=seconds, trace=trace, device=torch.device(device),
                 started=time.time(), cache_dir=str(tmp_path / "cache"))
    r.config = copy.deepcopy(r.config)
    r.mix = copy.deepcopy(r.mix)
    r.config["model"].update(dim_in=32, dim_rbf=16, num_layers=2)
    r.config["optim"]["batch_accumulation"] = 4
    r.config["epoch_micro_steps"] = 64
    r.mix["pool"].update(count=24, mean_atoms=40)
    if r.mix["driver"] == "train_fused":
        r.mix["fused_steps"] = 4
    else:
        r.mix["batch_size"] = 8
    return r
