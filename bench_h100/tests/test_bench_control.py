"""The control on the card: the plain reference in TF32, put in the
program's place, comes out not correct against the reference in float32
(what the configurations state), at the published widths on a small pool.
``calibrate.py --mode control`` reads the same at the cells' own size."""

import copy
import os
import sys

import pytest

from bench_h100.harness import cells, compare, core

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import calibrate  # noqa: E402


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cartnet_adp.train",
                                  "ecomformer_adp.train",
                                  "cartnet_adp.infer"])
def test_control_fails(card, tmp_path, cell):
    import time
    r = core.Run(bench=cells.benchmark(), cell=cell, seed=2**31 + 99,
                 seconds=0.0, trace=False, device=card, started=time.time(),
                 cache_dir=str(tmp_path))
    r.mix = copy.deepcopy(r.mix)
    r.mix["pool"].update(count=32, mean_atoms=120)
    numbers = calibrate.reading(r, "control")
    numbers.pop("detail", None)
    correct, _ = compare.judge(numbers, r.limits)
    assert correct is False
