"""The model's host side in the sweep: the program's span
``model.forward`` (``models/cartnet.CartNet.forward``), its mean per eval
forward in the traced stretch: the time the host takes to enqueue the
forward's kernels (and to wait, where anything in it syncs)."""

from bench_h100.harness.program_spans import mean_ms

UNIT = "ms"
MOVES = "infer_structures_per_s"


def read(r):
    return mean_ms(r, "infer", "model.forward")
