"""The data layer (``data/pipeline.BatchPipeline._emit``): the
program's span ``data.batch`` on the prefetch thread (fetch,
``augment_record``, RCM reorder, ``collate``), its mean per batch made
in the traced stretch: the data layer's own cost a batch, which the
prefetch may hide."""

from bench_h100.harness.program_spans import mean_ms

UNIT = "ms"
MOVES = "train_structures_per_s.cartnet"


def read(r):
    return mean_ms(r, "train", "data.batch")
