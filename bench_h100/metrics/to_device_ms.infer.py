"""The host-to-device hand-off (``data/schema.CrystalBatch.to``): the
program's span ``batch.to_device`` in the sweep, its mean per batch moved
in the traced stretch (one copy a field, pageable, synchronous)."""

from bench_h100.harness.program_spans import mean_ms

UNIT = "ms"
MOVES = "infer_structures_per_s"


def read(r):
    return mean_ms(r, "infer", "batch.to_device")
