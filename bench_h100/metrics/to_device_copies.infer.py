"""The host-to-device hand-off (``data/schema.CrystalBatch.to``): the
program's counter ``batch.to_device.copies`` (the array fields moved)
over its ``batch.to_device`` spans in the traced stretch: copies a
batch."""

from bench_h100.harness.program_spans import session, span

UNIT = "copies"
MOVES = "infer_structures_per_s"


def read(r):
    row = span(r, "infer", "batch.to_device")
    if row is None:
        return None
    copies = session(r, "infer")["counters"].get("batch.to_device.copies")
    return None if copies is None else copies / row[0]
