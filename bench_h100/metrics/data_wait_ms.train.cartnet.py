"""The data layer (``data/pipeline.BatchPipeline``, ``data/batching``,
``data/adp.augment_record``): the host time the training loop waited for
its next batch (a span around each ``__next__`` of the iterator handed to
``train_epoch_fused``), the window's total over its micro-steps."""

UNIT = "ms"
MOVES = "train_structures_per_s.cartnet"


def read(r):
    w = r.window
    total, count = w.spans.get("data_wait", (0.0, 0))
    return 1e3 * total / w.steps if w.kind == "train" and count else None
