"""CartNet training throughput: the real crystals of every micro-step the window
completed, over the window's whole wall time (from the first batch pulled
to the return of ``train_epoch_fused``, which synchronises)."""

UNIT = "structures/s"


def read(r):
    w = r.window
    return w.structures / w.seconds if w.kind == "train" and w.steps else None
