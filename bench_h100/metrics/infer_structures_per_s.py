"""Prediction throughput: the crystals predicted in the window over its
whole wall time."""

UNIT = "structures/s"


def read(r):
    w = r.window
    return w.structures / w.seconds if w.kind == "infer" and w.steps else None
