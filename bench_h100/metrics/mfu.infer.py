"""The model's share of the card's peak in the prediction sweep:
``flops.py``'s forward FLOPs of every batch of the window, at its real
atoms and edges, over the window's wall time and ``peak_flops``."""

UNIT = "%"
MOVES = "infer_structures_per_s"


def read(r):
    w = r.window
    if w.kind != "infer" or not w.steps:
        return None
    return 100.0 * w.flops / (w.seconds * r.peak_flops)
