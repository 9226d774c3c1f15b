"""The model's share of the card's peak in training: ``flops.py``'s
forward and backward FLOPs (three forwards, no recomputation) of every
micro-step of the window, at its real atoms and edges, over the window's
wall time and the configuration's ``peak_flops``."""

UNIT = "%"
MOVES = "train_structures_per_s.ecomformer"


def read(r):
    w = r.window
    if w.kind != "train" or not w.steps:
        return None
    return 100.0 * w.flops / (w.seconds * r.peak_flops)
