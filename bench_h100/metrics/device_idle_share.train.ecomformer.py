"""The device (H100): the share of the traced stretch's wall time in which
no operation ran on the card, in a training cell."""

UNIT = "%"
MOVES = "train_structures_per_s.ecomformer"


def read(r):
    t = r.trace
    if r.window.kind != "train" or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
