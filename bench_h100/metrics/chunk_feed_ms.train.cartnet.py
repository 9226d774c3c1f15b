"""The train loop's fused chunk (``train/loop.train_epoch_fused``,
``train/graphs.ChunkRunner``): the host time of each ``run_chunk`` call
(pinned stack, copy to the card, replay launch, output clone), the
window's total over its replays."""

UNIT = "ms"
MOVES = "train_structures_per_s.cartnet"


def read(r):
    w = r.window
    total, count = w.spans.get("chunk_feed", (0.0, 0))
    return 1e3 * total / w.replays if w.kind == "train" and w.replays \
        else None
