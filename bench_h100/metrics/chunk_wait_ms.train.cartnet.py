"""The fused chunk's wait for the card (``train/graphs.ChunkRunner``):
the program's spans ``chunk.wait`` (``_Graph.load``'s wait on the
previous chunk's copy) and ``chunk.replay`` (the graph's launch, which
on the card blocks until the previous replay has drained), per chunk run
in the traced stretch: the card's headroom over the host (0 where the
chunk never waits, as on the CPU)."""

from bench_h100.harness.program_spans import span

UNIT = "ms"
MOVES = "train_structures_per_s.cartnet"


def read(r):
    run = span(r, "train", "chunk.run")
    if run is None:
        return None
    waits = [span(r, "train", n) for n in ("chunk.wait", "chunk.replay")]
    return 1e3 * sum(w[1] for w in waits if w) / run[0]
