"""The fused chunk's own host work (``train/graphs.ChunkRunner``): the
program's span ``chunk.run`` less its ``chunk.wait`` and
``chunk.replay`` (what is left: the pinned stack, the copies' enqueue,
the output clone), per chunk run in the traced stretch. The replay's
launch counts as waiting (``chunk_wait_ms``): on the card the launch of
a 16-step graph blocks until the previous replay has drained."""

from bench_h100.harness.program_spans import span

UNIT = "ms"
MOVES = "train_structures_per_s.ecomformer"


def read(r):
    run = span(r, "train", "chunk.run")
    if run is None:
        return None
    waits = [span(r, "train", n) for n in ("chunk.wait", "chunk.replay")]
    return 1e3 * (run[1] - sum(w[1] for w in waits if w)) / run[0]
