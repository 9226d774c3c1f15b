"""Kernels: K5, the edge-phase backward (``ops/kernels/edge_kernels.py``,
``csrc/edge_phase_bwd.cu``), as a share of its roofline in training.

Work of one call at a micro-step's real edges E and atoms N, width d: the
products dh = [dg|ds] W1^T, de = dpre We^T and the weight gradients dWe,
dW1g, dW1a, 16 E d^2 operations; bytes: the edge operands e, the saved
[pre | sigmoid] (4d), gate, dgate, dsender, deres and the output de, the
indices and mask, the per-64-edge-window moments (three f32 [E/64, d]),
the node outputs dxi and dxj ([N, 2d] each), the weights read and their
gradients written (f32)."""

from bench_h100.harness.costs import itemsize, roofline

UNIT = "%"
MOVES = "train_structures_per_s.cartnet"
PATTERNS = ("edge_bwd_",)  # the tile, weights and reduce passes
CALL = "edge_bwd_tile"     # one a call


def cost(step, model, dtype):
    e, n, d, s = step["edges"], step["nodes"], model["dim_in"], \
        itemsize(dtype)
    ops = 16 * e * d * d
    nbytes = (e * (10 * d * s + 13) + 3 * (e // 64) * d * 4
              + n * (2 * 2 * d * s + 8) + 4 * d * d * (s + 4) + 8 * d * 4)
    return ops, nbytes


def read(r):
    return roofline(r, PATTERNS, CALL, cost) \
        if r.window.kind == "train" else None
