"""Kernels: K1, the edge-phase forward (``ops/kernels/edge_kernels.py``,
``csrc/edge_phase_fwd.cu``), as a share of its roofline in the
prediction sweep.

Work of one call at a batch's real edges E and atoms N, width d: the edge
block of the two first layers (E x d x 2d) and the two second layers
(E x d x d each), 8 E d^2 operations; bytes: the node tables xi and xj
([N, 2d] each), e, the outputs gate and sender, the indices and mask, the
weights and biases."""

from bench_h100.harness.costs import itemsize, roofline

UNIT = "%"
MOVES = "infer_structures_per_s"
PATTERNS = ("edge_fwd_", "edge_phase_fwd")  # f32 passes; the bf16 kernel
CALLS = {"float32": "edge_fwd_out_f32", "bfloat16": "edge_phase_fwd_tc"}


def cost(step, model, dtype):
    e, n, d, s = step["edges"], step["nodes"], model["dim_in"], \
        itemsize(dtype)
    ops = 8 * e * d * d
    nbytes = e * (3 * d * s + 9) + n * 2 * 2 * d * s + (4 * d * d + 4 * d) * s
    return ops, nbytes


def read(r):
    call = CALLS[r.config["model"]["compute_dtype"]]
    return roofline(r, PATTERNS, call, cost) \
        if r.window.kind == "infer" else None
