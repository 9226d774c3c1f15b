"""Kernels: K8, the tensor-product backward (``ops/kernels/tp_kernels.py``,
``csrc/tp_contract_bwd.cu``), as a share of its roofline in training.

Work of one call at a micro-step's real edges E, width d: the three
E x d x 5120 products (the per-edge weights recomputed, dh, dwt) and six
operations a generated weight; bytes: h and dh ([E, d]), the gathered
irreps, their cotangents and gradients (224 values an edge at most), wt
read and dwt written ([5120, d], f32), b and db."""

from bench_h100.harness.costs import itemsize, roofline

UNIT = "%"
MOVES = "train_structures_per_s.ecomformer"
PATTERNS = ("tp_bwd_",)  # the tile, weights and reduce passes
CALL = "tp_bwd_reduce"   # one a call
NUMEL = 5120


def cost(step, model, dtype):
    e, d, s = step["edges"], model["dim_in"], itemsize(dtype)
    ops = 6 * e * d * NUMEL + 6 * e * NUMEL
    nbytes = e * (2 * d + 224) * s + NUMEL * d * (s + 4) + NUMEL * (s + 4)
    return ops, nbytes


def read(r):
    return roofline(r, PATTERNS, CALL, cost) \
        if r.window.kind == "train" else None
