"""Model FLOPs of one forward over a batch's real atoms and edges, for the
``mfu.*`` metrics.

Matrix products only (2 operations a multiply-add); elementwise work,
gathers and sums are below a few percent. A node projection counts once a
node and an edge product once an edge, the least work the model needs
(the message MLPs' first layers act on [x_dst | x_src | e], which is two
node projections and one edge product). A training step counts three
forwards (forward and backward) and no recomputation. Counts use the real
(masked-in) atoms, edges and crystals, never the pads.
"""

from __future__ import annotations

import importlib

NS, NV = 64, 8  # the eComformer's scalar and vector/tensor channels
TP_NUMEL = NS * NS + 2 * NS * NV  # 5120 tensor-product weights an edge


def _head(n: int, d: int) -> float:
    """The Cholesky head: d -> d/2 -> 6 per atom."""
    return 2.0 * n * (d * (d // 2) + (d // 2) * 6)


def cartnet(model: dict, n: int, e: int, g: int) -> float:
    d, layers = model["dim_in"], model["num_layers"]
    dim_edge = model["dim_rbf"] + (0 if model.get("invariant") else 3)
    encoder = (2.0 * g * 2 * d                        # temperature projection
               + 2.0 * n * 2 * d * d                  # encoder_atom 2d -> d
               + 2.0 * e * (dim_edge * 2 * d + 2 * d * d))  # edge encoder
    # per layer: the two MLPs' first layers (node blocks per node: [d, 2d]
    # for dst and for src; edge block [d, 2d] per edge), their second
    # layers (two [d, d] per edge)
    layer = 2.0 * (2 * n * d * 2 * d + e * d * 2 * d + 2 * e * d * d)
    return encoder + layers * layer + _head(n, d)


def ecomformer(model: dict, n: int, e: int, g: int) -> float:
    d = model["dim_in"]
    inputs = 2.0 * g * d + 2.0 * e * d * d            # temp proj, rbf head
    # a conv: q/k/v and lin_concate per node, lin_edge per edge, the
    # key/msg first layers (node blocks [d, d] x 4 per node, edge block
    # [d, 2d] per edge) and second layers (two [d, d] per edge)
    conv = 2.0 * (4 * n * d * d + e * d * d + 4 * n * d * d
                  + e * d * 2 * d + 2 * e * d * d)
    # the equivariant block: node_linear, skip, node_linear_2 per node;
    # both tensor products' weight MLPs (d -> d -> 5120) and their
    # contractions (one multiply-add a generated weight) per edge
    equi = (2.0 * n * (d * NS + d * d + NS * d)
            + 2 * 2.0 * e * (d * d + d * TP_NUMEL + TP_NUMEL))
    return inputs + 3 * conv + equi + _head(n, d)


FORWARD = {"cartnet": cartnet, "ecomformer": ecomformer}


def forward(model: dict, n: int, e: int, g: int) -> float:
    """One forward's FLOPs; a family not counted here is counted by
    ``bench_h100/flops_<name>.py``'s ``forward``, the file a later cell of
    a new family adds (this one stays as accepted)."""
    fn = FORWARD.get(model["name"])
    if fn is None:
        fn = importlib.import_module(
            f"bench_h100.flops_{model['name']}").forward
    return fn(model, n, e, g)


def train_step(model: dict, n: int, e: int, g: int) -> float:
    return 3.0 * forward(model, n, e, g)
