"""A reference reads each crystal's lattice from ``Graphs`` alone:
``graphs()`` carries the records' cells (rotated where the configuration
augments) as the program's collated batch does, an edge's lattice rows are
``g.cell[g.graph[g.dst]]``, and the iComformer's lattice features computed
that way are the program's. The references that do not read the lattice
give the same outputs whatever ``cell`` holds."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from bench_h100.harness import cells, crystals
from bench_h100.reference import common

POOL = {"count": 12, "mean_atoms": 40, "spread": 0.3, "min_atoms": 4,
        "density": 0.1, "geometry_seed": 5}
SEED = 2**31 + 17


def records(max_neighbors=None):
    return crystals.make_pool(POOL, 5.0, max_neighbors, SEED, None)


def first_batch(recs, augment: bool):
    return common.training_batches(recs, SEED, 4, 1, augment)[0]


def collated(recs):
    """The program's padded, dst-sorted batch of ``recs`` (tail pads on
    nodes, edges and graphs) as torch tensors on the CPU."""
    from cartnet_tpu_torch.data.batching import collate
    n = sum(len(r["z"]) for r in recs)
    e = sum(len(r["edge_src"]) for r in recs)
    return collate(recs, n + 5, e + 70, len(recs) + 1).to("cpu")


def plain_lattice_features(g: common.Graphs):
    """What a plain iComformer reference computes from ``Graphs``: per edge,
    -0.75 / |row| of its crystal's three lattice rows, and the cosine
    between each row and the edge direction."""
    rows = g.cell[g.graph[g.dst]]                                 # [E, 3, 3]
    norm = torch.clamp(torch.linalg.vector_norm(rows, dim=-1), min=1e-6)
    dirs = g.cart_dir
    dnorm = torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True),
                        min=1e-6)
    cos = torch.einsum("ec,erc->er", dirs, rows) / (norm * dnorm)
    return -0.75 / norm, torch.clamp(cos, -1.0, 1.0)


@pytest.mark.parametrize("augment", [False, True])
def test_graphs_carry_the_records_cells(augment):
    pool = records()
    recs = first_batch(pool, augment)
    g = common.graphs(recs, "cpu")
    want = np.stack([r["cell"] for r in recs])
    assert g.cell.dtype == torch.float32 and g.cell.shape == (4, 3, 3)
    assert np.array_equal(g.cell.numpy(), want)
    plain = {id(r["edge_src"]): r["cell"] for r in pool}
    rotated = [not np.array_equal(r["cell"], plain[id(r["edge_src"])])
               for r in recs]
    assert all(rotated) if augment else not any(rotated)
    assert common.graphs(recs, "cpu", torch.float64).cell.dtype == \
        torch.float64


@pytest.mark.parametrize("augment", [False, True])
def test_graphs_cells_are_the_collated_batchs(augment):
    recs = first_batch(records(), augment)
    b = collated(recs)
    g = common.graphs(recs, "cpu")
    assert torch.equal(g.cell, b.cell[:len(recs)])
    gid = b.graph_id[b.node_mask]
    assert torch.equal(gid.long(), g.graph)


def _edge_order(dst, src, dist, dirs):
    """Edges sorted by (dst, src, distance, direction): the same order for
    the program's dst-sorted batch and the records' own order."""
    return np.lexsort((dirs[:, 2], dirs[:, 1], dirs[:, 0], dist, src, dst))


@pytest.mark.parametrize("max_neighbors", [None, 25])
def test_lattice_features_from_graphs_match_the_program(max_neighbors):
    from cartnet_tpu_torch.models.comformer import lattice_features
    recs = first_batch(records(max_neighbors), augment=True)
    g = common.graphs(recs, "cpu")
    b = collated(recs)
    inv_ref, cos_ref = plain_lattice_features(g)
    inv, cos = lattice_features(b, torch.float32)
    live = b.edge_mask.numpy()
    assert live.sum() == len(g.dst)
    mine = _edge_order(g.dst.numpy(), g.src.numpy(), g.dist.numpy(),
                       g.cart_dir.numpy())
    theirs = np.flatnonzero(live)[_edge_order(
        *(np.asarray(t)[live] for t in (b.edge_dst, b.edge_src,
                                        b.cart_dist, b.cart_dir)))]
    assert np.array_equal(g.dst.numpy()[mine], b.edge_dst.numpy()[theirs])
    assert np.array_equal(g.cart_dir.numpy()[mine],
                          b.cart_dir.numpy()[theirs])
    for ref, got in ((inv_ref, inv), (cos_ref, cos)):
        gap = (ref[mine] - got[theirs]).abs().max().item()
        assert gap <= 1e-6, gap
    assert cos_ref.abs().max() > 0.5


@pytest.mark.parametrize("config", ["cartnet_adp", "ecomformer_adp"])
def test_references_do_not_read_the_cell(config):
    conf = cells.config(cells.benchmark(), config)
    kwargs = {**conf["model"], "dim_in": 32, "dim_rbf": 16, "num_layers": 2}
    torch.manual_seed(3)
    model = cells.reference_model(conf)(**kwargs)
    g = common.graphs(first_batch(records(), augment=True), "cpu")
    blanks = (None, torch.full_like(g.cell, float("nan")))
    for train in (False, True):
        outs = []
        for cell in (g.cell,) + blanks:
            m = copy.deepcopy(model).train(train)
            with torch.no_grad():
                outs.append(m(dataclasses.replace(g, cell=cell)))
        assert torch.isfinite(outs[0]).all()
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
