"""Port data path vs the JAX package: radius graph, synthetic records, RCM
relabeling and collate must agree exactly (they are the same numpy code),
and the port's CSR offsets must describe edge_dst."""

import numpy as np
import pytest
import torch

from cartnet_tpu.data import batching as jb
from cartnet_tpu.data import radius_graph as jrg
from cartnet_tpu.data import synthetic as jsyn
from cartnet_tpu_torch.data import batching as tb
from cartnet_tpu_torch.data import radius_graph as trg
from cartnet_tpu_torch.data import synthetic as tsyn

SHARED_FIELDS = ("z", "pos", "graph_id", "node_mask", "non_h_mask",
                 "edge_src", "edge_dst", "cart_dir", "cart_dist", "edge_mask",
                 "cell", "temperature", "graph_mask", "y", "edge_src_perm",
                 "edge_src_sorted", "edge_mask_src_sorted", "src_degree")


def _records_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        assert va.dtype == vb.dtype, k
        np.testing.assert_array_equal(va, vb, err_msg=k)


@pytest.mark.parametrize("adp", [False, True])
def test_synthetic_dataset_matches(adp):
    for ra, rb in zip(tsyn.synthetic_dataset(4, mean_atoms=40, adp=adp,
                                             seed=3),
                      jsyn.synthetic_dataset(4, mean_atoms=40, adp=adp,
                                             seed=3)):
        _records_equal(ra, rb)


@pytest.mark.parametrize("max_neighbors", [None, 12])
def test_radius_graph_matches(max_neighbors):
    rng = np.random.default_rng(11)
    cell = np.diag([7.0, 8.0, 9.0]) + rng.uniform(-0.5, 0.5, (3, 3))
    pos = rng.uniform(0, 1, (30, 3)) @ cell
    ours = trg.radius_graph_pbc(pos, cell, 5.0, max_neighbors)
    for backend in ("numpy", "auto"):
        ref = jrg.radius_graph_pbc(pos, cell, 5.0, max_neighbors,
                                   backend=backend)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_learnable_adp_y_matches():
    r = tsyn.synthetic_dataset(1, mean_atoms=30, seed=4)[0]
    args = (r["z"], r["edge_src"], r["edge_dst"], r["cart_dist"],
            r["cart_dir"], r["temperature"], 5.0)
    np.testing.assert_array_equal(tsyn.learnable_adp_y(*args),
                                  jsyn.learnable_adp_y(*args))


def test_bandwidth_reorder_matches():
    for r in tsyn.synthetic_dataset(2, mean_atoms=50, adp=True, seed=6):
        _records_equal(tb.bandwidth_reorder(r), jb.bandwidth_reorder(r))


@pytest.mark.parametrize("edge_align", [0, 512])
def test_collate_matches(edge_align):
    recs = tsyn.synthetic_dataset(3, mean_atoms=40, adp=True, seed=7)
    n = sum(len(r["z"]) for r in recs)
    e = sum(-(-len(r["edge_src"]) // 512) * 512 for r in recs)
    max_nodes, max_edges = -(-n // 128) * 128, -(-e // 512) * 512 + 512
    ours = tb.collate(recs, max_nodes, max_edges, 4, edge_align=edge_align)
    ref = jb.collate(recs, max_nodes, max_edges, 4, edge_align=edge_align)
    for f in SHARED_FIELDS:
        a, b = np.asarray(getattr(ours, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    rowptr = ours.dst_rowptr
    assert rowptr.dtype == np.int32 and rowptr.shape == (max_nodes + 1,)
    assert rowptr[0] == 0 and rowptr[-1] == max_edges
    np.testing.assert_array_equal(
        np.diff(rowptr), np.bincount(ours.edge_dst, minlength=max_nodes))
    # src_rowptr: CSR offsets of the src-sorted edge order
    srowptr = ours.src_rowptr
    assert srowptr.dtype == np.int32 and srowptr.shape == (max_nodes + 1,)
    np.testing.assert_array_equal(
        np.diff(srowptr), np.bincount(ours.edge_src, minlength=max_nodes))
    for n in np.unique(ours.edge_src):
        sel = ours.edge_src_perm[srowptr[n]:srowptr[n + 1]]
        assert (ours.edge_src[sel] == n).all() and (np.diff(sel) > 0).all()
    last_real = np.flatnonzero(ours.edge_mask)[-1]
    # edge_align puts masked pad edges between graphs' real edges
    assert (~ours.edge_mask[:last_real]).any() == bool(edge_align)


@pytest.mark.parametrize("mean_atoms", [20, 120])
def test_pipeline_matches_jax(mean_atoms):
    """Same pad sizes, alignment and RCM, the same seeded shuffle per
    epoch (train) or fixed order (val/test), and the same augmented
    batches, as the JAX BatchPipeline."""
    from cartnet_tpu.data.pipeline import BatchPipeline as JPipe
    from cartnet_tpu_torch.data.pipeline import BatchPipeline
    recs = tsyn.synthetic_dataset(7, mean_atoms=mean_atoms, adp=True, seed=2)
    for shuffle in (True, False):
        ours = BatchPipeline(recs, 2, shuffle=shuffle, seed=5)
        ref = JPipe(recs, 2, shuffle=shuffle, seed=5, prefetch=0)
        assert len(ours) == len(ref) == 4
        assert (ours.max_nodes, ours.max_edges, ours.edge_align) == (
            ref.max_nodes, ref.max_edges, ref.edge_align)
        assert ours.edge_align == (512 if mean_atoms == 120 else 0)
        for _ in range(2):  # two epochs: the shuffle advances per epoch
            for a, b in zip(ours, ref):
                for f in SHARED_FIELDS:
                    np.testing.assert_array_equal(
                        np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                        err_msg=f)
    # SO(3) augmentation (ported with the adpfix path): the same rotated
    # records from the same seed, one rotation per record and epoch
    ours = BatchPipeline(recs, 2, shuffle=True, augment=True, seed=5)
    ref = JPipe(recs, 2, shuffle=True, augment=True, seed=5, prefetch=0)
    firsts = []
    for _ in range(2):
        got = list(ours)
        for a, b in zip(got, ref):
            for f in SHARED_FIELDS:
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                    err_msg=f)
        firsts.append(got[0].cart_dir)
    assert not np.array_equal(firsts[0], firsts[1])


def test_make_batches_aligns_adp_scale():
    small = tsyn.synthetic_dataset(5, mean_atoms=20, adp=True, seed=8)
    big = tsyn.synthetic_dataset(4, mean_atoms=120, adp=True, seed=9)
    for recs, aligned in ((small, False), (big, True)):
        batches = tb.make_batches(recs, 2)
        assert len(batches) == -(-len(recs) // 2)
        for bt in batches:
            assert bt.num_nodes % 128 == 0 and bt.num_edges % 512 == 0
            assert bt.dst_rowptr[-1] == bt.num_edges
            real = bt.edge_mask.sum()
            inner_pads = (~bt.edge_mask[:np.flatnonzero(bt.edge_mask)[-1]]
                          ).sum()
            assert (inner_pads > 0) == aligned, (real, inner_pads)


def test_batch_to_device_tensors():
    recs = tsyn.synthetic_dataset(2, mean_atoms=20, adp=True, seed=1)
    bt = tb.make_batches(recs, 2)[0].to("cpu")
    assert bt.edge_dst.dtype == torch.int32
    assert bt.edge_mask.dtype == torch.bool
    assert bt.pos.dtype == torch.float32
    assert bt.dst_rowptr.shape == (bt.num_nodes + 1,)
    assert bt.adp_targets and bt.num_graphs == 2
