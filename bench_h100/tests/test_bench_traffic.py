"""The pool and the batch order: deterministic per seed, the same shapes
for every seed, and re-derived by the reference as the program's
pipeline draws them."""

import numpy as np

from bench_h100.harness import cells, crystals
from bench_h100.reference import common

POOL = {"count": 12, "mean_atoms": 40, "spread": 0.3, "min_atoms": 4,
        "density": 0.1, "geometry_seed": 5}


def test_pool_is_deterministic_per_seed(tmp_path):
    a = crystals.make_pool(POOL, 5.0, None, 2**31 + 3, str(tmp_path))
    b = crystals.make_pool(POOL, 5.0, None, 2**31 + 3, None)
    c = crystals.make_pool(POOL, 5.0, None, 2**31 + 4, str(tmp_path))
    for x, y, z in zip(a, b, c):
        for k in x:
            assert np.array_equal(x[k], y[k]), k
        assert np.array_equal(x["edge_src"], z["edge_src"])
        assert not np.array_equal(x["y"], z["y"])
    assert [len(r["z"]) for r in a] == crystals.atom_counts(POOL)


def test_copies_share_geometry_and_differ_in_content():
    """A pool of ``copies`` draws: each structure's geometry repeated, and
    no two records alike (species, temperature and targets differ)."""
    pool = {**POOL, "copies": 3}
    recs = crystals.make_pool(pool, 5.0, None, 2**31 + 3, None)
    n = POOL["count"]
    assert len(recs) == 3 * n
    assert crystals.make_pool(POOL, 5.0, None, 2**31 + 3, None)[0][
        "temperature"] == recs[0]["temperature"]
    for i in range(n):
        a, b, c = recs[i], recs[i + n], recs[i + 2 * n]
        assert a["pos"] is b["pos"] and a["edge_src"] is c["edge_src"]
        assert not np.array_equal(a["y"], b["y"])
        assert not np.array_equal(b["z"], c["z"])
    temps = [r["temperature"] for r in recs]
    assert len(set(temps)) == len(temps)


def test_density_sets_the_edges_per_atom():
    """Edges per atom near 4/3 pi r^3 density at the mixes' density."""
    recs = crystals.make_pool({**POOL, "count": 4, "mean_atoms": 150},
                              5.0, None, 1, None)
    per_atom = (sum(len(r["edge_src"]) for r in recs)
                / sum(len(r["z"]) for r in recs))
    want = 4.0 / 3.0 * np.pi * 5.0 ** 3 * POOL["density"]
    assert abs(per_atom / want - 1) < 0.1


def test_same_pads_for_every_seed(tmp_path):
    from cartnet_tpu_torch import runner
    bench = cells.benchmark()
    conf = cells.config(bench, "cartnet_adp")
    for mix_name, split in (("train_fused16", 0), ("infer_sweep4", 2)):
        mix = cells.mix(mix_name)
        pool = {**mix["pool"], "count": 24}
        pads = set()
        for seed in (1, 2**31 + 11):
            cfg = cells.port_config(conf, mix, seed)
            recs = crystals.make_pool(pool, 5.0, None, seed, str(tmp_path))
            splits = [[], [], []]
            splits[split] = recs
            p = runner.pipelines(cfg, tuple(splits))[split]
            pads.add((p.max_nodes, p.max_edges))
        assert len(pads) == 1


def test_radius_graph_copy_matches_the_program():
    from cartnet_tpu_torch.data.radius_graph import radius_graph_pbc
    rng = np.random.default_rng(0)
    for n, cap in ((30, None), (45, 25)):
        cell = np.eye(3) * 9.0 + rng.uniform(-0.9, 0.9, (3, 3)) * (
            1 - np.eye(3))
        pos = rng.uniform(0, 1, (n, 3)) @ cell
        want = radius_graph_pbc(pos, cell, 5.0, cap, backend="numpy")
        got = crystals.radius_graph_pbc(pos, cell, 5.0, cap)
        for w, g in zip(want, got):
            assert np.array_equal(w, g)


def test_reference_rederives_the_pipelines_batches():
    """The program's train pipeline (shuffle, rotation, RCM relabelling,
    pads) against the reference's plain re-derivation of the same seed:
    the same crystals in each batch, rotated alike, for two passes."""
    from cartnet_tpu_torch.data.pipeline import BatchPipeline
    recs = crystals.make_pool(POOL, 5.0, None, 9, None)
    seed = 2**32 + 5
    pipe = BatchPipeline(recs, 4, shuffle=True, augment=True, seed=seed,
                         edge_align=0)
    got = [b for _ in range(2) for b in pipe]
    want = common.training_batches(recs, seed, 4, len(got), augment=True)
    assert len(want) == len(got)
    for b, w in zip(got, want):
        gid, mask = np.asarray(b.graph_id), np.asarray(b.node_mask)
        for s, rec in enumerate(w):
            rows = np.flatnonzero(mask & (gid == s))
            assert np.array_equal(np.sort(np.asarray(b.z)[rows]),
                                  np.sort(rec["z"]))
            assert np.allclose(np.asarray(b.cell)[s], rec["cell"])
        emask = np.asarray(b.edge_mask)
        assert np.allclose(
            np.sort(np.asarray(b.cart_dir)[emask], axis=0),
            np.sort(np.concatenate([r["cart_dir"] for r in w]), axis=0))
