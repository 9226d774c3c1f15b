"""The port's Jarvis / Materials Project ingest vs the JAX package: the
target filter and the seed-123 split, records and whole datasets built
from the committed sample (tests/fixtures/jarvis_sample.json, 100 records
in the dft_3d_2021 schema), the native radius graph, the npz cache read
both ways, the megnet bulk/shear pickles, the archive checks and the
download's resume paths (urlopen mocked: nothing reaches the network).

Records and datasets are compared bitwise, with both packages on the
numpy radius graph (the JAX package's through a patched
``radius_graph_pbc`` name in its jarvis module). The port's native graph
is bitwise the JAX package's native graph (same source arithmetic, same
g++ flags, same machine; the JAX extension is built into a temporary
directory for the comparison); against the numpy path its src/dst are
equal and dist/dir agree within tests/test_native.py's tolerances (dist
1e-6, dir 1e-5 relative, 1e-6 absolute): the C++ path multiplies by
1 / dist where numpy divides.
"""

import functools
import importlib.util
import json
import logging
import pickle
import shutil
import subprocess
import sysconfig
import urllib.error
import zipfile
from pathlib import Path

import numpy as np
import pytest

from cartnet_tpu.data import jarvis as JJ
from cartnet_tpu.data.radius_graph import brute_force_radius_graph as j_brute
from cartnet_tpu.data.radius_graph import radius_graph_pbc as j_graph
from cartnet_tpu_torch import cli
from cartnet_tpu_torch import native
from cartnet_tpu_torch.data import jarvis as TJ
from cartnet_tpu_torch.data import radius_graph as trg

SAMPLE = Path(__file__).parent / "fixtures" / "jarvis_sample.json"
TARGET = "formation_energy_peratom"
FIELDS = ("z", "pos", "cell", "edge_src", "edge_dst", "cart_dist",
          "cart_dir", "y")


def _stage(root: Path) -> Path:
    """The sample as ``<root>/raw/dft_3d_2021.json``."""
    (root / "raw").mkdir(parents=True)
    shutil.copy(SAMPLE, root / "raw" / "dft_3d_2021.json")
    return root


def _same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for f in FIELDS:
            x, y = np.asarray(ra[f]), np.asarray(rb[f])
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture
def jax_numpy_graphs(monkeypatch):
    """The JAX package's ingest on its numpy radius graph."""
    monkeypatch.setattr(JJ, "radius_graph_pbc",
                        functools.partial(j_graph, backend="numpy"))


def test_sample_filter_and_split_literals(tmp_path):
    raw = TJ.load_raw("jarvis", str(_stage(tmp_path)))  # the rename
    assert len(raw) == 100
    for target, n in ((TARGET, 100), ("optb88vdw_bandgap", 88),
                      ("mbj_bandgap", 62), ("ehull", 81)):
        dat, targets = TJ.filter_by_target(raw, target)
        ref = JJ.filter_by_target(raw, target)
        assert len(dat) == len(targets) == n
        assert targets == ref[1] and [d["jid"] for d in dat] == \
            [d["jid"] for d in ref[0]]
    tr, va, te = TJ.split_123(100)
    assert (len(tr), len(va), len(te)) == (80, 10, 10)
    assert [int(i) for i in tr[:5]] == [87, 29, 63, 50, 84]
    assert [int(i) for i in va[:3]] == [86, 31, 89]
    assert [int(i) for i in te[:3]] == [71, 68, 48]
    for n in (10, 33, 100, 1001, 55713):
        assert TJ.split_123(n) == JJ.split_123(n), n


@pytest.mark.parametrize("mn", [-1, 25])
def test_records_and_dataset_match_jax(tmp_path, jax_numpy_graphs, mn):
    raw = json.loads(SAMPLE.read_text())
    cap = mn if mn > 0 else None
    for item in raw[:10]:
        ours = TJ.atoms_to_record(item["atoms"], item[TARGET], 5.0, cap,
                                  backend="numpy")
        ref = JJ.atoms_to_record(item["atoms"], item[TARGET], 5.0, cap)
        _same_records([ours], [ref])
    a = TJ.build_dataset("jarvis", TARGET, str(_stage(tmp_path / "t")),
                         5.0, mn, backend="numpy")
    b = JJ.build_dataset("jarvis", TARGET, str(_stage(tmp_path / "j")),
                         5.0, mn)
    assert [len(s) for s in a] == [80, 10, 10]
    for sa, sb in zip(a, b):
        _same_records(sa, sb)
    name = f"jarvis_5.0_{mn}_{TARGET}_123.npz_dir"
    assert (tmp_path / "t" / name / "train" / "data.npz").is_file()
    assert (tmp_path / "j" / name).is_dir()
    lim = TJ.build_dataset("jarvis", TARGET, str(_stage(tmp_path / "l")),
                           5.0, mn, limit=16, backend="numpy")
    assert [len(s) for s in lim] == [16, 2, 2]
    _same_records(lim[0], a[0][:16])


def _cells(n: int):
    rng = np.random.default_rng(4)
    for _ in range(n):
        k = int(rng.integers(1, 30))
        cell = np.eye(3) * rng.uniform(3, 8) + rng.uniform(-.4, .4, (3, 3))
        yield rng.uniform(0, 1, (k, 3)) @ cell, cell


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native extension built from its source with its
    own g++ command, into a temporary directory (its build beside the
    source is left to the JAX package's tests, which may run at the same
    time)."""
    import cartnet_tpu.native as jn
    out = tmp_path_factory.mktemp("jax_native") / (
        "_cartnet_native"
        + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
         str(Path(jn.__file__).parent / "radius_graph.cpp"), "-o",
         str(out)], check=True, capture_output=True)
    spec = importlib.util.spec_from_file_location("_cartnet_native", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_native_graph_matches_jax_native_and_numpy(jax_native):
    raw = json.loads(SAMPLE.read_text())
    structs = [(np.asarray(r["atoms"]["coords"], np.float64),
                np.asarray(r["atoms"]["lattice_mat"], np.float64))
               for r in raw[:20]] + list(_cells(10))
    for pos, cell in structs:
        for cap in (None, 25, 4):
            ours = trg.radius_graph_pbc(pos, cell, 5.0, cap,
                                        backend="native")
            ref = jax_native.radius_graph_pbc(pos, cell, 5.0, cap or -1)
            for x, y in zip(ours, ref):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            s, d, dist, vec = trg.radius_graph_pbc(pos, cell, 5.0, cap,
                                                   backend="numpy")
            np.testing.assert_array_equal(ours[0], s)
            np.testing.assert_array_equal(ours[1], d)
            np.testing.assert_allclose(ours[2], dist, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(ours[3], vec, rtol=1e-5, atol=1e-6)
    assert native.LIB.is_file() and native.LIB.parent.name == "_build"


def test_native_graph_against_brute_force():
    pos, cell = next(_cells(1))
    pos = pos[:5]
    got = trg.radius_graph_pbc(pos, cell, 4.0, backend="native")
    want = trg.brute_force_radius_graph(pos, cell, 4.0, rep=3)
    key = lambda g: sorted(zip(g[0].tolist(), g[1].tolist(),
                               np.round(g[2], 5).tolist()))
    assert key(got) == key(want) and len(got[0]) > 0
    for x, y in zip(want, j_brute(pos, cell, 4.0, rep=3)):
        np.testing.assert_array_equal(x, y)


def test_backends_and_fallback(monkeypatch, caplog):
    pos, cell = next(_cells(1))
    with pytest.raises(ValueError, match="backend"):
        trg.radius_graph_pbc(pos, cell, 5.0, backend="cuda")
    with pytest.raises(ValueError, match="periodicity"):
        trg.radius_graph_pbc(pos, cell, 5.0, pbc=(True, True, False),
                             backend="native")
    slab = trg.radius_graph_pbc(pos, cell, 5.0, pbc=(True, True, False))
    jslab = j_graph(pos, cell, 5.0, pbc=(True, True, False))
    for x, y in zip(slab, jslab):
        np.testing.assert_array_equal(x, y)
    # a failed build: "native" raises, "auto" warns once and takes numpy
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_FAILED", None)
    monkeypatch.setattr(native, "build", lambda force=False: (_ for _ in
                        ()).throw(RuntimeError("g++ failed")))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        trg.radius_graph_pbc(pos, cell, 5.0, backend="native")
    with caplog.at_level(logging.WARNING):
        a = trg.radius_graph_pbc(pos, cell, 5.0)
        b = trg.radius_graph_pbc(pos, cell, 5.0)
    assert sum("native radius graph unavailable" in r.message
               for r in caplog.records) == 1
    want = trg.radius_graph_pbc(pos, cell, 5.0, backend="numpy")
    for x, y, z in zip(a, b, want):
        np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(y, z)


def test_cache_is_read_both_ways(tmp_path, jax_numpy_graphs):
    """Each package reads the npz cache the other wrote (the raw payload
    is gone by then, so nothing is rebuilt)."""
    for writer, reader in ((TJ, JJ), (JJ, TJ)):
        root = _stage(tmp_path / writer.__name__)
        kw = dict(backend="numpy") if writer is TJ else {}
        built = writer.build_dataset("jarvis", TARGET, str(root), 5.0, 25,
                                     **kw)
        shutil.rmtree(root / "raw")
        read = reader.build_dataset("jarvis", TARGET, str(root), 5.0, 25)
        for a, b in zip(built, read):
            _same_records(a, b)


def test_megnet_bulk_shear_pickles(tmp_path, jax_numpy_graphs):
    rng = np.random.default_rng(1)

    def entry(val):
        n = int(rng.integers(2, 5))
        return {"atoms": {"lattice_mat": (np.eye(3) * 5).tolist(),
                          "coords": rng.uniform(0, 5, (n, 3)).tolist(),
                          "elements": ["Si"] * n, "cartesian": True},
                "bulk modulus": val}

    splits = {"train": [entry(float(i)) for i in range(6)] + [entry(None)],
              "val": [entry(10.0), entry(float("nan"))],
              "test": [entry(20.0), entry("na"), entry(21.0)]}
    for root in ("t", "j"):
        (tmp_path / root).mkdir()
        for sname, entries in splits.items():
            with open(tmp_path / root / f"bulk_megnet_{sname}.pkl",
                      "wb") as f:
                pickle.dump(entries, f)
    tr, va, te = TJ.build_dataset("megnet", "bulk modulus",
                                  str(tmp_path / "t"), backend="numpy")
    ref = JJ.build_dataset("megnet", "bulk modulus", str(tmp_path / "j"))
    assert (len(tr), len(va), len(te)) == (6, 1, 2)
    assert [float(r["y"]) for r in tr] == [0., 1., 2., 3., 4., 5.]
    assert [float(r["y"]) for r in te] == [20.0, 21.0]
    for a, b in zip((tr, va, te), ref):
        _same_records(a, b)
    again = TJ.build_dataset("megnet", "bulk modulus", str(tmp_path / "t"))
    _same_records(again[0], tr)
    with pytest.raises(FileNotFoundError, match="figshare"):
        TJ.build_dataset("megnet", "shear modulus", str(tmp_path / "t"))


def _zip(tmp_path: Path) -> Path:
    zp = tmp_path / "dft_3d_2021.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.writestr("d.json", json.dumps([{"a": 1}]))
    return zp


def test_verify_archive(tmp_path, monkeypatch):
    zp = _zip(tmp_path)
    assert TJ.verify_archive("dft_3d_2021", str(zp)) == "crc-only"
    monkeypatch.setenv("CARTNET_FIGSHARE_SHA256_DFT_3D_2021",
                       TJ._sha256(str(zp)))
    assert TJ.verify_archive("dft_3d_2021", str(zp)) == "sha256-ok"
    assert TJ._sha256(str(zp)) == JJ._sha256(str(zp))
    monkeypatch.setenv("CARTNET_FIGSHARE_SHA256_DFT_3D_2021", "00" * 32)
    with pytest.raises(IOError, match="checksum mismatch"):
        TJ.verify_archive("dft_3d_2021", str(zp))
    monkeypatch.delenv("CARTNET_FIGSHARE_SHA256_DFT_3D_2021")
    data = bytearray(zp.read_bytes())
    data[40] ^= 0xFF  # a payload byte: the stored CRC fails
    bad = tmp_path / "bad.zip"
    bad.write_bytes(bytes(data))
    with pytest.raises((IOError, zipfile.BadZipFile)):
        TJ.verify_archive("dft_3d_2021", str(bad))
    assert TJ.FIGSHARE_URLS == JJ.FIGSHARE_URLS
    assert TJ.PICKLE_TARGETS == JJ.PICKLE_TARGETS


def test_download_unpacks_a_placed_zip_without_fetching(tmp_path,
                                                        monkeypatch):
    raw = tmp_path / "raw"
    raw.mkdir()
    shutil.move(str(_zip(tmp_path)), raw / "dft_3d_2021.zip")

    def no_network(*a, **k):
        raise AssertionError("urlopen called")

    monkeypatch.setattr("urllib.request.urlopen", no_network)
    assert TJ.load_raw("jarvis", str(tmp_path)) == [{"a": 1}]
    assert (raw / "dft_3d_2021.json").is_file()
    with pytest.raises(ValueError, match="unknown figshare"):
        TJ.load_raw("nope", str(tmp_path))


def test_fetch_resume_paths(tmp_path, monkeypatch):
    """416 on a complete .part promotes it; a 206 appends from the .part's
    offset and checks the total length; a short stream raises."""
    dest, part = tmp_path / "x.zip", tmp_path / "x.zip.part"
    part.write_bytes(b"PAYLOAD")

    def range_done(req, timeout=0):
        raise urllib.error.HTTPError(req.full_url, 416, "range", {}, None)

    monkeypatch.setattr("urllib.request.urlopen", range_done)
    TJ._fetch_with_resume("http://example.invalid/x.zip", str(dest))
    assert dest.read_bytes() == b"PAYLOAD" and not part.exists()

    seen = {}

    def resp(status, length, chunks):
        class Resp:
            headers = {"Content-Length": length}

            def read(self, n):
                return chunks.pop(0) if chunks else b""
        r = Resp()
        r.status = status
        return r

    dest, part = tmp_path / "y.zip", tmp_path / "y.zip.part"
    part.write_bytes(b"0123")

    def partial(req, timeout=0):
        seen["range"] = req.get_header("Range")
        return resp(206, "4", [b"4567"])

    monkeypatch.setattr("urllib.request.urlopen", partial)
    TJ._fetch_with_resume("http://example.invalid/y.zip", str(dest))
    assert seen["range"] == "bytes=4-"
    assert dest.read_bytes() == b"01234567"

    dest = tmp_path / "z.zip"
    monkeypatch.setattr("urllib.request.urlopen",
                        lambda req, timeout=0: resp(200, "10", [b"abc"]))
    with pytest.raises(IOError, match="incomplete download"):
        TJ._fetch_with_resume("http://example.invalid/z.zip", str(dest))
    assert (tmp_path / "z.zip.part").read_bytes() == b"abc"


def test_verify_ingest_reports_the_split(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    root = _stage(tmp_path / "d")
    with caplog.at_level(logging.INFO):
        out = cli.main(["--dataset", "jarvis", "--dataset_path", str(root),
                        "--verify_ingest"])
    assert out == {"raw": 100, "usable": 100, "split": (80, 10, 10)}
    assert any("verify_ingest OK" in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="figshare"):
        cli.main(["--dataset", "adpfix", "--verify_ingest"])
