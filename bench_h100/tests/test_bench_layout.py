"""BENCHMARK.json against the benchmark's contract, every file a cell
names found by name, and the result line's keys."""

import json
import os
import re

import pytest

from bench_h100.harness import cells, core

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and not (
    set(s) & set("\t\n\r"))


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    return cells.benchmark()


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    assert all(TEXT(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) for p in bench["paths"])
    for w in bench["command"]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in bench["paths"])
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files) and 1 <= len(files) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert TEXT(c["source"]) and TEXT(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        conf = cells.config(bench, c["name"])
        assert set(conf["reduced"]) == set(c["reduced"])
        assert conf["name"] == c["name"]
        cells.reference_model(conf)


def test_workloads(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and TEXT(w["why"])
        core.driver_module(cells.mix(w["traffic"])["driver"])
        assert cells.limits(w["name"])


def test_metrics(bench):
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    by_name = {m["name"]: m for m in e2e}
    assert "setup_s" in by_name and by_name["setup_s"]["bound"] <= 0.25
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT(m["layer"]) and m["moves"] in by_name
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        reader = cells.metric_reader(m["name"])
        assert reader.UNIT == m["unit"]
        if m in layer:
            assert reader.MOVES == m["moves"]
    for w in bench["workloads"]:
        reports = {m["name"] for m in cells.end_to_end(bench, w["name"])}
        assert "setup_s" in reports and len(reports) >= 2
        per = cells.per_layer(bench, w["name"])
        assert per and all(m["moves"] in reports for m in per)


def test_one_layer_name_per_layer(bench):
    """Metrics of one layer give the same ``layer``, letter for letter."""
    prefix = {"k": "kernels", "mfu": "model", "device": "device"}
    seen = {}
    for m in bench["per_layer"]:
        key = next((v for k, v in prefix.items() if m["name"].startswith(k)),
                   m["name"])
        seen.setdefault(key, set()).add(m["layer"])
    assert all(len(v) == 1 for v in seen.values())


@pytest.mark.parametrize("cell,trace", [("cartnet_adp.train", False),
                                        ("cartnet_adp.train", True),
                                        ("cartnet_adp.infer", False)])
def test_result_line(tmp_path, cell, trace):
    from conftest import tiny_run
    r = tiny_run(cell, tmp_path, seconds=0.6 if trace else 0.3,
                 trace=trace)
    out = core.execute(r)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] * trace + ["compared"]
    assert list(out) == want
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["compared"]) == set(r.limits)
    entries = (cells.per_layer(r.bench, cell) if trace
               else cells.end_to_end(r.bench, cell))
    assert set(out["metrics"]) <= {m["name"] for m in entries}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in entries}
    json.dumps(core.finite(out))
