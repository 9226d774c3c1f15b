"""``run.py`` as the check runs it: no card, no result; a checkout without
the program, no result; JAX loaded by the window's end, no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_h100.harness import cells

ROOT = cells.ROOT
sys.path.insert(0, os.path.join(ROOT, "bench_h100"))
import run  # noqa: E402


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "cartnet_adp.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_jax_loaded_no_result(monkeypatch, capsys):
    import torch
    from bench_h100.harness import core
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(core, "execute", lambda r: {"correct": True})
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    rc = run.main(["--workload", "cartnet_adp.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert rc == 3 and captured.out == "" and "jaxlib" in captured.err


def test_benchmark_alone_no_result(tmp_path):
    bench = cells.benchmark()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in bench["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns(".cache",
                                                      "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable] + bench["command"][1:]
        + ["--workload", "cartnet_adp.train", "--seed", "1", "--seconds",
           "1", "--trace", "0"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
