"""Cells by name: ``BENCHMARK.json``, and for a cell its configuration
(``configs/<config>.json``), traffic mix (``traffic/<mix>.json``), limits
(``limits/<cell>.json``), metric readers (``metrics/<metric>.py``) and
plain reference (``reference/<module>.py``). Nothing here is specific to
one cell: a cell is added by adding files and entries."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return _json(os.path.join(root, entry["file"]))


def mix(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell: str) -> Dict[str, float]:
    return _json(os.path.join(HERE, "limits", f"{cell}.json"))


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports (the
    contract's rule for an entry without ``workloads``, which a later
    benchmark may add and which this file, fixed once accepted, has to
    follow already)."""
    moves = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def metric_reader(name: str):
    """``metrics/<name>.py`` as a module: ``UNIT``, ``MOVES`` and
    ``read(readings) -> float | None``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_h100_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_model(cfg: dict):
    """The plain reference class the configuration names."""
    mod = importlib.import_module(f"bench_h100.reference.{cfg['reference']}")
    return getattr(mod, cfg["reference_class"])


def port_config(cfg: dict, mix_: dict, seed: int):
    """The program's ``Config`` for a configuration file under a mix (the
    mix may set the batch size and the fused steps)."""
    import torch
    from cartnet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                          OptimConfig)
    model = {k: getattr(torch, v) if k.endswith("_dtype") else v
             for k, v in cfg["model"].items()}
    data = dict(cfg["data"])
    optim = dict(cfg["optim"])
    if "batch_size" in mix_:
        data["batch_size"] = mix_["batch_size"]
    if "fused_steps" in mix_:
        optim["fused_steps"] = mix_["fused_steps"]
    return Config(model=ModelConfig(**model), data=DataConfig(**data),
                  optim=OptimConfig(**optim), seed=seed,
                  name=cfg["name"], run_dir=os.path.join(CACHE, "run"))
