"""The metrics that read the program's own spans and counters
(``harness/program_spans.py``, ``cartnet_tpu_torch.tracing``): a tiny
traced CPU run of a cell reports each of its own, finite and positive
(``chunk_wait_ms`` reads 0 on the CPU, whose chunk has no pinned copy to
wait for); an untraced run reports none; a program without the tracer
gives nothing and raises nothing."""

import builtins
import math

import pytest

from bench_h100.harness import cells, core
from conftest import tiny_run

PROGRAM = {
    "cartnet_adp.infer": ["to_device_ms.infer", "to_device_copies.infer",
                          "forward_host_ms.infer"],
    "cartnet_adp.train": ["batch_make_ms.train.cartnet",
                          "chunk_host_ms.train.cartnet",
                          "chunk_wait_ms.train.cartnet"],
}


def _program_metrics(bench, cell):
    return [m["name"] for m in cells.per_layer(bench, cell)
            if m["source"] in ("program_span", "program_counter")
            and m["name"] in sum(PROGRAM.values(), [])]


@pytest.mark.parametrize("cell", sorted(PROGRAM))
def test_traced_run_reports_the_program_spans(tmp_path, cell):
    r = tiny_run(cell, tmp_path, seconds=0.6, trace=True)
    out = core.execute(r)
    assert out["correct"] is True
    assert sorted(_program_metrics(r.bench, cell)) == sorted(PROGRAM[cell])
    for name in PROGRAM[cell]:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value), name
        if name.startswith("chunk_wait_ms"):
            assert value == 0.0  # the CPU chunk runs eagerly
        else:
            assert value > 0.0, name
    if cell == "cartnet_adp.infer":
        from cartnet_tpu_torch.data.schema import array_fields
        from cartnet_tpu_torch import runner
        cfg = cells.port_config(r.config, r.mix, r.job_seed)
        batch = next(iter(runner.pipelines(cfg, ([], [], _pool(r)))[2]))
        assert (out["metrics"]["to_device_copies.infer"]["value"]
                == len(array_fields(batch)))


def _pool(r):
    from bench_h100.harness import crystals
    cfg = cells.port_config(r.config, r.mix, r.job_seed)
    return crystals.make_pool(r.mix["pool"], cfg.data.radius,
                              cfg.data.max_neighbors, r.seed, r.cache_dir)


@pytest.mark.parametrize("cell", sorted(PROGRAM))
def test_untraced_run_reports_none(tmp_path, cell):
    out = core.execute(tiny_run(cell, tmp_path, seconds=0.3))
    assert not set(out["metrics"]) & set(PROGRAM[cell])


def test_program_without_the_tracer_gives_nothing(tmp_path, monkeypatch):
    """The parent program has no ``cartnet_tpu_torch.tracing``: every
    reader returns None there."""
    r = tiny_run("cartnet_adp.infer", tmp_path, seconds=0.4, trace=True)
    out = core.execute(r)
    assert set(PROGRAM["cartnet_adp.infer"]) <= set(out["metrics"])
    real_import = builtins.__import__

    def no_tracer(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "cartnet_tpu_torch" and "tracing" in (fromlist or ()):
            raise ImportError("no tracer")
        return real_import(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    from bench_h100.harness import readings
    for cell, names in PROGRAM.items():
        fake = readings.Readings(config=r.config, window=readings.Window(
            kind=cell.rsplit(".", 1)[1], seconds=1.0, steps=1, replays=1,
            structures=1, flops=1.0, spans={}), trace=object())
        for name in names:
            assert cells.metric_reader(name).read(fake) is None, name
