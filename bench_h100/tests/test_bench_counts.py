"""The yardstick's arithmetic at hand-worked shapes: model FLOPs, kernel
operations and bytes, a roofline share, and the traced stretch's busy
time and idle gaps."""

import types

import pytest

from bench_h100 import flops
from bench_h100.harness import cells, trace
from bench_h100.harness.readings import Readings, Window

SMALL = {"name": "cartnet", "dim_in": 8, "dim_rbf": 4, "num_layers": 1}


def test_cartnet_flops():
    # encoder 2*2*16 + 2*10*16*8 + 2*20*(7*16 + 16*8); one layer
    # 2*(2*10*8*16 + 20*8*16 + 2*20*8*8); head 2*10*(8*4 + 4*6)
    assert flops.forward(SMALL, n=10, e=20, g=2) == 12224 + 15360 + 1120
    assert flops.train_step(SMALL, 10, 20, 2) == 3 * 28704


def test_ecomformer_flops():
    model = {"name": "ecomformer", "dim_in": 8}
    # inputs 2*2*8 + 2*20*64; three convs 2*(4*10*64 + 20*64 + 4*10*64 +
    # 20*128 + 2*20*64); the block 2*10*(512 + 64 + 512) + 2*2*20*(64 +
    # 8*5120 + 5120); head 1120
    assert flops.forward(model, 10, 20, 2) == (2592 + 3 * 23040 + 3713280
                                               + 1120)


def _reader(name):
    return cells.metric_reader(name)


def test_kernel_costs():
    step = {"edges": 64, "nodes": 10}
    ops, nbytes = _reader("k5_roofline.train.cartnet").cost(step, SMALL, "float32")
    assert ops == 16 * 64 * 8 * 8
    assert nbytes == 64 * 333 + 3 * 8 * 4 + 10 * 136 + 4 * 64 * 8 + 256
    ops, nbytes = _reader("k8_roofline.train.ecomformer").cost(step, SMALL, "float32")
    assert ops == 6 * 64 * 8 * 5120 + 6 * 64 * 5120
    assert nbytes == 64 * 240 * 4 + 5120 * 8 * 8 + 5120 * 8
    ops, nbytes = _reader("k1_roofline.infer").cost(step, SMALL, "float32")
    assert ops == 8 * 64 * 8 * 8
    assert nbytes == 64 * (96 + 9) + 10 * 128 + (256 + 32) * 4


def _readings(kernels, steps, kind="train"):
    t = trace.Trace(window_s=1.0, busy_s=0.5, kernels=kernels, gaps={},
                    steps=steps)
    w = Window(kind=kind, seconds=1.0, steps=len(steps), replays=1,
               structures=4, flops=0.0, spans={})
    return Readings(config={"model": {**SMALL, "compute_dtype": "float32"},
                            "peak_flops": 67e12}, window=w, trace=t)


def test_roofline_share():
    step = {"edges": 1 << 20, "nodes": 10}
    r = _readings([("edge_bwd_tile_f32<false>", 2e-3),
                   ("edge_bwd_weights_f32<false>", 1e-3),
                   ("edge_bwd_reduce", 1e-3), ("other", 5.0)] * 2,
                  [step, step])
    share = _reader("k5_roofline.train.cartnet").read(r)
    ops, nbytes = _reader("k5_roofline.train.cartnet").cost(step, SMALL, "float32")
    bound = max(ops / 67e12, nbytes / 3.35e12)  # bytes bound it at d = 8
    assert bound == nbytes / 3.35e12
    assert share == pytest.approx(100 * 2 * bound / 8e-3)
    assert 0 < share <= 100
    # a capture that lost a call's kernels: their calls and time go alike
    r = _readings([("edge_bwd_tile_f32", 1e-3)] * 3, [step, step])
    assert _reader("k5_roofline.train.cartnet").read(r) == pytest.approx(
        100 * bound / 1e-3)
    # no such kernel in the trace, or no trace: nothing to read
    assert _reader("k8_roofline.train.ecomformer").read(r) is None
    r.trace = None
    assert _reader("k5_roofline.train.cartnet").read(r) is None


def test_stretch_busy_and_gaps():
    ev = lambda name, dev, a, b: (name, dev, name.startswith("bench."), a, b)
    events = [ev("bench.stretch", False, 0.0, 1.0),
              ev("k1", True, 0.1, 0.3), ev("k2", True, 0.25, 0.5),
              ev("bench.data_wait", False, 0.5, 0.6), ev("k3", True, 0.6, 0.7),
              ev("bench.chunk_feed", False, 0.7, 1.0),
              ev("spin_kernel", True, 0.95, 0.99),
              ev("bench.gpu_range", True, 0.0, 1.0)]
    t = trace.read(events, steps=[{}])
    assert t.window_s == 1.0
    assert t.busy_s == pytest.approx(0.5)
    assert [n for n, _ in t.kernels] == ["k1", "k2", "k3"]
    assert t.gaps["data_wait"][0] == pytest.approx(0.1)
    assert t.gaps["chunk_feed"][0] == pytest.approx(0.3)
    assert t.gaps["other"][0] == pytest.approx(0.1)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k2" and len(b["idle_gaps"]) == 3
    r = types.SimpleNamespace(trace=t, window=types.SimpleNamespace(
        kind="train"))
    assert _reader("device_idle_share.train.cartnet").read(r) == pytest.approx(50.0)
