"""The f32 passes of K1, K5/K6, K7 and K8 (SIMT GEMM tiles on the CUDA
cores) and chip_smoke.py's bf16 gradient gate, on the CPU.

- The Python mirrors of the f32 passes' shared memory (``bwd_smem_plan``,
  ``fwd_smem_plan``, ``fwd_smem_bytes``) are the layout of
  csrc/simt_gemm.cuh, read from its constants (K7's tile pass adds its
  threads' output sums, read from tp_contract_fwd.cu), and fit an SM at the
  blocks an SM the sources compile for, at every width, for K1, K5/K6 (one
  plan serves the merged entry point), K7 l1 / l2 and K8 l1 / l2.
- The CUDA launches of each host function in the sources are the ones
  ``chip_smoke.LAUNCHES`` states for the wrapper in that dtype (three for
  K5/K6 and K8 in f32, two for K1 and K7 in f32, one for K1 and K7 in
  bf16, two for K4 in both, each matching one of its name pieces), and
  the docstrings of the wrappers say so.
- ``chip_smoke.bf16_grad_gate`` on synthetic gradients: one parameter far
  off by chance inside a layer that is otherwise in line passes (the
  per-parameter rule it replaced fails it), and so does honest noise; a
  consistent 5% error over a layer fails, so does an error hidden in
  rounding noise larger than the gradient, two gradients swapped, and a
  non-finite gradient.

The kernels themselves need the card (``chip_smoke.py``).
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from cartnet_tpu_torch.ops.kernels import _build
from cartnet_tpu_torch.ops.kernels import edge_kernels as ek
from cartnet_tpu_torch.ops.kernels import tp_kernels as k7

SMEM_LIMIT = 232448
SM_SMEM = 233472  # shared memory of one SM (228 KB); 1 KB a block reserved
WIDTHS = (128, 256, 384, 512)


def _simt_smem() -> int:
    """Bytes of the f32 passes' block, from simt_gemm.cuh's constants."""
    text = (_build.CSRC / "simt_gemm.cuh").read_text()
    m = re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+);", text)
    bm, bn, bk = map(int, m.groups())
    pad = re.search(r"constexpr int LDA = BM \+ (\d+), LDB = BN \+ (\d+);",
                    text)
    pa, pb = map(int, pad.groups())
    assert "SMEM = sizeof(float) * 2 * (A_FLOATS + B_FLOATS)" in text
    assert "constexpr int THREADS = 128;" in text
    return 4 * 2 * (bk * (bm + pa) + bk * (bn + pb))


def _constant(source: str, name: str) -> int:
    """``constexpr int name = n;`` of a CUDA source."""
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _k7_smem() -> int:
    """K7's f32 tile pass: the SIMT tile and each of its 128 threads'
    OUT_SUMS output sums, as tp_contract_fwd.cu states it."""
    text = (_build.CSRC / "tp_contract_fwd.cu").read_text()
    assert re.search(r"F32_SMEM = simt::SMEM \+ sizeof\(float\) \* OUT_SUMS "
                     r"\*\s+simt::THREADS;", text)
    return _simt_smem() + 4 * _constant("tp_contract_fwd.cu",
                                        "OUT_SUMS") * 128


@pytest.mark.parametrize("kernel", ["K1", "K5", "K6", "K7 l1", "K7 l2",
                                    "K8 l1", "K8 l2"])
@pytest.mark.parametrize("d", WIDTHS)
def test_f32_smem_plans_are_the_simt_layout(d, kernel):
    want, blocks = _simt_smem(), 4
    if kernel.startswith("K8"):
        plan = k7.bwd_smem_plan(d, kernel.endswith("l2"))
        got = (plan["tile_f32"], plan["weights_f32"])
    elif kernel == "K1":  # both passes run the bare tile
        got = (ek.fwd_smem_plan(d, False)["total"],) * 2
        blocks = _constant("edge_phase_fwd.cu", "F32_BLOCKS")
        assert ek.F32_BLOCKS == blocks
    elif kernel.startswith("K7"):  # the tile pass; the reduce takes none
        want = _k7_smem()
        got = (k7.fwd_smem_bytes(d, False, kernel.endswith("l2")),) * 2
        blocks = _constant("tp_contract_fwd.cu", "F32_BLOCKS")
        assert (k7.F32_BLOCKS, k7.F32_OUT_SUMS) == (
            blocks, _constant("tp_contract_fwd.cu", "OUT_SUMS"))
    else:  # K6 runs K5's passes (the MERGED template flag)
        plan = ek.bwd_smem_plan(d, False)
        got = (plan["tile"], plan["weights"])
    assert got == (want, want)
    # room for the blocks an SM the passes are compiled for
    assert blocks == 4 and blocks * (want + 1024) <= SM_SMEM
    assert want <= SMEM_LIMIT


def _launched(source: str, function: str) -> list:
    """Kernel names launched in one host function of a CUDA source (through
    ``launch(kernel<...>`` or ``kernel<<<`` / ``kernel<...><<<``)."""
    text = (_build.CSRC / source).read_text()
    start = re.search(rf"\ncudaError_t {function}\(", text).start()
    body = text[start:text.index("\n}\n", start)]
    return (re.findall(r"launch\((\w+)<", body)
            + re.findall(r"(\w+)(?:<\w+>)?\s*<<<", body))


@pytest.mark.parametrize("source,function,wrapper,dtype,count", [
    ("tp_contract_bwd.cu", "run_f32", "tp_contract_bwd", "f32", 3),
    ("edge_phase_bwd.cu", "launch_f32", "edge_phase_bwd", "f32", 3),
    ("edge_phase_bwd.cu", "launch_f32", "edge_phase_merged_bwd", "f32", 3),
    ("tp_contract_fwd.cu", "run_f32", "tp_contract_fwd", "f32", 2),
    ("tp_contract_fwd.cu", "run_bf16", "tp_contract_fwd", "bf16", 1),
    ("sigma_segsum_bwd.cu", "run", "sigma_segsum_bwd", "bf16", 2),
    ("sigma_segsum_bwd.cu", "run", "sigma_segsum_bwd", "f32", 2),
    ("edge_phase_fwd.cu", "launch_f32", "edge_phase_fwd", "f32", 2),
    ("edge_phase_fwd.cu", "launch_tc", "edge_phase_fwd", "bf16", 1),
    ("sigma_segsum_fwd.cu", "run", "sigma_segsum_fwd", "bf16", 1),
    ("sigma_segsum_fwd.cu", "run", "sigma_segsum_fwd", "f32", 1),
    ("segment_sum_csr.cu", "run", "segment_sum_csr", "bf16", 1),
    ("segment_sum_csr.cu", "run", "segment_sum_csr", "f32", 1),
])
def test_f32_launches_match_chip_smoke(source, function, wrapper, dtype,
                                       count):
    names = _launched(source, function)
    if source == "edge_phase_bwd.cu":  # the reduce, through launch_reduce
        assert "launch_reduce(p, n_tiles, stream)" in (
            _build.CSRC / source).read_text()
        names.append("edge_bwd_reduce")
    stated = cs.LAUNCHES[wrapper][dtype]
    assert len(names) == sum(stated.values()) == count, names
    for piece, n in stated.items():
        assert sum(piece in name for name in names) == n, (piece, names)
    # no piece of one dtype's kernels names a kernel of the other's
    other = cs.LAUNCHES[wrapper]["bf16" if dtype == "f32" else "f32"]
    if other != stated:
        assert not any(piece in name for piece in other for name in names)


def test_wrappers_state_three_launches_in_f32():
    assert "One call is three CUDA launches" in k7.__doc__
    assert "two in f32" not in k7.__doc__
    assert "three launches per call" in ek.__doc__


def test_forward_wrappers_state_their_launches():
    assert "bf16: one CUDA launch a call" in k7.__doc__
    assert "f32: two CUDA launches a call" in k7.__doc__
    assert "bf16 edges: one\nCUDA launch a call" in ek.__doc__
    assert "f32 edges: two" in ek.__doc__


# ------------------------------------------------------------ the F3 gate

NAMES = ["encoder.w", "encoder.b"] + [
    f"layers.{i}.{p}" for i in range(2)
    for p in ("MLP_aggr.0.weight", "MLP_aggr.2.weight", "MLP_gate.0.weight",
              "MLP_gate.0.bias", "norm.weight")] + ["head.w"]
TOL = cs.PRED_TOL


def _t(xs):
    return [torch.tensor(x, dtype=torch.float32) for x in xs]


def _grads(seed: int, noise: float, common: float = 0.0):
    """f32 reference gradients, and the kernels', the plain versions' and a
    second plain implementation's bf16-like gradients around them: noise
    ``common`` to all three (the rounding noise of the state) plus noise
    ``noise`` of each (numpy, from ``seed``) -> (ref, plain, got, alt)."""
    rng = np.random.default_rng(seed)
    shapes = {n: (16, 16) if n.endswith("weight") or n.endswith(".w")
              else (16,) for n in NAMES}
    ref = [rng.normal(size=shapes[n]) for n in NAMES]
    bf = [r + common * rng.normal(size=r.shape) for r in ref]
    path = lambda: [b + noise * rng.normal(size=b.shape) for b in bf]
    return _t(ref), _t(path()), _t(path()), _t(path())


def _gate(ref, plain, got, alt):
    return cs.bf16_grad_gate(NAMES, got, plain, alt, ref, TOL)


def _per_param_failed(ref, plain, got):
    k = cs.grad_errors(NAMES, got, ref)
    p = cs.grad_errors(NAMES, plain, ref)
    return [n for n in NAMES if k[n] > 2 * p[n] + TOL]


def test_gate_passes_one_parameter_off_by_chance():
    """All paths carry their own rounding noise (8%), except that the plain
    path lands near the f32 gradient by chance on one parameter (0.5%), as
    in the failure that retired the per-parameter rule: the kernels' own
    distance there is their layer's usual one."""
    ref, plain, got, alt = _grads(0, 0.08)
    i = NAMES.index("layers.1.MLP_aggr.2.weight")
    rng = np.random.default_rng(1)
    plain[i] = ref[i] + 0.005 * torch.tensor(rng.normal(size=(16, 16)),
                                             dtype=torch.float32)
    gate = _gate(ref, plain, got, alt)
    assert gate["failed"] == [], gate
    assert max(g["share"] for g in gate["groups"].values()) < 0.7
    # the per-parameter rule it replaced fails the same gradients there
    assert _per_param_failed(ref, plain, got) == [NAMES[i]]


def test_gate_passes_honest_noise():
    for seed, noise, common in ((2, 0.02, 0.0), (6, 0.05, 3.0)):
        ref, plain, got, alt = _grads(seed, noise, common)
        gate = _gate(ref, plain, got, alt)
        assert gate["failed"] == [], (seed, gate)
        assert max(g["share"] for g in gate["groups"].values()) < 0.8


def test_gate_fails_a_consistent_error_over_a_layer():
    ref, plain, got, alt = _grads(3, 0.001)
    got = [g * 1.05 if n.startswith("layers.0.") else g
           for n, g in zip(NAMES, got)]
    assert _gate(ref, plain, got, alt)["failed"] == ["layers.0"]


def test_gate_fails_an_error_hidden_in_large_rounding_noise():
    """Rounding noise common to every path as large as the f32 gradient
    (as trained BN channels give): an error of half the gradient in the
    kernels' layer 1 is far inside twice the plain path's distance from
    f32, but not inside the spread of honest implementations."""
    ref, plain, got, alt = _grads(7, 0.01, 1.0)
    rng = np.random.default_rng(8)
    got = [g + 0.8 * torch.tensor(rng.normal(size=r.shape),
                                  dtype=torch.float32) * r.abs().mean()
           if n.startswith("layers.1.") else g
           for n, g, r in zip(NAMES, got, ref)]
    gate = _gate(ref, plain, got, alt)
    assert gate["failed"] == ["layers.1"], gate
    g = gate["groups"]["layers.1"]
    # the per-parameter rule's bound, twice the plain path's distance from
    # f32, would pass it
    assert g["kernels"] < 2 * g["plain"] + TOL


def test_gate_fails_a_swapped_pair():
    ref, plain, got, alt = _grads(4, 0.005)
    i = NAMES.index("layers.0.MLP_aggr.0.weight")
    j = NAMES.index("layers.0.MLP_aggr.2.weight")
    got[i], got[j] = got[j], got[i]
    assert _gate(ref, plain, got, alt)["failed"] == ["layers.0"]


def test_gate_fails_non_finite_gradients():
    ref, plain, got, alt = _grads(5, 0.005)
    got[0] = torch.full_like(got[0], float("nan"))
    assert _gate(ref, plain, got, alt)["failed"] == ["encoder"]
