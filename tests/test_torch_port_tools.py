"""The kernel A/B tool (``cartnet_tpu_torch.tools.kernel_ab``) builds its
variants by replacing one line of a CUDA source; each such line must occur
exactly once in this tree's source, or the variant would not be the one its
docstring names. The tool itself needs the card. The model A/B tool
(``model_ab``) runs on the CPU too."""

import pytest

from cartnet_tpu_torch.ops.kernels import _build
from cartnet_tpu_torch.tools import kernel_ab


@pytest.mark.parametrize("tag", sorted(kernel_ab._VARIANTS))
def test_variant_patch_matches_one_source_line(tag):
    name, old, new = kernel_ab._VARIANTS[tag]
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert text.count(old) == 1, tag
    assert new not in text, tag


def test_tool_needs_the_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert kernel_ab.main(["k8_tile"]) == 1


def test_rcp_sweep_holds_every_float_across_the_range_edges():
    """``k2_rcp``'s sweep fills K2's gate at the main shapes (E 20992,
    d 256) and holds every float32 across the two edges it must cross:
    where 1 + exp(-a) reaches 2^126 (rcp_fast's range check sends the
    batch to the division) and where exp(-a) overflows; and NaN, +-inf."""
    import numpy as np
    n = 20992 * 256
    a = kernel_ab._rcp_sweep(n)
    assert a.dtype == np.float32 and a.size == n
    assert np.isnan(a).any() and np.isposinf(a).any() and np.isneginf(a).any()
    with np.errstate(over="ignore"):
        past = ((-87.40, -87.28,
                 lambda v: 1.0 + np.exp(-v.astype(np.float64)) >= 2.0 ** 126),
                (-88.76, -88.68, lambda v: np.isinf(np.exp(-v))))
        for lo, hi, beyond in past:
            run = np.unique(a[(a >= np.float32(lo)) & (a <= np.float32(hi))]
                            .view(np.int32))
            lo_b, hi_b = (np.float32(v).view(np.int32) for v in (lo, hi))
            assert run.size == lo_b - hi_b + 1, (lo, hi)
            assert (np.diff(run) == 1).all(), (lo, hi)
            out = beyond(run.view(np.float32))
            assert out.any() and not out.all(), (lo, hi)


@pytest.mark.parametrize("model", ["ecomformer", "icomformer"])
def test_model_ab_holds_a_tree_bitwise_to_itself(model, capsys):
    """``model_ab`` against this very tree on the CPU, at a narrow width:
    every forward, loss, gradient and BN buffer, bf16 and f32, bitwise
    between the trees and between runs."""
    import json
    import pathlib
    from cartnet_tpu_torch.tools import model_ab
    repo = pathlib.Path(__file__).resolve().parents[1]
    line = model_ab.main([str(repo), "--model", model, "--device", "cpu",
                          "--dim", "32", "--atoms", "12"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == line
    assert line["tensors"] > 100
    assert line["differ_between_trees"] == []
    assert line["differ_between_runs_of_this_tree"] == []
    assert line["differ_between_runs_of_dir"] == []
    assert line["gap_between_trees"] == {}
    assert line["gap_between_runs_of_this_tree"] == {}
