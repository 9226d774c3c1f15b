"""The kernel A/B tool (``cartnet_tpu_torch.tools.kernel_ab``) builds its
variants by replacing one line of a CUDA source; each such line must occur
exactly once in this tree's source, or the variant would not be the one its
docstring names. The tool itself needs the card."""

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
