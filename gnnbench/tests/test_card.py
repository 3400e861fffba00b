"""The tiny cells on a card: the port's kernels, the traced run's readers
and the comparison, end to end. Skips without a card; on one:

    python3 -m pytest gnnbench/tests/test_card.py -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest
import torch

from gnnbench.run import run_cell


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_sage.full", "tiny_gat.full", "tiny_sage.tiny_ns"])
def test_tiny_cells_on_the_card(tiny_root, cell):
    dev = _card()
    result, rows = run_cell(tiny_root, cell, 41, 0.5, True, dev)
    assert result["correct"], rows
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    kernels = [name for name, _ in result["breakdown"]["device_ops"]]
    assert kernels
