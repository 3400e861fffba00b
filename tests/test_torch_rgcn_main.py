"""The port's RGCN driver on ogbn-proteins, rehearsed on the CPU at a tiny
--scale: it prints the reference's lines, the loss is finite and falls, the
K1 calls a step makes are the ones chip_smoke.py derives from the code
(rgcn_k1_launches), in both forms, and the left-out flags raise."""

import math
import os
import sys

import pytest
import torch

import dgl_tpu_torch.ops.rel as rel_mod
from dgl_tpu_torch.benchmarks.node_classification import main_rgcn
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.models import RGCN

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SCALE = 0.001


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Under pytest-xdist several workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The synthetic cache in the test's own directory."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))


def test_main_prints_reference_lines_and_the_loss_falls(cache, capsys):
    before = csr_spmm.launches
    res = main_rgcn.main(["--device", "cpu", "--scale", str(SCALE), "--epochs", "10",
                          "--runs", "1", "--eval", "--eval_steps", "5"])
    assert csr_spmm.launches == before  # CPU tensors never launch the kernel
    out = capsys.readouterr().out
    for line in ("Training time/epoch", "Run 00 | Epoch 00004 | Loss", "Run 00 | Epoch 00009",
                 "Highest Train:", "  Final Train:", "   Final Test:", "All runs:"):
        assert line in out, line
    assert out.count("Training time/epoch") == 7  # epochs from the fourth
    (losses,) = res["losses"]
    assert len(losses) == 10 and all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert res["device"] == "cpu" and res["synthetic"] and res["num_edges"] > 0
    assert res["setup_bytes"] is None and res["train_peak_bytes"] is None


@pytest.mark.parametrize("fuse", [False, True])
def test_k1_calls_per_step_are_the_derived_ones(cache, monkeypatch, fuse):
    """chip_smoke.py checks the card's launch counts against
    rgcn_k1_launches of the driver's model; here the calls K1's wrapper
    gets are counted, with their CSRs and widths, on the CPU. Both forms
    start from the same weights, so they agree on the first step's loss."""
    calls = []

    def spy(indptr, indices, x, w=None, **kw):
        calls.append((indices.data_ptr(), x.shape[1]))
        return csr_spmm(indptr, indices, x, w, **kw)

    monkeypatch.setattr(rel_mod, "csr_spmm", spy)
    epochs = 3
    res = main_rgcn.run(epochs=epochs, runs=1, device="cpu", scale=SCALE, fuse_relations=fuse)
    per_step = chip_smoke.rgcn_k1_launches(RGCN(1, 32, 112, 8, 3, fuse_relations=fuse,
                                                device="cpu"))
    # layer 1 (1 -> 32) aggregates its data first: 8 launches at D = 1, none
    # backward; layer 2 (32 -> 32) projects first in the default form, layer
    # 3 (32 -> 112 tasks) aggregates first: 16 launches each at D = 32
    assert len(per_step) == 40
    assert sorted(d for _, _, _, d in per_step) == [1] * 8 + [32] * 32
    assert len(calls) == len(per_step) * epochs
    by_csr = {}
    for ptr, d in calls:
        by_csr.setdefault(ptr, []).append(d)
    want = {side: sorted([d for _, s, _, d in per_step if s == side] * epochs)
            for side in ("fwd", "bwd")}
    assert sorted(map(sorted, by_csr.values())) == sorted(want.values())
    other = main_rgcn.run(epochs=1, runs=1, device="cpu", scale=SCALE, fuse_relations=not fuse)
    assert abs(other["losses"][0][0] - res["losses"][0][0]) < 1e-5


def test_left_out_flags_raise(cache):
    with pytest.raises(NotImplementedError, match="slice I"):
        main_rgcn.main(["--device", "cpu", "--shard", "4"])
    with pytest.raises(SystemExit):
        main_rgcn.main(["--device", "cpu", "--lane-kernel"])
