"""The port's GCN graph-classification driver, rehearsed on the CPU at a
tiny --num-graphs: ENZYMES, ogbg-molhiv (fused and scatter) and ogbg-ppa.
It prints the reference's lines, the loss is finite, the kernel counters do
not move on CPU tensors, the split is the reference's, the K1, K2 and
P1-in-source-order calls a step makes are the ones chip_smoke.py derives
from the code, and the left-out flags raise."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import dgl_tpu_torch.ops.gather as gather_mod
import dgl_tpu_torch.ops.segment as segment_mod
import dgl_tpu_torch.ops.spmm as spmm_mod
from dgl_tpu_torch.benchmarks.graph_classification import main_gcn
from dgl_tpu_torch.data import load_graph_dataset
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.kernels.row_gather import row_gather_by_source
from dgl_tpu_torch.kernels.seg_sum import seg_sum

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Under pytest-xdist several workers share the machine's cores:
    torch's intra-op threads in each would oversubscribe them, and these
    tests run many small ops, which that slows most."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dataset,lowering,graphs", [
    ("ENZYMES", "fused", 60), ("ogbg-molhiv", "fused", 60), ("ogbg-molhiv", "scatter", 60),
    ("ogbg-ppa", "fused", 20),
])
def test_main_prints_reference_lines(capsys, dataset, lowering, graphs):
    before = (csr_spmm.launches, seg_sum.launches, row_gather_by_source.launches)
    res = main_gcn.main(["--dataset", dataset, "--device", "cpu", "--num-graphs", str(graphs),
                         "--batch_size", "16", "--epochs", "3", "--runs", "1", "--eval",
                         "--lowering", lowering])
    # CPU tensors launch nothing
    assert (csr_spmm.launches, seg_sum.launches, row_gather_by_source.launches) == before
    out = capsys.readouterr().out
    for line in ("Training time/epoch", "Run: 01, Epoch: 03, Loss:", "% Valid: ",
                 "  Final Train:", "   Final Test:"):
        assert line in out, line
    (losses,) = res["losses"]
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert len(res["epochs_s"]) == 1 and res["epoch_s"] > 0
    assert res["num_graphs"] == graphs and res["synthetic"] and res["device"] == "cpu"
    assert res["steps"] == 3 * math.ceil(int(graphs * 0.8) / 16)


def test_split_is_the_references():
    data = load_graph_dataset("ENZYMES", num_graphs=50)
    tr, va, te = main_gcn._split(data)
    np.random.seed(42)
    idx = np.arange(50)
    np.random.shuffle(idx)
    np.testing.assert_array_equal(np.concatenate([tr, va, te]), idx)
    assert (len(tr), len(va), len(te)) == (40, 5, 5)


@pytest.mark.parametrize("dataset,lowering", [
    ("ENZYMES", "fused"), ("ogbg-molhiv", "fused"), ("ogbg-molhiv", "scatter"),
    ("ogbg-ppa", "fused")])
def test_kernel_calls_per_step_are_the_derived_ones(monkeypatch, dataset, lowering):
    calls = {"csr_spmm": 0, "seg_sum": 0, "row_gather_by_source": 0}

    def spy(real, name):
        def f(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return f

    for mod, name, real in ((spmm_mod, "csr_spmm", csr_spmm), (gather_mod, "csr_spmm", csr_spmm),
                            (segment_mod, "seg_sum", seg_sum),
                            (segment_mod, "row_gather_by_source", row_gather_by_source)):
        monkeypatch.setattr(mod, name, spy(real, name))
    res = main_gcn.run(dataset, batch_size=8, epochs=2, lowering=lowering, num_graphs=30,
                       device="cpu", profile_steps=4)
    per_step = chip_smoke.gc_per_step(dataset, lowering)
    # 24 train graphs in batches of 8: 2 epochs, then 4 profiled steps, which
    # run on into a second shuffle
    assert res["steps"] == 2 * 3 + 4
    assert calls == {k: n * res["steps"] for k, n in per_step.items()}
    assert res["profile"]["steps"] == 4 and res["profile"]["kernels"] == []
    assert res["profile"]["wall_ms_per_step"] > 0


def test_unknown_dataset_and_left_out_flags_raise():
    with pytest.raises(ValueError, match="unknown dataset"):
        main_gcn.run("ogbg-code2", device="cpu")
    for flags in (["--scan-steps"], ["--fetch-every", "5"], ["--dataset", "PROTEINS"]):
        with pytest.raises(SystemExit):
            main_gcn.main(["--device", "cpu", *flags])
