"""The port's GAT driver, rehearsed on the CPU at a tiny scale: reddit in
the fused form, pubmed in the edge form. It prints the reference's lines,
and the loss is finite and falls."""

import math

import pytest

from dgl_tpu_torch.benchmarks.node_classification import main_gat
from dgl_tpu_torch.data import load_node_dataset
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_fwd
from dgl_tpu_torch.kernels.seg_sum import seg_sum


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The driver always loads at full scale; the tests shrink it and keep
    the synthetic cache in their own directory."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(main_gat, "load_node_dataset",
                        lambda name, seed=0: load_node_dataset(name, seed=seed, scale=0.002))


def _launches():
    return (csr_spmm.launches, seg_sum.launches, gat_attention_fwd.launches,
            gat_attention_bwd.launches)


@pytest.mark.parametrize("dataset,fused,extra", [
    ("reddit", True, []),
    # 39 nodes: without dropout the loss falls from step to step
    ("pubmed", False, ["--dropout", "0"]),
])
def test_main_prints_reference_lines_and_the_loss_falls(tiny, capsys, dataset, fused, extra):
    before = _launches()
    res = main_gat.main(["--dataset", dataset, "--device", "cpu", "--epochs", "6", "--runs", "1",
                         "--eval", *extra])
    assert _launches() == before  # CPU tensors never launch a kernel
    out = capsys.readouterr().out
    for line in ("Training time/epoch", "Run 00 | Epoch 00005 | Loss", "  Final Train:",
                 "   Final Test:"):
        assert line in out, line
    assert res["fused"] is fused and res["device"] == "cpu" and res["synthetic"]
    (losses,) = res["losses"]
    assert len(losses) == 6 and all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert len(res["epochs_s"]) == 3 and res["epoch_s"] > 0


def test_run_profiles_and_rejects_unknown_settings(tiny):
    res = main_gat.run("reddit", device="cpu", epochs=1, profile_epochs=1)
    prof = res["profile"]  # no device events on the CPU
    assert prof["epochs"] == 1 and prof["kernels"] == [] and prof["wall_ms_per_epoch"] > 0
    assert res["epoch_s"] is None  # the first three epochs are not timed
    with pytest.raises(ValueError, match="unknown dataset"):
        main_gat.run("citeseer", device="cpu")
    with pytest.raises(ValueError, match="unknown overrides"):
        main_gat.run("reddit", device="cpu", heads=4)
