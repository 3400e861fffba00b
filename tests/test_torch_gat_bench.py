"""The port's GAT driver, rehearsed on the CPU at a tiny scale: reddit in
the fused form, pubmed in the edge form. It prints the reference's lines,
the loss is finite and falls, and the kernel calls a step makes are the ones
chip_smoke.py derives from the code."""

import math
import os
import sys

import pytest

import dgl_tpu_torch.kernels.gat_attention as gat_mod
import dgl_tpu_torch.ops.gather as gather_mod
import dgl_tpu_torch.ops.segment as segment_mod
from dgl_tpu_torch.benchmarks.node_classification import main_gat
from dgl_tpu_torch.data import load_node_dataset
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_fwd
from dgl_tpu_torch.kernels.row_gather import row_gather_by_source
from dgl_tpu_torch.kernels.seg_sum import seg_sum
from dgl_tpu_torch.ops.softmax import edge_softmax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The driver always loads at full scale; the tests shrink it and keep
    the synthetic cache in their own directory."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(main_gat, "load_node_dataset",
                        lambda name, seed=0: load_node_dataset(name, seed=seed, scale=0.002))


def _launches():
    return (csr_spmm.launches, seg_sum.launches, gat_attention_fwd.launches,
            gat_attention_bwd.launches, row_gather_by_source.launches)


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


@pytest.mark.parametrize("dataset", ["pubmed", "reddit"])
def test_kernel_calls_per_step_are_the_derived_ones(tiny, monkeypatch, dataset):
    """pubmed's edge form makes gat_edge_per_step's K1, K2 and
    P1-in-source-order calls a step, and those of each edge-softmax rescue,
    as phase_gat_main holds the card's counters to; reddit's fused form
    makes none of them, one K3 forward and one b2 a layer."""
    calls = dict.fromkeys(("csr_spmm", "seg_sum", "row_gather_by_source", "gat_attention_fwd",
                           "gat_attention_bwd"), 0)

    def spy(real, name):
        def f(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return f

    for mod, real in ((gather_mod, csr_spmm), (segment_mod, seg_sum),
                      (segment_mod, row_gather_by_source), (gat_mod, gat_attention_fwd),
                      (gat_mod, gat_attention_bwd)):
        monkeypatch.setattr(mod, real.__name__, spy(real, real.__name__))
    rescues = edge_softmax.rescues
    res = main_gat.run(dataset, device="cpu", epochs=4, profile_epochs=2)
    steps, rescues = 4 + 2, edge_softmax.rescues - rescues
    if dataset == "pubmed":
        per_step, per_rescue = chip_smoke.gat_edge_per_step()
        want = {k: n * steps + per_rescue[k] * rescues for k, n in per_step.items()}
        want |= {"gat_attention_fwd": 0, "gat_attention_bwd": 0}
    else:
        want = {"csr_spmm": 0, "seg_sum": 0, "row_gather_by_source": 0,
                "gat_attention_fwd": 3 * steps, "gat_attention_bwd": 3 * steps}
    assert calls == want, (calls, rescues)
    assert res["profile"]["epochs"] == 2


def test_shard_flag_trains_over_two_gloo_ranks(tmp_path, monkeypatch, capfd):
    """--shard 2 on ogbn-arxiv (bidirected, self-loops, heads 4, 4, 4): the
    plan line and the reference's lines (rank 0 prints), a finite loss, the
    same parameters on both ranks, and the trained logits equal to HaloGAT
    on one shard of the same graph (K3 over all of it)."""
    import numpy as np
    import torch

    from dgl_tpu_torch.graph import transforms
    from dgl_tpu_torch.parallel import halo
    from dgl_tpu_torch.parallel.halo_train import HaloGAT

    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each rank's torch threads
    # the ranks read what the driver's process loads and writes for them
    monkeypatch.setattr(main_gat, "load_node_dataset",
                        lambda name, seed=0: load_node_dataset(name, seed=seed, scale=0.002))
    res = main_gat.main(["--dataset", "ogbn-arxiv", "--device", "cpu", "--epochs", "5",
                         "--runs", "1", "--eval", "--shard", "2", "--dist-backend", "gloo"])
    out = capfd.readouterr().out
    for line in ("shard plan: k=2 nodes/shard=", "Training time/epoch",
                 "Run 00 | Epoch 00004 | Loss", "  Final Train:", "   Final Test:"):
        assert line in out, line
    (losses,) = res["losses"]
    assert len(losses) == 5 and all(math.isfinite(v) for v in losses)
    for key, v in res["params"][0].items():
        np.testing.assert_array_equal(res["params"][1][key], v, err_msg=key)
    data = load_node_dataset("ogbn-arxiv", scale=0.002)
    n, cfg = data.num_nodes, main_gat.DATASET_CFG["ogbn-arxiv"]
    src, dst = transforms.to_bidirected(torch.from_numpy(np.asarray(data.src)),
                                        torch.from_numpy(np.asarray(data.dst)), n)
    src, dst = transforms.add_self_loops(src, dst, n)
    plan, n_pad = halo.shard_fullgraph_boundary(src.numpy(), dst.numpy(), n, 1)
    model = HaloGAT(data.features.shape[1], cfg["hidden"], data.num_classes, cfg["heads"],
                    device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in res["params"][0].items()})
    x = torch.zeros(n_pad, data.features.shape[1])
    x[:n] = torch.from_numpy(np.asarray(data.features))
    with torch.no_grad():
        want = model(halo.place(plan, 0, "cpu"), x)[:n].numpy()
    np.testing.assert_allclose(res["logits"], want, rtol=1e-4, atol=1e-5)
