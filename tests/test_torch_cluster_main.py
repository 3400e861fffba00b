"""The port's cluster drivers, rehearsed on the CPU at a tiny --scale:
cluster_sage with SAGE and with GAT on ogbn-products and cluster_gcn_lp on
ogbn-arxiv (dot and MLP predictors). They print the reference's lines,
their losses are finite and fall, and spies on the kernels' wrappers see
the launches that chip_smoke.cluster_launches derives from the code: one
P1 (index order) a batch, K1 or K3 a step and an evaluation, and LP's
u_dot_v gathers with their K1 and K2 adjoints. Left-out flags raise."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from dgl_tpu_torch.benchmarks.link_prediction import cluster_gcn_lp
from dgl_tpu_torch.benchmarks.sampling import cluster_sage
from dgl_tpu_torch.kernels import csr_spmm as k1_mod
from dgl_tpu_torch.kernels import gat_attention as k3_mod
from dgl_tpu_torch.kernels import row_gather as p1_mod
from dgl_tpu_torch.kernels import seg_sum as k2_mod
from dgl_tpu_torch.sampling import cluster as cluster_mod

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

EPOCHS = 5  # epochs 4 and 5 in "Training time/epoch"
HIDDEN = 16
SAGE_FLAGS = ["--device", "cpu", "--scale", "0.002", "--psize", "40", "--batch-size", "8",
              "--n-epochs", str(EPOCHS), "--n-hidden", str(HIDDEN), "--eval"]
LP_FLAGS = ["--device", "cpu", "--scale", "0.02", "--psize", "40", "--batch-size", "8",
            "--n-epochs", str(EPOCHS), "--n-hidden", str(HIDDEN), "--num-negs", "20", "--eval"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test workers share the machine's cores (see
    test_torch_sage_main.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The synthetic data and the partitions in one directory for the
    module's runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DGL_TPU_DATA_DIR", str(tmp_path_factory.mktemp("cluster_cache")))
        yield


@pytest.fixture
def counts(monkeypatch):
    """Every call of each kernel wrapper's plain version (which CPU tensors
    take), and the iterator's P1 feature gathers."""
    log = {k: 0 for k in chip_smoke._KERNEL_COUNTERS}

    def spy(name, fn):
        def wrapped(*a, **kw):
            log[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(cluster_mod, "row_gather_async",
                        spy("row_gather_async", cluster_mod.row_gather_async))
    monkeypatch.setattr(k1_mod, "csr_spmm_plain", spy("csr_spmm", k1_mod.csr_spmm_plain))
    monkeypatch.setattr(k2_mod, "seg_sum_plain", spy("seg_sum", k2_mod.seg_sum_plain))
    monkeypatch.setattr(p1_mod, "row_gather_by_source_plain",
                        spy("row_gather_by_source", p1_mod.row_gather_by_source_plain))
    monkeypatch.setattr(k3_mod, "gat_attention_fwd_plain",
                        spy("gat_attention_fwd", k3_mod.gat_attention_fwd_plain))
    monkeypatch.setattr(k3_mod, "gat_attention_bwd_plain",
                        spy("gat_attention_bwd", k3_mod.gat_attention_bwd_plain))
    for name in ("gat_scores", "gat_score_grad", "gat_vector_grad"):
        monkeypatch.setattr(k3_mod, f"{name}_plain", spy(name, getattr(k3_mod, f"{name}_plain")))
    return log


def _falling(losses):
    assert all(math.isfinite(v) for v in losses), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_cluster_sage_prints_the_reference_lines_and_launches_as_derived(cache, capsys, counts,
                                                                        model):
    res = cluster_sage.main(SAGE_FLAGS + ["--model", model, "--num-heads", "2", "--profile", "3"])
    out = capsys.readouterr().out
    for line in ("partition[metis] k=40:", "Training time/epoch ", "Run 00 | Epoch 00000 | Loss ",
                 "| Train ", "| Val ", "| Test ", "Final Train:", "Final Test:"):
        assert line in out, line
    assert out.count("Training time/epoch") == EPOCHS - 3 and len(res["epochs_s"]) == EPOCHS - 3
    assert len(res["accs"]) == EPOCHS and res["device"] == "cpu"
    _falling(res["losses"][0])
    assert res["steps_per_epoch"] == 5 and res["batches"] == 1 + 5 * EPOCHS + 3
    assert res["setup_bytes"] is None and len(res["phases_s"]) == EPOCHS
    assert set(res["phases_s"][0]) == {"load", "forward_backward", "sync"}
    want = chip_smoke.cluster_launches(model, res["steps"] + res["profile"]["steps"],
                                       res["batches"], len(res["accs"]), 100, 47,
                                       hidden=HIDDEN)
    assert counts == want


def test_cluster_gat_heads_follow_the_driver(cache):
    args = cluster_sage.parser().parse_args(["--model", "gat"])
    model = cluster_sage.make_model(args, 100, 47, torch.device("cpu"), 0)
    assert [(c.num_heads, c.out_feats, c.fused) for c in model.convs] == [
        (4, 64, True), (4, 64, True), (1, 47, True)]


@pytest.mark.parametrize("predictor", ["dot", "mlp"])
def test_cluster_gcn_lp_prints_the_reference_lines_and_launches_as_derived(cache, capsys, counts,
                                                                          predictor):
    res = cluster_gcn_lp.main(LP_FLAGS + ["--predictor", predictor, "--yardsticks"])
    out = capsys.readouterr().out
    for line in ("Training time/epoch ", "Run: 01, Epoch: 00, Loss: ", "Train MRR: ",
                 "Valid MRR: ", "Test MRR: ", "Final Train:", "Yardsticks"):
        assert line in out, line
    _falling(res["losses"])
    assert len(res["mrr"]) == EPOCHS and set(res["yardsticks"]) == {"untrained", "raw_features"}
    assert all(0 < v <= 1 for row in res["mrr"] + list(res["yardsticks"].values()) for v in row)
    if predictor == "dot":
        assert counts == chip_smoke.cluster_launches("lp", res["steps"], res["batches"],
                                                     len(res["mrr"]) + 1, 128, 40, hidden=HIDDEN)
    else:  # the MLP takes the same two gathers and adjoints
        assert counts["row_gather_by_source"] == 4 * res["steps"]


def test_mrr_ranks_ties_below_the_positive():
    h = torch.eye(4)
    rng = np.random.default_rng(0)
    dot = lambda a, b: (a * b).sum(-1)  # noqa: E731
    # src 0 -> dst 0 scores 1; negatives score 1 (node 0) or 0
    got = cluster_gcn_lp.mrr(dot, h, np.array([0]), np.array([0]), 4, 50, rng)
    negs = np.random.default_rng(0).integers(0, 4, size=(1, 50))
    assert got == pytest.approx(1.0 / (1 + (negs == 0).sum()))


def test_left_out_flags_raise(cache):
    with pytest.raises(NotImplementedError, match="TPU"):
        cluster_sage.main(SAGE_FLAGS + ["--freeze-clusters"])
    with pytest.raises(SystemExit):
        cluster_gcn_lp.main(LP_FLAGS + ["--model", "gat"])  # the JAX LP driver has no such flag
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cluster_sage.main(["--scale", "0.002", "--n-epochs", "1"])
