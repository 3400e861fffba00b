"""The port's RGCN driver on ogbn-proteins, rehearsed on the CPU at a tiny
--scale: it prints the reference's lines, the loss is finite and falls, the
K1 calls a step makes are the ones chip_smoke.py derives from the code
(rgcn_k1_launches), in both forms, and the left-out flags raise; --shard 2
on two gloo ranks."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import dgl_tpu_torch.ops.rel as rel_mod
from dgl_tpu_torch.benchmarks.node_classification import main_rgcn
from dgl_tpu_torch.data import load_node_dataset
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.models import RGCN
from dgl_tpu_torch.parallel import halo
from dgl_tpu_torch.parallel.halo_train import HaloRGCN

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
    with pytest.raises(SystemExit):
        main_rgcn.main(["--device", "cpu", "--lane-kernel"])


def test_shard_flag_trains_over_two_gloo_ranks(cache, capfd, monkeypatch):
    """--shard 2: the plan line, the reference's lines with the ROC-AUC over
    both ranks' rows (rank 0 prints), a finite loss that falls, the same
    parameters on both ranks, and the trained logits equal to HaloRGCN on
    one shard of the same graph."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each rank's torch threads
    res = main_rgcn.main(["--device", "cpu", "--scale", str(SCALE), "--epochs", "10",
                          "--runs", "1", "--eval", "--eval_steps", "5", "--shard", "2",
                          "--dist-backend", "gloo"])
    out = capfd.readouterr().out
    for line in ("shard plan: k=2 nodes/shard=", "Training time/epoch", "Run 00 | Epoch 00004",
                 "Run 00 | Epoch 00009", "  Final Train:", "   Final Test:"):
        assert line in out, line
    assert out.count("Training time/epoch") == 7
    (losses,) = res["losses"]
    assert len(losses) == 10 and all(math.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    for key, v in res["params"][0].items():
        np.testing.assert_array_equal(res["params"][1][key], v, err_msg=key)
    data = load_node_dataset("ogbn-proteins", scale=SCALE)
    n, n_rel = data.num_nodes, data.edge_feat.shape[1]
    plan, n_pad, leids, heids = halo.shard_fullgraph_boundary(data.src, data.dst, n, 1,
                                                             return_eids=True)
    shard = halo.place(plan, 0, "cpu")
    w_loc, w_hal = halo.plan_layout_edata_boundary(plan, leids, heids, data.edge_feat)
    model = HaloRGCN(1, 32, data.labels.shape[1], n_rel, 3, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in res["params"][0].items()})
    model.eval()
    with torch.no_grad():
        want = model(shard, torch.ones(n_pad, 1), shard.edge_weights(w_loc[0], w_hal[0]))
    np.testing.assert_allclose(res["logits"], want[:n].numpy(), rtol=1e-4, atol=1e-5)
