"""The port's SAGE suite driver, rehearsed on the CPU at a tiny --scale:
cora, ogbn-arxiv (BN, bidirected) and ogbn-products (bidirected), hoisted,
unhoisted and under the scatter lowering. It prints the reference's lines,
the loss is finite, the modes agree on the first step, and the K1 calls a
step makes are the ones chip_smoke.py derives from the code. Also the
3-layer BN GraphSAGE of arxiv's layout against the JAX model; --shard 2 on
two gloo ranks; and --ckpt-dir's resume."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.models import GraphSAGE as FlaxGraphSAGE

import dgl_tpu_torch
import dgl_tpu_torch.ops.spmm as spmm_mod
from dgl_tpu_torch.benchmarks.node_classification import main_sage
from dgl_tpu_torch.convert import sage_state_dict_from_flax
from dgl_tpu_torch.data import NODE_DATASET_STATS
from dgl_tpu_torch.graph import transforms
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.parallel import halo
from dgl_tpu_torch.parallel.halo_train import HaloSAGE

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SCALE = 0.002


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Under pytest-xdist several workers share the machine's cores:
    torch's intra-op threads in each would oversubscribe them, and these
    tests run many small ops, which that slows most."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The synthetic cache in the test's own directory."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))


@pytest.mark.parametrize("dataset", ["cora", "ogbn-arxiv", "ogbn-products"])
def test_main_prints_reference_lines_in_every_mode(cache, capsys, dataset):
    first = {}
    for mode, extra in (("hoisted", []), ("unhoisted", ["--no-precompute"]),
                        ("scatter", ["--no-precompute", "--lowering", "scatter"])):
        before = csr_spmm.launches
        res = main_sage.main(["--dataset", dataset, "--device", "cpu", "--scale", str(SCALE),
                              "--epochs", "5", "--runs", "1", "--eval", *extra])
        assert csr_spmm.launches == before  # CPU tensors never launch the kernel
        out = capsys.readouterr().out
        for line in ("Training time/epoch", "Run 00 | Epoch 00004 | Loss", "  Final Train:",
                     "   Final Test:"):
            assert line in out, (mode, line)
        (losses,) = res["losses"]
        assert len(losses) == 5 and all(math.isfinite(v) for v in losses)
        assert len(res["epochs_s"]) == 2 and res["device"] == "cpu" and res["synthetic"]
        assert res["load_s"] > 0 and res["setup_s"] > 0
        assert (res["precompute_s"] is None) == (mode != "hoisted")
        assert res["setup_bytes"] is None and res["train_peak_bytes"] is None
        first[mode] = losses[0]
    # the same weights and dropout masks: the modes agree on the first step
    assert max(first.values()) - min(first.values()) < 1e-4, first


def test_bidirect_follows_the_table(cache):
    res = main_sage.run("ogbn-arxiv", epochs=1, device="cpu", scale=SCALE)
    data = dgl_tpu_torch.data.load_node_dataset("ogbn-arxiv", scale=SCALE)
    s, _ = transforms.to_bidirected(torch.from_numpy(np.asarray(data.src)),
                                    torch.from_numpy(np.asarray(data.dst)), data.num_nodes)
    assert res["num_edges"] == len(s)
    res = main_sage.run("cora", epochs=1, device="cpu", scale=SCALE)
    assert res["num_edges"] == len(dgl_tpu_torch.data.load_node_dataset("cora", scale=SCALE).src)


@pytest.mark.parametrize("dataset", ["ogbn-arxiv", "ogbn-products"])
@pytest.mark.parametrize("hoisted", [True, False])
def test_k1_calls_per_step_are_the_derived_ones(cache, monkeypatch, dataset, hoisted):
    """chip_smoke.py checks the card's launch counts against
    sage_k1_launches; here the calls K1's wrapper gets are counted, with
    their widths and CSRs, on the CPU."""
    calls = []

    def spy(indptr, indices, x, *a, **kw):
        calls.append((x.shape[1], indptr.numel() - 1))
        return csr_spmm(indptr, indices, x, *a, **kw)

    monkeypatch.setattr(spmm_mod, "csr_spmm", spy)
    epochs = 3
    res = main_sage.run(dataset, epochs=epochs, device="cpu", scale=SCALE, precompute=hoisted)
    cfg = main_sage.DATASET_CFG[dataset]
    _, _, feat, classes = NODE_DATASET_STATS[dataset]
    per_step = chip_smoke.sage_k1_launches(feat, cfg["hidden"], classes, cfg["layers"], hoisted)
    assert len(calls) == len(per_step) * epochs + int(hoisted)
    widths = sorted(d for d, _ in calls[int(hoisted):])
    assert widths == sorted([d for _, _, d in per_step] * epochs)
    if hoisted:
        assert calls[0][0] == feat  # x_agg at the input width, once
    assert res["losses"][0][0] > 0


def test_unknown_dataset_and_left_out_flags_raise(cache):
    with pytest.raises(ValueError, match="unknown dataset"):
        main_sage.run("citeseer", device="cpu")
    with pytest.raises(ValueError, match="unknown overrides"):
        main_sage.run("cora", device="cpu", heads=4)
    # --bf16-messages is ported (tests/test_torch_bf16.py); the TPU's flags are not
    for flags in (["--lane-kernel"], ["--lane-force"], ["--scan-epochs", "5"]):
        with pytest.raises(SystemExit):
            main_sage.main(["--device", "cpu", *flags])


def test_shard_flag_trains_over_two_gloo_ranks(cache, capfd, monkeypatch):
    """--shard 2 on bidirected ogbn-products: the JAX driver's plan line and
    the reference's lines (rank 0 prints), a finite loss, the same
    parameters on both ranks, and the trained logits (rows un-permuted to
    the input order) equal to HaloSAGE on one shard of the same graph."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each rank's torch threads
    res = main_sage.main(["--dataset", "ogbn-products", "--device", "cpu", "--scale",
                          str(SCALE), "--epochs", "5", "--runs", "1", "--eval", "--shard", "2",
                          "--dist-backend", "gloo"])
    out = capfd.readouterr().out
    for line in ("shard plan: k=2 nodes/shard=", "Training time/epoch",
                 "Run 00 | Epoch 00004 | Loss", "  Final Train:", "   Final Test:"):
        assert line in out, line
    assert out.count("Training time/epoch") == 2  # rank 0 alone prints
    (losses,) = res["losses"]
    assert len(losses) == 5 and all(math.isfinite(v) for v in losses)
    assert res["k"] == 2 and res["backend"] == "gloo" and res["rows_per_pair"] >= 1
    for key, v in res["params"][0].items():
        np.testing.assert_array_equal(res["params"][1][key], v, err_msg=key)
    data = dgl_tpu_torch.data.load_node_dataset("ogbn-products", scale=SCALE)
    n = data.num_nodes
    src, dst = transforms.to_bidirected(torch.from_numpy(np.asarray(data.src)),
                                        torch.from_numpy(np.asarray(data.dst)), n)
    assert res["num_edges"] == len(src)
    plan, n_pad = halo.shard_fullgraph_boundary(src.numpy(), dst.numpy(), n, 1)
    cfg = main_sage.DATASET_CFG["ogbn-products"]
    model = HaloSAGE(data.features.shape[1], cfg["hidden"], data.num_classes, cfg["layers"],
                     device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in res["params"][0].items()})
    model.eval()
    x = torch.zeros(n_pad, data.features.shape[1])
    x[:n] = torch.from_numpy(np.asarray(data.features))
    with torch.no_grad():
        want = model(halo.place(plan, 0, "cpu"), x)[:n].numpy()
    np.testing.assert_allclose(res["logits"], want, rtol=1e-4, atol=1e-5)


def test_dist_backend_nccl_with_more_ranks_than_cards_raises(cache):
    with pytest.raises(ValueError, match="one rank on each card"):
        main_sage.main(["--dataset", "cora", "--device", "cuda", "--shard", "64",
                        "--dist-backend", "nccl"])


def test_ckpt_dir_resumes_to_the_uninterrupted_losses(cache, tmp_path, capsys):
    """6 epochs straight against 3 epochs, then a resume of 3 from the
    checkpoint of epoch 2 (model, Adam, the dropout generator): the resumed
    epochs' losses equal the straight run's bit for bit."""
    flags = ["--dataset", "cora", "--device", "cpu", "--scale", "0.05", "--runs", "1"]
    straight = main_sage.main([*flags, "--epochs", "6"])
    ckpt = str(tmp_path / "ckpt")
    first = main_sage.main([*flags, "--epochs", "3", "--ckpt-dir", ckpt, "--ckpt-every", "1"])
    assert sorted(os.listdir(ckpt)) == ["0", "1", "2"]
    capsys.readouterr()
    resumed = main_sage.main([*flags, "--epochs", "6", "--ckpt-dir", ckpt, "--ckpt-every", "1"])
    assert "resumed from checkpoint at epoch 3" in capsys.readouterr().out
    assert first["losses"][0] == straight["losses"][0][:3]
    assert resumed["losses"][0] == straight["losses"][0][3:]
    assert sorted(os.listdir(ckpt)) == ["3", "4", "5"]  # the last 3 are kept


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("hoisted", [False, True])
def test_bn_graphsage_of_arxivs_layout_matches_flax(hoisted):
    """3 layers, BN, in < hidden > out (layer 1 aggregates its input, layer
    3 projects first) on a bidirected graph, in training mode (BN over the
    batch, dropout off): logits, every parameter's gradient and the BN
    statistics; hoisted with x_agg."""
    rng = np.random.default_rng(0)
    n, e, in_feats, hidden, classes = 150, 900, 12, 32, 5
    src, dst = (t.numpy() for t in transforms.to_bidirected(
        torch.from_numpy(rng.integers(0, n, e)), torch.from_numpy(rng.integers(0, n, e)), n))
    gj = dgl_tpu.from_edges(src, dst, n)
    gt = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    x = rng.standard_normal((n, in_feats)).astype(np.float32)
    cot = rng.standard_normal((n, classes)).astype(np.float32)
    kw = dict(hidden_feats=hidden, out_feats=classes, num_layers=3, dropout=0.0, batch_norm=True)
    fm = FlaxGraphSAGE(**kw)
    x_agg_j = dgl_tpu.ops.gspmm(gj, "copy_u", "mean", x=jnp.asarray(x)) if hoisted else None
    variables = _np_tree(fm.init(jax.random.PRNGKey(2), gj, jnp.asarray(x)))

    def f(p):
        out, state = fm.apply({"params": p, "batch_stats": variables["batch_stats"]}, gj,
                              jnp.asarray(x), x_agg=x_agg_j, deterministic=False,
                              mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, state)

    (_, (ref, state)), grads = jax.value_and_grad(f, has_aux=True)(variables["params"])
    tm = dgl_tpu_torch.GraphSAGE(in_feats, **kw, device="cpu")
    tm.load_state_dict(sage_state_dict_from_flax(variables["params"], variables["batch_stats"]))
    xt = torch.from_numpy(x)
    x_agg = dgl_tpu_torch.gspmm(gt, "copy_u", "mean", x=xt) if hoisted else None
    out = tm(gt, xt, x_agg=x_agg)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    params = dict(tm.named_parameters())
    for k, g_ref in sage_state_dict_from_flax(_np_tree(grads)).items():
        # BN divides by per-feature deviations: gradients below it carry the
        # rounding of the layers above, so 1e-4 relative
        np.testing.assert_allclose(params[k].grad.numpy(), g_ref.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    stats = sage_state_dict_from_flax(variables["params"], _np_tree(state["batch_stats"]))
    for k, v in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-5, atol=1e-6)


def test_bidirect_on_tensors_equals_the_jax_arrays():
    """main_sage bidirects on the device: transforms.to_bidirected on
    tensors gives the JAX package's arrays, and the graph built from them
    equals one built from those arrays."""
    rng = np.random.default_rng(3)
    n = 500
    src, dst = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    want = dgl_tpu.graph.transforms.to_bidirected(src, dst, n)
    got = transforms.to_bidirected(torch.from_numpy(src), torch.from_numpy(dst), n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    ga = dgl_tpu_torch.from_edges(*got, n, device="cpu")
    gb = dgl_tpu_torch.from_edges(*want, n, device="cpu")
    for name in ("src", "dst", "indptr", "eid"):
        assert torch.equal(getattr(ga, name), getattr(gb, name))
        assert torch.equal(getattr(ga.reverse, name), getattr(gb.reverse, name))
