"""GAT's scatter lowering (the PyG twin): ``GATConv(lowering="scatter")``
and ``GAT(lowering="scatter")`` against the flax modules under
``DGL_TPU_LOWERING=scatter``, which changes the JAX ``gspmm`` alone; the
driver's ``--lowering scatter`` and ``--scale``; and the kernel calls of a
scatter step: no K3, and of the edge form's K2 and P1 calls those of the
edge softmax and the gathers only (``chip_smoke.gat_edge_per_step``).

Tolerance: 1e-5 relative and absolute on logits and on the gradient of
every parameter (float32, dropout off, weights through ``convert.py``).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.models import GAT as FlaxGAT
from dgl_tpu.nn import GATConv as FlaxGATConv

import dgl_tpu_torch
import dgl_tpu_torch.kernels.gat_attention as gat_mod
import dgl_tpu_torch.ops.gather as gather_mod
import dgl_tpu_torch.ops.segment as segment_mod
from dgl_tpu_torch.benchmarks.common import masked_softmax_ce
from dgl_tpu_torch.benchmarks.node_classification import main_gat
from dgl_tpu_torch.convert import gat_state_dict_from_flax
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_fwd
from dgl_tpu_torch.kernels.row_gather import row_gather_by_source
from dgl_tpu_torch.kernels.seg_sum import seg_sum
from dgl_tpu_torch.nn import conv as conv_mod
from dgl_tpu_torch.ops.softmax import edge_softmax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

N, E = 60, 400
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graph(seed):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.5, E) - 1) % N
    dst = rng.integers(0, 3 * N // 4, E)  # the last quarter has no in-edge
    return rng, src, dst


def test_gat_model_matches_flax_under_the_scatter_lowering(monkeypatch):
    monkeypatch.setenv("DGL_TPU_LOWERING", "scatter")
    rng, src, dst = _graph(23)
    x = rng.standard_normal((N, 10)).astype(np.float32)
    y = rng.integers(0, 9, N)
    mask = (rng.random(N) < 0.6).astype(np.float32)
    gj = dgl_tpu.from_edges(src, dst, N)
    fm = FlaxGAT(hidden_feats=3, out_feats=9, heads=(2, 2, 1), remat=False)
    params = _np_tree(fm.init(jax.random.PRNGKey(1), gj, jnp.asarray(x))["params"])

    def jax_loss(p):
        logits = fm.apply({"params": p}, gj, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1)[:, 0]
        return jnp.sum(ce * mask) / jnp.sum(mask), logits

    (loss_j, logits_j), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)

    tm = dgl_tpu_torch.GAT(10, 3, 9, (2, 2, 1), lowering="scatter", device="cpu")
    tm.load_state_dict(gat_state_dict_from_flax(params))
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    logits_t = tm(gt, torch.from_numpy(x))
    loss_t = masked_softmax_ce(logits_t, torch.from_numpy(y), torch.from_numpy(mask))
    loss_t.backward()

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), **TOL)
    want = gat_state_dict_from_flax(_np_tree(grads_j))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_memory_safe_form_under_the_scatter_lowering_matches_flax(monkeypatch):
    """Past the message limit both layers take their memory-safe form, and
    its weighted sum is gspmm(mul, sum) under the scatter lowering."""
    monkeypatch.setenv("DGL_TPU_LOWERING", "scatter")
    monkeypatch.setenv("DGL_TPU_MSG_BUDGET_GB", repr(64 / 2**30))
    monkeypatch.setattr(conv_mod, "_EDGE_MSG_LIMIT_BYTES", 64)
    rng, src, dst = _graph(29)
    x = rng.standard_normal((N, 7)).astype(np.float32)
    cot = rng.standard_normal((N, 3, 4)).astype(np.float32)
    gj = dgl_tpu.from_edges(src, dst, N)
    fc = FlaxGATConv(4, num_heads=3)
    params = _np_tree(fc.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))["params"])
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (jnp.sum(o * cot), o))(fc.apply({"params": p}, gj, jnp.asarray(x))),
        has_aux=True))(params)

    tc = dgl_tpu_torch.GATConv(7, 4, 3, lowering="scatter", device="cpu")
    sd = gat_state_dict_from_flax({"gat_0": params})
    tc.load_state_dict({k.removeprefix("convs.0."): v for k, v in sd.items()})

    def no_rel(*a, **kw):
        raise AssertionError("the scatter lowering's memory-safe sum runs no gspmm_rel")

    monkeypatch.setattr(conv_mod, "gspmm_rel", no_rel)
    out_t = tc(dgl_tpu_torch.from_edges(src, dst, N, device="cpu"), torch.from_numpy(x))
    (out_t * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **TOL)
    want = gat_state_dict_from_flax({"gat_0": _np_tree(grads_j)})
    for name, p in tc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[f"convs.0.{name}"].numpy(),
                                   err_msg=name, **TOL)


def test_scatter_lowering_refuses_the_fused_form():
    with pytest.raises(ValueError, match="edge form"):
        dgl_tpu_torch.GATConv(4, 2, fused=True, lowering="scatter", device="cpu")
    with pytest.raises(ValueError, match="lowering"):
        dgl_tpu_torch.GATConv(4, 2, lowering="blocked", device="cpu")


def test_main_takes_scale_and_lowering_and_prints_the_reference_lines(tmp_path, monkeypatch,
                                                                      capsys):
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    res = main_gat.main(["--dataset", "reddit", "--scale", "0.002", "--lowering", "scatter",
                         "--device", "cpu", "--epochs", "5", "--runs", "1", "--eval"])
    out = capsys.readouterr().out
    for line in ("lowering='scatter'", "scale=0.002", "Training time/epoch",
                 "Run 00 | Epoch 00004 | Loss", "  Final Train:", "   Final Test:"):
        assert line in out, line
    assert res["fused"] is False and res["synthetic"]
    assert res["num_edges"] < 100_000  # reddit at 0.002 of its size (11.6M edges at 1)
    (losses,) = res["losses"]
    assert len(losses) == 5 and all(math.isfinite(v) for v in losses)
    with pytest.raises(ValueError, match="scatter"):
        main_gat.main(["--dataset", "reddit", "--lowering", "scatter", "--shard", "2",
                       "--device", "cpu"])


def test_a_scatter_step_calls_no_k3_and_gspmm_no_kernel(tmp_path, monkeypatch):
    """reddit, fused by its config, takes the edge form under the scatter
    lowering: no K3, and K1, K2 and P1 only for the gathers and the edge
    softmax (gat_edge_per_step(lowering="scatter"))."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
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
    main_gat.run("reddit", device="cpu", epochs=2, lowering="scatter", scale=0.002)
    steps, rescues = 2, edge_softmax.rescues - rescues
    per_step, per_rescue = chip_smoke.gat_edge_per_step(lowering="scatter")
    want = {k: n * steps + per_rescue[k] * rescues for k, n in per_step.items()}
    assert calls == want | {"gat_attention_fwd": 0, "gat_attention_bwd": 0}, (calls, rescues)
