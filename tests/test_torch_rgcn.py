"""Port parity: RGCN's relation aggregation (``gspmm_rel``) against the JAX
package's ``gspmm_rel`` (edge chunks k = 1 and 3) and against its weighted
lane passes (``rel_lane_agg``, the Pallas kernel in interpret mode);
``RelGraphConv`` in both forms and a 2- and 3-layer ``RGCN`` against the
flax modules with weights carried by ``convert.py``; ``masked_bce`` and
``mean_multilabel_auc`` against the JAX drivers' ``benchmarks/common.py``.
Float32 on the CPU, dropout off."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.models import RGCN as FlaxRGCN
from dgl_tpu.nn import RelGraphConv as FlaxRelGraphConv
from dgl_tpu.ops.spmm import gspmm_rel as jax_gspmm_rel

import dgl_tpu_torch
import dgl_tpu_torch.ops.rel as rel_mod
from dgl_tpu_torch.benchmarks import common
from dgl_tpu_torch.convert import rel_graph_conv_state_dict_from_flax, rgcn_state_dict_from_flax
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.models import RGCN
from dgl_tpu_torch.nn import RelGraphConv
from dgl_tpu_torch.ops import RelEdgeWeights, gspmm_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, E, R = 60, 700, 4
# float32: sums of a few tens of terms and R relations in another order; a
# parameter gradient sums the whole graph's rows
RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _problem(seed, n=N, e=E, r=R):
    """A graph whose last 5 nodes have no in-edge, canonical (E, R) weights
    for both packages (the JAX copy zero-padded) and the port's graph."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n - 5, e)
    gj = dgl_tpu.from_edges(src, dst, n)
    gt = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    w_in = rng.uniform(0.1, 1.0, (e, r)).astype(np.float32)
    w = w_in[gt.eid.numpy()]  # canonical order, the JAX package's too
    w_pad = np.zeros((gj.num_edges_padded, r), np.float32)
    w_pad[:e] = w
    return rng, gj, gt, w, w_pad


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("k", [1, 3])
def test_gspmm_rel_matches_jax(reduce, k):
    """Values and gradients wrt y and w; the JAX side scans k edge chunks."""
    rng, gj, gt, w, w_pad = _problem(k)
    d = 6
    y = rng.standard_normal((N, R, d)).astype(np.float32)
    cot = rng.standard_normal((N, d)).astype(np.float32)
    out_j = np.asarray(jax_gspmm_rel(reduce, k, gj, jnp.asarray(y), jnp.asarray(w_pad)))
    gy_j, gw_j = jax.grad(
        lambda yy, ww: jnp.sum(jax_gspmm_rel(reduce, k, gj, yy, ww) * cot), argnums=(0, 1)
    )(jnp.asarray(y), jnp.asarray(w_pad))

    yt = torch.from_numpy(y).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out_t = gspmm_rel(reduce, gt, yt.transpose(0, 1), wt)
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j)[:E], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert not out_t.detach()[N - 5:].any()


def test_gspmm_rel_matches_rel_lane_agg_interpret(monkeypatch):
    """The JAX package's weighted lane passes (the Pallas K1 with its ``w``
    operand, interpret mode), as tests/test_kernels.py runs them: value and
    gradient wrt y; the port's weights laid out once (RelEdgeWeights) and
    relation-major y."""
    monkeypatch.setenv("DGL_TPU_LANE_INTERPRET", "1")
    from dgl_tpu.kernels import attach_lane_plans
    from dgl_tpu.ops.rel_lane import RelLaneWeights, rel_lane_agg

    rng = np.random.default_rng(4)
    n, e, r, d = 600, 4000, 3, 4
    src = np.concatenate([rng.integers(0, 128, e // 2), rng.integers(0, n, e // 2)])
    dst = rng.integers(0, n, e)
    gj = attach_lane_plans(dgl_tpu.from_edges(src, dst, n), dense_threshold=8,
                           max_expansion=1e9, compute_dtype=jnp.float32)
    assert gj.lane is not None
    gt = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    w_in = np.zeros((gj.num_edges_padded, r), np.float32)
    w_in[:e] = rng.standard_normal((e, r))
    w_canon = np.asarray(gj.permute_edata(jnp.asarray(w_in)))
    lw = RelLaneWeights.build(gj, w_canon, dtype=jnp.float32)
    y = rng.standard_normal((n, r, d)).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)
    ref = np.asarray(rel_lane_agg("mean", r, True, gj, jnp.asarray(y), lw))
    gy_ref = np.asarray(jax.grad(
        lambda yy: jnp.sum(rel_lane_agg("mean", r, True, gj, yy, lw) * cot))(jnp.asarray(y)))

    weights = RelEdgeWeights.build(gt, torch.from_numpy(w_in[:e][gt.eid.numpy()]))
    yt = torch.from_numpy(np.ascontiguousarray(y.transpose(1, 0, 2))).requires_grad_()
    out = gspmm_rel("mean", gt, yt, weights)
    (out * torch.from_numpy(cot)).sum().backward()
    # the lane passes add each tier and the XLA tail in their own order
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(yt.grad.numpy().transpose(1, 0, 2), gy_ref, rtol=1e-4, atol=1e-4)


def test_gspmm_rel_is_r_weighted_k1_calls_each_way(monkeypatch):
    """R weighted calls over the dst CSR forward and R over the reverse CSR
    backward, the weights in each CSR's order; none for w without a
    gradient, and then RelEdgeWeights keeps no canonical copy; RelEdgeWeights
    and a raw (E, R) tensor, a relation-major y and a transposed (N, R, D)
    view give the same numbers."""
    rng, _, gt, w, _ = _problem(9)
    calls = []

    def spy(indptr, indices, x, ww=None, **kw):
        calls.append((indptr.numel(), indices is gt.src, ww is not None and ww.shape == (E,)))
        return csr_spmm(indptr, indices, x, ww, **kw)

    monkeypatch.setattr(rel_mod, "csr_spmm", spy)
    y = torch.from_numpy(rng.standard_normal((R, N, 8)).astype(np.float32))
    weights = RelEdgeWeights.build(gt, torch.from_numpy(w))
    assert torch.equal(weights.fwd, torch.from_numpy(w).t())
    assert torch.equal(weights.rev, torch.from_numpy(w)[gt.reverse.eid.long()].t())
    assert weights.canon is None
    assert RelEdgeWeights.build(gt, torch.from_numpy(w).requires_grad_()).canon is not None
    yk = y.clone().requires_grad_()
    out = gspmm_rel("mean", gt, yk, weights)
    out.sum().backward()
    assert calls == [(N + 1, True, True)] * R + [(N + 1, False, True)] * R
    y_nrd = y.transpose(0, 1).contiguous().requires_grad_()
    out_t = gspmm_rel("mean", gt, y_nrd.transpose(0, 1), torch.from_numpy(w))
    out_t.sum().backward()
    assert torch.equal(out_t, out)
    assert torch.equal(y_nrd.grad, yk.grad.transpose(0, 1))
    with pytest.raises(ValueError, match="relations"):
        gspmm_rel("sum", gt, y[:2], weights)
    with pytest.raises(ValueError, match="sum or mean"):
        gspmm_rel("max", gt, y, weights)


@pytest.mark.parametrize("d_in,d_out,fuse,aggregate_first", [
    (7, 5, False, False), (5, 7, False, True), (7, 5, True, True)],
    ids=["project-first", "aggregate-first-by-widths", "fuse_relations"])
def test_rel_graph_conv_matches_flax(d_in, d_out, fuse, aggregate_first):
    """Both forms against the flax layer with the same fuse_relations; where
    the input is narrower the port aggregates first, the flax layer
    projects first (the same function)."""
    rng, gj, gt, w, w_pad = _problem(21)
    x = rng.standard_normal((N, d_in)).astype(np.float32)
    cot = rng.standard_normal((N, d_out)).astype(np.float32)
    fm = FlaxRelGraphConv(out_feats=d_out, num_relations=R, activation=jax.nn.relu,
                          fuse_relations=fuse)
    params = _np_tree(fm.init(jax.random.PRNGKey(0), gj, jnp.asarray(x),
                              jnp.asarray(w_pad))["params"])

    def loss(p, xx):
        return jnp.sum(fm.apply({"params": p}, gj, xx, jnp.asarray(w_pad)) * cot)

    out_j = np.asarray(fm.apply({"params": params}, gj, jnp.asarray(x), jnp.asarray(w_pad)))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    conv = RelGraphConv(d_in, d_out, R, activation=torch.relu, fuse_relations=fuse, device="cpu")
    assert conv.aggregate_first is aggregate_first
    conv.load_state_dict(rel_graph_conv_state_dict_from_flax(params))
    weights = RelEdgeWeights.build(gt, torch.from_numpy(w))
    xt = torch.from_numpy(x).requires_grad_()
    out = conv(gt, xt, weights)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for k, g_ref in rel_graph_conv_state_dict_from_flax(_np_tree(gp)).items():
        np.testing.assert_allclose(dict(conv.named_parameters())[k].grad.numpy(), g_ref.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("layers,fuse,out_f", [(2, False, 6), (3, False, 6), (3, True, 6),
                                               (3, False, 12)])
def test_rgcn_matches_flax(layers, fuse, out_f):
    """The driver's layout: node features ones((N, 1)), relu between layers;
    out_f 12 widens the last layer, as proteins' 112 tasks do, so it
    aggregates first."""
    rng, gj, gt, w, w_pad = _problem(30 + layers)
    hidden = 8
    x = np.ones((N, 1), np.float32)
    cot = rng.standard_normal((N, out_f)).astype(np.float32)
    fm = FlaxRGCN(hidden_feats=hidden, out_feats=out_f, num_relations=R, num_layers=layers,
                  fuse_relations=fuse)
    params = _np_tree(fm.init(jax.random.PRNGKey(1), gj, jnp.asarray(x),
                              jnp.asarray(w_pad))["params"])
    out_j = np.asarray(fm.apply({"params": params}, gj, jnp.asarray(x), jnp.asarray(w_pad)))
    gp = jax.grad(lambda p: jnp.sum(fm.apply({"params": p}, gj, jnp.asarray(x),
                                             jnp.asarray(w_pad)) * cot))(params)

    model = RGCN(1, hidden, out_f, R, layers, fuse_relations=fuse, device="cpu")
    model.load_state_dict(rgcn_state_dict_from_flax(params))
    out = model(gt, torch.from_numpy(x), RelEdgeWeights.build(gt, torch.from_numpy(w)))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=RTOL, atol=ATOL)
    sd_grads = rgcn_state_dict_from_flax(_np_tree(gp))
    params_t = dict(model.named_parameters())
    assert set(sd_grads) == set(params_t)
    for k, g_ref in sd_grads.items():
        np.testing.assert_allclose(params_t[k].grad.numpy(), g_ref.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_convert_rejects_unknown_groups_and_init_follows_torch():
    with pytest.raises(KeyError, match="unexpected RGCN parameter group"):
        rgcn_state_dict_from_flax({"dense_0": {}})
    conv = RelGraphConv(16, 32, 8, device="cpu", generator=torch.Generator().manual_seed(0))
    bound = np.sqrt(6.0 / (6.0 * 16 * 32))  # kaiming_uniform_(a=sqrt(5)), fan-in in · out
    assert conv.rel_weights.shape == (8, 16, 32)
    top = float(conv.rel_weights.detach().abs().max())
    assert 0.9 * bound < top <= bound
    assert not conv.skip.bias.any()


def _jax_common():
    """The JAX drivers' ``benchmarks/common.py`` (not a package module)."""
    spec = importlib.util.spec_from_file_location(
        "jax_benchmarks_common", os.path.join(ROOT, "benchmarks", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_masked_bce_and_mean_multilabel_auc_match_jax():
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((40, 12))).astype(np.float32)
    labels = (rng.random((40, 12)) < 0.3).astype(np.float32)
    labels[:, 3] = 0.0  # a task with one class only: left out of the mean
    mask = rng.random(40) < 0.6
    jc = _jax_common()
    ref = float(jc.masked_bce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    got = float(common.masked_bce(torch.from_numpy(logits), torch.from_numpy(labels),
                                  torch.from_numpy(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert common.mean_multilabel_auc(logits, labels) == jc.mean_multilabel_auc(logits, labels)
    assert np.isnan(common.mean_multilabel_auc(logits[:, 3:4], labels[:, 3:4]))
