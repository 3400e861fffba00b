"""Positional sampled blocks in the port against the JAX package.

* ``gspmm`` over a block (``block_fanout`` set: a reshape and a reduce)
  against the same block with ``block_fanout=None`` (the CSR paths), sum,
  mean, max and min, values and gradients;
* ``SAGEConv`` and ``GATConv`` on a block with ``(x_src, x_dst)`` against the
  flax layers, weights carried by ``convert.py``, dropout off;
* ``GraphSAGE`` and ``GAT`` over a two-block minibatch that both packages'
  host samplers draw from one seed: the loss and every parameter's gradient
  against ``jax.value_and_grad`` of the JAX drivers' step loss.

Float32 on the CPU. Tolerances: values RTOL/ATOL, gradients GRAD_RTOL/ATOL
(the sums run in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgl_tpu.models import GAT as FlaxGAT
from dgl_tpu.models import GraphSAGE as FlaxGraphSAGE
from dgl_tpu.nn import GATConv as FlaxGATConv
from dgl_tpu.nn import SAGEConv as FlaxSAGEConv
from dgl_tpu.sampling import CSRGraph as JaxCSRGraph
from dgl_tpu.sampling import MultiLayerNeighborSampler as JaxSampler

import dgl_tpu_torch
from dgl_tpu_torch.benchmarks.common import masked_softmax_ce
from dgl_tpu_torch.convert import gat_state_dict_from_flax, sage_state_dict_from_flax
from dgl_tpu_torch.ops import gspmm
from dgl_tpu_torch.sampling import CSRGraph, MultiLayerNeighborSampler

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
N, E, FANOUTS, B = 300, 1800, [3, 2], 16
IN, HID, OUT = 12, 8, 5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _edges(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, N, E), rng.integers(0, N - 30, E)


def _blocks():
    """The port's and the JAX package's skeleton blocks for batch B."""
    return (MultiLayerNeighborSampler(FANOUTS).skeleton_blocks(B, "cpu"),
            JaxSampler(FANOUTS).skeleton_blocks(B))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("layer", [0, 1])
def test_positional_gspmm_matches_the_csr_paths(reduce, layer):
    block = _blocks()[0][layer]
    plain = dataclasses.replace(block, block_fanout=None)
    rng = np.random.default_rng(layer)
    x = torch.from_numpy(rng.standard_normal((block.num_src_nodes, 6)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((block.num_dst_nodes, 6)).astype(np.float32))
    outs, grads = [], []
    for g in (block, plain):
        xx = x.clone().requires_grad_()
        out = gspmm(g, "copy_u", reduce, x=xx)
        out.backward(cot)
        outs.append(out.detach())
        grads.append(xx.grad)
    torch.testing.assert_close(outs[0], outs[1], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(grads[0], grads[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert not grads[0][:block.num_dst_nodes].any()  # the dst slots feed no aggregation
    # the block's layout comes before the lowering: the same reshape either way
    assert torch.equal(gspmm(block, "copy_u", reduce, x=x, lowering="scatter"), outs[0])
    with pytest.raises(ValueError, match="num_src_nodes"):
        gspmm(block, "copy_u", reduce, x=x[:-1])


def _layer_inputs(layer, in_feats):
    bt, bj = (b[layer] for b in _blocks())
    x_src = np.random.default_rng(7).standard_normal((bt.num_src_nodes, in_feats)).astype(np.float32)
    nd = bt.num_dst_nodes
    return bt, bj, x_src, (torch.from_numpy(x_src), torch.from_numpy(x_src[:nd])), \
        (jnp.asarray(x_src), jnp.asarray(x_src[:nd]))


@pytest.mark.parametrize("in_feats,out_feats,aggr", [(12, 8, "mean"), (4, 9, "sum")])
def test_sageconv_on_a_block_matches_flax(in_feats, out_feats, aggr):
    bt, bj, _, xt, xj = _layer_inputs(0, in_feats)
    fc = FlaxSAGEConv(out_feats, aggr=aggr, activation=jax.nn.relu)
    params = _np_tree(fc.init(jax.random.PRNGKey(0), bj, xj)["params"])
    ref = np.asarray(fc.apply({"params": params}, bj, xj))
    tc = dgl_tpu_torch.SAGEConv(in_feats, out_feats, aggr, activation=torch.relu, device="cpu")
    sd = sage_state_dict_from_flax({"conv_0": params})
    tc.load_state_dict({k.removeprefix("convs.0."): v for k, v in sd.items()})
    got = tc(bt, xt).detach().numpy()
    assert got.shape == (bt.num_dst_nodes, out_feats)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("in_feats,out_feats,heads,residual",
                         [(12, 4, 2, False), (6, 3, 2, True), (8, 8, 1, True)])
def test_gatconv_on_a_block_matches_flax(fused, in_feats, out_feats, heads, residual):
    """``fused`` does not matter on a block: both take the positional form."""
    bt, bj, _, xt, xj = _layer_inputs(1, in_feats)
    fc = FlaxGATConv(out_feats, num_heads=heads, residual=residual, activation=jax.nn.elu)
    params = _np_tree(fc.init(jax.random.PRNGKey(0), bj, xj)["params"])
    ref = np.asarray(fc.apply({"params": params}, bj, xj))
    tc = dgl_tpu_torch.GATConv(in_feats, out_feats, heads, residual=residual,
                               activation=torch.nn.functional.elu, fused=fused, device="cpu")
    sd = gat_state_dict_from_flax({"gat_0": params})
    tc.load_state_dict({k.removeprefix("convs.0."): v for k, v in sd.items()})
    got = tc(bt, xt).detach().numpy()
    assert got.shape == (bt.num_dst_nodes, heads, out_feats)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _minibatch(seed=3):
    """One two-block minibatch from both packages' host samplers, one seed."""
    src, dst = _edges(seed)
    seeds = np.random.default_rng(seed).choice(N, B - 3, replace=False)
    mt = MultiLayerNeighborSampler(FANOUTS).sample(
        CSRGraph.from_edges(src, dst, N, device="cpu"), seeds, np.random.default_rng(seed), B,
        device="cpu")
    mj = JaxSampler(FANOUTS).sample(JaxCSRGraph.from_edges(src, dst, N), seeds,
                                    np.random.default_rng(seed), B)
    np.testing.assert_array_equal(mt.input_nodes.numpy(), np.asarray(mj.input_nodes))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((N, IN)).astype(np.float32)
    y = rng.integers(0, OUT, N)
    return mt, mj, x, y


def _check_step(fm, tm, to_state_dict, mj, mt, x, y):
    """The JAX drivers' step loss (masked cross-entropy of the training
    forward on the seeds) and its gradients, against the port's."""
    bx = jnp.take(jnp.asarray(x), mj.input_nodes, axis=0)
    params = _np_tree(fm.init(jax.random.PRNGKey(1), mj.blocks, bx)["params"])
    by = jnp.take(jnp.asarray(y), mj.seeds, axis=0)

    def loss_fn(p):
        logits = fm.apply({"params": p}, mj.blocks, bx, deterministic=True)
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(logp, by[:, None], 1)[:, 0]
        m = mj.seed_mask.astype(ce.dtype)
        return jnp.sum(ce * m) / jnp.maximum(jnp.sum(m), 1.0)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    tm.load_state_dict(to_state_dict(params))
    tm.train()
    bx_t = torch.from_numpy(x)[mt.input_nodes.long()]
    logits = tm(mt.blocks, bx_t)
    assert logits.shape == (B, OUT)
    loss = masked_softmax_ce(logits, torch.from_numpy(y)[mt.seeds.long()], mt.seed_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL, atol=ATOL)
    want = to_state_dict(_np_tree(grads_j))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


def test_graphsage_over_blocks_matches_flax_loss_and_gradients():
    mt, mj, x, y = _minibatch()
    fm = FlaxGraphSAGE(hidden_feats=HID, out_feats=OUT, num_layers=2, dropout=0.0)
    tm = dgl_tpu_torch.GraphSAGE(IN, HID, OUT, num_layers=2, dropout=0.0, device="cpu")
    _check_step(fm, tm, sage_state_dict_from_flax, mj, mt, x, y)
    with pytest.raises(ValueError, match="expected 2 blocks"):
        tm(mt.blocks[:1], torch.zeros(mt.blocks[0].num_src_nodes, IN))


@pytest.mark.parametrize("fused", [False, True])
def test_gat_over_blocks_matches_flax_loss_and_gradients(fused):
    mt, mj, x, y = _minibatch(4)
    fm = FlaxGAT(hidden_feats=4, out_feats=OUT, heads=(3, 1), remat=False)
    tm = dgl_tpu_torch.GAT(IN, 4, OUT, (3, 1), fused=fused, device="cpu")
    _check_step(fm, tm, gat_state_dict_from_flax, mj, mt, x, y)
