"""The port's host sampling against the JAX package's: CSRGraph, the
sampler's minibatches (input_nodes, seeds and mask bit for bit; every
skeleton block and its reverse equal to the JAX skeleton's unpadded prefix),
with and without replacement, and NodeDataLoader's batches in order over two
epochs, the last one padded."""

import numpy as np
import pytest
import torch

from dgl_tpu.sampling import CSRGraph as JaxCSRGraph
from dgl_tpu.sampling import MultiLayerNeighborSampler as JaxSampler
from dgl_tpu.sampling import NodeDataLoader as JaxLoader

from dgl_tpu_torch.sampling import CSRGraph, MiniBatch, MultiLayerNeighborSampler, NodeDataLoader

N, E = 300, 1500


def _edges(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N - 40, E)  # the last 40 nodes have no in-edge
    dst[:200] = 7  # a hub
    return src, dst


def _assert_block_equal(bt, bj):
    n_e = bt.num_edges
    assert (bt.num_src_nodes, bt.num_dst_nodes, n_e) == (bj.num_src_nodes, bj.num_dst_nodes,
                                                         bj.num_edges)
    for name in ("src", "dst", "eid"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                      np.asarray(getattr(bj, name))[:n_e], err_msg=name)
    np.testing.assert_array_equal(bt.indptr.numpy(), np.asarray(bj.indptr))


def test_csr_graph_equals_the_jax_one():
    src, dst = _edges()
    ours = CSRGraph.from_edges(src, dst, N, device="cpu")
    theirs = JaxCSRGraph.from_edges(src, dst, N)
    assert ours.num_nodes == theirs.num_nodes
    assert ours.indptr.dtype == np.int64 and ours.indices.dtype == np.int64
    np.testing.assert_array_equal(ours.indptr, theirs.indptr)
    np.testing.assert_array_equal(ours.indices, theirs.indices)
    with pytest.raises(ValueError, match="out of range"):
        CSRGraph.from_edges(src, np.full(E, N), N, device="cpu")


@pytest.mark.parametrize("replace", [True, False])
@pytest.mark.parametrize("fanouts,b,b_pad", [([3, 2], 16, 16), ([4, 5, 2], 11, 16)])
def test_sample_equals_the_jax_sampler(replace, fanouts, b, b_pad):
    src, dst = _edges(1)
    csr = CSRGraph.from_edges(src, dst, N, device="cpu")
    csr_j = JaxCSRGraph.from_edges(src, dst, N)
    seeds = np.random.default_rng(2).choice(N, b, replace=False)
    seeds[0] = 7
    ours = MultiLayerNeighborSampler(fanouts, replace=replace)
    theirs = JaxSampler(fanouts, replace=replace)
    for step in range(2):  # the second step reuses the cached skeletons
        mb = ours.sample(csr, seeds, np.random.default_rng(step), b_pad, device="cpu")
        mj = theirs.sample(csr_j, seeds, np.random.default_rng(step), b_pad)
        assert isinstance(mb, MiniBatch) and mb.input_nodes.dtype == torch.int32
        np.testing.assert_array_equal(mb.input_nodes.numpy(), np.asarray(mj.input_nodes))
        np.testing.assert_array_equal(mb.seeds.numpy(), np.asarray(mj.seeds))
        np.testing.assert_array_equal(mb.seed_mask.numpy(), np.asarray(mj.seed_mask))
        assert len(mb.blocks) == len(fanouts)
        for bt, bj, f in zip(mb.blocks, mj.blocks, fanouts):
            assert bt.block_fanout == bj.block_fanout == f and bt.is_block
            _assert_block_equal(bt, bj)
            _assert_block_equal(bt.reverse, bj.reverse)
            assert bt.split.num_long == 0 and bt.reverse.split.num_long == 0
        assert mb.input_nodes.shape[0] == mb.blocks[0].num_src_nodes
    assert ours.skeleton_blocks(b_pad, "cpu") is mb.blocks  # built once per (b_pad, device)


def test_blocks_chain_and_seeds_lead():
    src, dst = _edges(3)
    csr = CSRGraph.from_edges(src, dst, N, device="cpu")
    mb = MultiLayerNeighborSampler([3, 2]).sample(csr, np.arange(5), np.random.default_rng(0),
                                                  8, device="cpu")
    assert mb.blocks[1].num_src_nodes == mb.blocks[0].num_dst_nodes == 8 * 3
    assert mb.blocks[1].num_dst_nodes == 8
    np.testing.assert_array_equal(mb.input_nodes[:8].numpy(), [0, 1, 2, 3, 4, 0, 0, 0])
    np.testing.assert_array_equal(mb.seed_mask.numpy(), [True] * 5 + [False] * 3)
    moved = mb.to("cpu")
    assert moved.input_nodes is mb.input_nodes  # already there: no copy
    assert [b.block_fanout for b in moved.blocks] == [3, 2]  # Graph.to keeps the layout
    with pytest.raises(ValueError, match="do not fit"):
        MultiLayerNeighborSampler([2]).sample(csr, np.arange(9), np.random.default_rng(0), 8,
                                              device="cpu")
    with pytest.raises(ValueError, match="at most 64"):
        MultiLayerNeighborSampler([65], replace=False)


@pytest.mark.parametrize("replace,drop_last", [(True, False), (False, False), (True, True)])
def test_loader_gives_the_jax_loaders_batches_over_two_epochs(replace, drop_last):
    src, dst = _edges(4)
    nids = np.random.default_rng(5).choice(N, 70, replace=False)
    csr, csr_j = CSRGraph.from_edges(src, dst, N, device="cpu"), JaxCSRGraph.from_edges(src, dst, N)
    ours = NodeDataLoader(csr, nids, MultiLayerNeighborSampler([3, 2], replace=replace), 16,
                          seed=9, drop_last=drop_last, device="cpu")
    theirs = JaxLoader(csr_j, nids, JaxSampler([3, 2], replace=replace), 16, seed=9,
                       drop_last=drop_last)
    assert len(ours) == len(theirs) == (4 if drop_last else 5)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for mb, mj in zip(got, want):
            for name in ("input_nodes", "seeds", "seed_mask"):
                np.testing.assert_array_equal(getattr(mb, name).numpy(),
                                              np.asarray(getattr(mj, name)), err_msg=name)
        if not drop_last:  # 70 = 4 · 16 + 6: the last batch is padded
            assert got[-1].seed_mask.sum().item() == 6 and got[-1].seeds[6:].eq(0).all()
        seen = np.concatenate([mb.seeds[mb.seed_mask].numpy() for mb in got])
        assert len(seen) == len(set(seen.tolist())) == (64 if drop_last else 70)
