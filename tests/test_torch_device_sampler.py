"""DeviceNeighborSampler, run here on the CPU: the port of
tests/test_sampling.py::test_device_sampler_matches_host_structure (the
host sampler's skeletons, seeds in the first B slots, every draw a true
in-neighbour or the node itself, a hub's draws diverse), the JAX device
sampler's structure, and a chi-square test that a hub's draws are uniform
over its in-neighbours."""

import numpy as np
import torch
from scipy import stats

import jax
from dgl_tpu.sampling import CSRGraph as JaxCSRGraph
from dgl_tpu.sampling import DeviceNeighborSampler as JaxDeviceSampler

from dgl_tpu_torch.sampling import CSRGraph, DeviceNeighborSampler, MultiLayerNeighborSampler

P_MIN = 1e-3  # the chi-square test's p-value must exceed this (a fixed generator: no flake)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_structure_matches_the_host_sampler_and_draws_are_in_neighbours():
    rng = np.random.default_rng(0)
    n, ne = 200, 900
    src, dst = rng.integers(0, n, ne), rng.integers(0, n, ne)
    csr = CSRGraph.from_edges(src, dst, n, device="cpu")
    fanouts, b = [3, 2], 16
    host = MultiLayerNeighborSampler(fanouts)
    dev = DeviceNeighborSampler(csr, fanouts, device="cpu")
    seeds = rng.choice(n, b, replace=False)
    mb_h = host.sample(csr, seeds, np.random.default_rng(0), b, device="cpu")
    mb_d = next(dev.batches(seeds, b, _gen(0)))
    assert len(mb_h.blocks) == len(mb_d.blocks)
    for bh, bd in zip(mb_h.blocks, mb_d.blocks):
        assert (bh.num_src_nodes, bh.num_dst_nodes) == (bd.num_src_nodes, bd.num_dst_nodes)
        assert torch.equal(bh.src, bd.src) and torch.equal(bh.dst, bd.dst)
    inp = mb_d.input_nodes.numpy()
    assert mb_d.input_nodes.dtype == torch.int32 and inp.shape == mb_h.input_nodes.shape
    np.testing.assert_array_equal(inp[:b], seeds)
    # the JAX device sampler's layout too
    mb_j = JaxDeviceSampler(JaxCSRGraph.from_edges(src, dst, n), fanouts).sample(
        seeds, jax.random.PRNGKey(0), b)
    assert np.asarray(mb_j.input_nodes).shape == inp.shape
    nbrs = {v: set(src[dst == v].tolist()) for v in range(n)}
    cur, off = inp[:b], b
    for fanout in reversed(fanouts):  # slots [off, off + len(cur)·fanout): fanout per parent
        samp = inp[off: off + len(cur) * fanout].reshape(len(cur), fanout)
        for parent, row in zip(cur, samp):
            allowed = nbrs[parent] or {parent}
            assert set(row.tolist()) <= allowed, (parent, row, allowed)
        cur = inp[: off + len(cur) * fanout]
        off = len(cur)


def _hub_sampler(n_nbrs, fanout):
    csr = CSRGraph.from_edges(np.arange(n_nbrs), np.zeros(n_nbrs, np.int64), n_nbrs + 1,
                              device="cpu")
    return DeviceNeighborSampler(csr, [fanout], device="cpu")


def test_a_hubs_draws_are_diverse_and_uniform():
    dev = _hub_sampler(100, 50)
    draws = next(dev.batches(np.zeros(4, np.int64), 4, _gen(1))).input_nodes[4:].numpy()
    assert len(np.unique(draws)) > 25  # ~50 draws × 4 seeds from 100 neighbours
    # 40 seeds × 50 slots = 2,000 draws over 100 neighbours, 20 expected each
    draws = next(dev.batches(np.zeros(40, np.int64), 40, _gen(2))).input_nodes[40:].numpy()
    counts = np.bincount(draws, minlength=101)
    assert counts[100] == 0  # node 100 is no in-neighbour of the hub
    p = stats.chisquare(counts[:100]).pvalue
    assert p > P_MIN, (p, counts)


def test_isolated_nodes_sample_themselves_and_batches_pad():
    # node 0 ← 1; nodes 1..5 have no in-edge, node 5 the last (indptr[5] = E)
    csr = CSRGraph.from_edges(np.array([1]), np.array([0]), 6, device="cpu")
    dev = DeviceNeighborSampler(csr, [2, 3], device="cpu")
    batches = list(dev.batches(np.array([5, 0, 3]), 2, _gen(3)))
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[1].seeds.numpy(), [3, 0])
    np.testing.assert_array_equal(batches[1].seed_mask.numpy(), [True, False])
    inp = batches[0].input_nodes.numpy()
    np.testing.assert_array_equal(inp[:2], [5, 0])
    np.testing.assert_array_equal(inp[2:8], [5, 5, 5, 1, 1, 1])  # 5 itself, 0's one neighbour
    assert batches[0].input_nodes.shape[0] == batches[0].blocks[0].num_src_nodes == 2 * 4 * 3


def test_same_generator_state_same_draws():
    dev = _hub_sampler(50, 7)
    a = next(dev.batches(np.zeros(8, np.int64), 8, _gen(4))).input_nodes
    b = next(dev.batches(np.zeros(8, np.int64), 8, _gen(4))).input_nodes
    assert torch.equal(a, b)
