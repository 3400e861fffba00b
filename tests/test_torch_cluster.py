"""The port's ClusterIter against the JAX package's on the same numpy
inputs and seed, over two epochs: the same batches (the JAX batch's
unpadded prefix of nodes, its relabelled edges in canonical order, x, y and
the train mask, and with negatives the negative graph's edges, drawn in
the same order after ``first()``), the same ``has_train``; and the batch
graph built on the host (``_host_graph``) equal to ``from_edges``."""

import numpy as np
import pytest
import torch

from dgl_tpu.sampling.cluster import ClusterIter as JaxClusterIter

from dgl_tpu_torch.graph import from_edges
from dgl_tpu_torch.sampling.cluster import ClusterIter, _host_graph

N, E, F = 900, 6000, 5


def _data(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N - 30, E)  # the last 30 nodes isolated
    dst = rng.integers(0, N - 30, E)
    src[: E // 8] = 3  # a hub
    x = rng.standard_normal((N, F)).astype(np.float32)
    y = rng.integers(0, 7, N)
    train = rng.random(N) < 0.3
    train[:200] = False  # some parts may hold no train node
    return src, dst, x, y, train


def _valid(graph, e):
    """The JAX graph's canonical edges: the first e, then sentinels."""
    s, d = np.asarray(graph.src), np.asarray(graph.dst)
    assert (d[e:] >= graph.num_dst_nodes).all() if len(d) > e else True
    return s[:e], d[:e]


def _same_graph(ours, theirs_graph):
    e = ours.num_edges
    s, d = _valid(theirs_graph, e)
    np.testing.assert_array_equal(ours.src.numpy(), s)
    np.testing.assert_array_equal(ours.dst.numpy(), d)
    assert ours.num_src_nodes == ours.num_dst_nodes


@pytest.mark.parametrize("negatives,method", [(False, "metis"), (True, "metis"), (False, "lp")])
def test_batches_equal_the_jax_iterator_over_two_epochs(tmp_path, negatives, method):
    src, dst, x, y, train = _data(1)
    kw = dict(method=method, seed=4, with_negatives=negatives)
    if method == "lp":  # lp's rounds race across OpenMP threads: one thread, one answer
        from dgl_tpu_torch.csrc import native
        before = native.load().omp_get_max_threads()
        native.load().omp_set_num_threads(1)
    try:
        theirs = JaxClusterIter("t", src, dst, N, x, y, train, 24, 5,
                                cache_dir=str(tmp_path / "jax"), **kw)
        ours = ClusterIter("t", src, dst, N, x, y, train, 24, 5,
                           cache_dir=str(tmp_path / "port"), device="cpu", **kw)
    finally:
        if method == "lp":
            native.load().omp_set_num_threads(before)
    assert len(ours) == len(theirs) == 5
    assert ours.part_stats == theirs.part_stats
    # first() draws from the stream with negatives, as the JAX drivers' model.init does
    firsts = [ours.first(), theirs.first()]
    np.testing.assert_array_equal(firsts[0].nodes, firsts[1].nodes)
    for epoch in range(2):
        mine, want = list(ours), list(theirs)
        assert len(mine) == len(want) == 5
        for b, t in zip(mine, want):
            n = len(b.nodes)
            np.testing.assert_array_equal(b.nodes, t.nodes)
            _same_graph(b.graph, t.graph)
            np.testing.assert_array_equal(b.x.numpy(), np.asarray(t.x)[:n])
            np.testing.assert_array_equal(b.y.numpy(), np.asarray(t.y)[:n])
            np.testing.assert_array_equal(b.mask.numpy(), np.asarray(t.mask)[:n])
            assert b.has_train == t.has_train == bool(train[b.nodes].any())
            if negatives:
                _same_graph(b.neg_graph, t.neg_graph)
            else:
                assert b.neg_graph is None
        assert sorted(np.concatenate([b.nodes for b in mine]).tolist()) == list(range(N))
    assert len(ours.collate_s) == 11  # first() and two epochs of five


@pytest.mark.parametrize("n,e", [(50, 400), (7, 0), (300, 3000)])
def test_host_graph_equals_from_edges(n, e):
    rng = np.random.default_rng(n)
    s, d = rng.integers(0, n, e), rng.integers(0, n, e)
    if e:
        d[: e // 2] = 1  # a long row
    got, want = _host_graph(s, d, n), from_edges(s, d, n, device="cpu")
    for a, b in ((got, want), (got.reverse, want.reverse)):
        for f in ("src", "dst", "indptr", "eid"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(a.split.chunks, b.split.chunks)
        assert torch.equal(a.split.rows, b.split.rows)
        assert (a.num_src_nodes, a.num_dst_nodes) == (b.num_src_nodes, b.num_dst_nodes)


def test_a_consumer_that_stops_early_stops_the_thread(tmp_path):
    import threading
    import time

    src, dst, x, y, train = _data(2)
    it = ClusterIter("s", src, dst, N, x, y, train, 24, 2, cache_dir=str(tmp_path), device="cpu")
    threads = threading.active_count()
    for i, _ in enumerate(it):
        if i == 1:
            break
    for _ in range(50):
        if threading.active_count() <= threads:
            break
        time.sleep(0.05)
    assert threading.active_count() <= threads


def test_cluster_iter_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src, dst, x, y, train = _data(3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterIter("d", src, dst, N, x, y, train, 24, 2)
