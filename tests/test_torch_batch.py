"""Port parity: batched graphs (the block-diagonal union against the JAX
package's padded batch with its padding removed), the readouts (values and
gradients), the pooling modules, and the graph-classification loader
(the first epoch's batches, the per-epoch reshuffle, edge features in
canonical order, errors raised from the prefetch thread, which an early
close stops)."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgl_tpu.data import synthetic as jax_synthetic
from dgl_tpu.graph.batch import batch_graphs as jax_batch_graphs
from dgl_tpu.graph.batch import readout as jax_readout
from dgl_tpu.sampling.dataloader import GraphBatchLoader as JaxGraphBatchLoader

from dgl_tpu_torch.graph import GraphBatch, batch_graphs, readout
from dgl_tpu_torch.graph.split import SPLIT_T
from dgl_tpu_torch.kernels.seg_sum import seg_sum
from dgl_tpu_torch.nn import AvgPooling, MaxPooling, SumPooling
from dgl_tpu_torch.sampling import GraphBatchLoader, prefetch

RTOL, ATOL = 1e-5, 1e-6  # float32 sums of tens of terms


def _graphs(name="ogbg-molhiv", n=20, seed=0):
    return jax_synthetic.synthetic_graph_classification(name, seed=seed, num_graphs=n)


def _np(a):
    return np.asarray(a)


def test_batch_graphs_matches_jax_batch_without_padding():
    data = _graphs("ENZYMES", 13)
    gs = data.graphs + [(np.zeros(0, np.int64), np.zeros(0, np.int64), 4)]  # an edgeless graph
    ref = jax_batch_graphs(gs)
    got = batch_graphs(gs, device="cpu")
    n, e = got.graph.num_dst_nodes, got.graph.num_edges
    assert n == sum(k for _, _, k in gs) and e == sum(len(s) for s, _, _ in gs)
    assert ref.graph.num_edges == e and ref.num_nodes_padded >= n
    g, rg = got.graph, ref.graph
    for name in ("src", "dst", "eid"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), _np(getattr(rg, name))[:e])
        np.testing.assert_array_equal(getattr(g.reverse, name).numpy(),
                                      _np(getattr(rg.reverse, name))[:e])
    np.testing.assert_array_equal(g.indptr.numpy(), _np(rg.indptr)[: n + 1])
    np.testing.assert_array_equal(g.reverse.indptr.numpy(), _np(rg.reverse.indptr)[: n + 1])
    np.testing.assert_array_equal(got.node_gid.numpy(), _np(ref.node_gid)[:n])
    np.testing.assert_array_equal(got.num_nodes_per_graph.numpy(), _np(ref.num_nodes_per_graph))
    np.testing.assert_array_equal(got.graph_indptr.numpy(),
                                  np.cumsum([0] + [k for _, _, k in gs]))
    assert got.num_graphs == len(gs) and got.graph_split.num_rows == len(gs)
    torch.testing.assert_close(got.graph_mask(), torch.ones(len(gs)))
    assert got.graph_split.num_long == 0 and g.split.num_long == 0


def test_batch_to_and_pin_memory_keep_every_array():
    got = batch_graphs(_graphs("ENZYMES", 3).graphs, device="cpu")
    moved = got.to("cpu", non_blocking=True)
    assert isinstance(moved, GraphBatch) and moved.num_graphs == got.num_graphs
    assert torch.equal(moved.graph.reverse.src, got.graph.reverse.src)
    assert torch.equal(moved.graph_split.chunks, got.graph_split.chunks)


@pytest.mark.parametrize("op", ["mean", "sum", "max"])
def test_readout_matches_jax(op):
    rng = np.random.default_rng(1)
    gs = _graphs("ENZYMES", 11, seed=1).graphs
    gs.insert(4, (np.zeros(0, np.int64), np.zeros(0, np.int64), 0))  # a graph with no node
    ref_b = jax_batch_graphs(gs)
    got_b = batch_graphs(gs, device="cpu")
    n = got_b.graph.num_dst_nodes
    x = rng.standard_normal((n, 2, 5)).astype(np.float32)
    x_pad = np.zeros((ref_b.num_nodes_padded, 2, 5), np.float32)
    x_pad[:n] = x
    cot = rng.standard_normal((len(gs), 2, 5)).astype(np.float32)
    ref = _np(jax_readout(ref_b, jnp.asarray(x_pad), op))
    g_ref = _np(jax.grad(lambda a: jnp.sum(jax_readout(ref_b, a, op) * cot))(jnp.asarray(x_pad)))
    xt = torch.from_numpy(x).requires_grad_()
    before = seg_sum.launches
    pool = {"mean": AvgPooling(), "sum": SumPooling(), "max": MaxPooling()}[op]
    out = pool(got_b, xt)
    torch.testing.assert_close(out, readout(got_b, xt, op))
    (out * torch.from_numpy(cot)).sum().backward()
    assert seg_sum.launches == before  # CPU tensors launch nothing
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), g_ref[:n], rtol=RTOL, atol=ATOL)
    assert np.all(out.detach().numpy()[4] == 0)  # the empty graph reads out 0


def test_readout_rejects_unknown_op():
    b = batch_graphs(_graphs("ENZYMES", 2).graphs, device="cpu")
    with pytest.raises(ValueError, match="unknown readout op"):
        readout(b, torch.zeros(b.graph.num_dst_nodes, 3), "min")


def _port_loader(data, bs, **kw):
    return GraphBatchLoader(data.graphs, data.node_feats, data.labels, bs,
                            edge_feats=data.edge_feats, device="cpu", **kw)


def test_first_epoch_matches_the_jax_loader():
    data = _graphs("ogbg-molhiv", 45, seed=2)
    ref = JaxGraphBatchLoader(data.graphs, data.node_feats, data.labels, 8,
                              edge_feats=data.edge_feats, shuffle=True, seed=3)
    got = _port_loader(data, 8, seed=3)
    ref_batches, got_batches = list(ref), list(got)
    assert len(got_batches) == len(ref_batches) == len(got) == 6
    for (b, nf, ef, y), (rb, rnf, ref_ef, ry) in zip(got_batches, ref_batches):
        k, n, e = b.num_graphs, b.graph.num_dst_nodes, b.graph.num_edges
        assert k == int(_np(rb.graph_mask()).sum())
        np.testing.assert_array_equal(y.numpy(), _np(ry)[:k])
        np.testing.assert_array_equal(nf.numpy(), _np(rnf)[:n])
        np.testing.assert_array_equal(ef.numpy(), _np(ref_ef)[:e])  # canonical order
        np.testing.assert_array_equal(b.graph.src.numpy(), _np(rb.graph.src)[:e])
        np.testing.assert_array_equal(b.num_nodes_per_graph.numpy(),
                                      _np(rb.num_nodes_per_graph)[:k])


def test_edge_features_follow_the_canonical_order():
    data = _graphs("ogbg-ppa", 6, seed=4)
    b, _, ef, _ = next(iter(_port_loader(data, 6, shuffle=False)))
    flat = np.concatenate(data.edge_feats)
    offsets = np.cumsum([0] + [n for _, _, n in data.graphs])
    src = np.concatenate([s + o for (s, _, _), o in zip(data.graphs, offsets)])
    dst = np.concatenate([d + o for (_, d, _), o in zip(data.graphs, offsets)])
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(ef.numpy(), flat[order])
    np.testing.assert_array_equal(b.graph.src.numpy(), src[order])


def test_composition_is_reshuffled_every_epoch():
    """The port reshuffles batch composition every epoch, as the
    reference's GraphDataLoader does; the JAX loader replays its first
    epoch's batches (a documented deviation, not followed)."""
    data = _graphs("ENZYMES", 40, seed=5)
    ldr = GraphBatchLoader(data.graphs, data.node_feats, np.arange(40), 8, device="cpu", seed=0)
    epochs = [[frozenset(y.tolist()) for _, _, _, y in ldr] for _ in range(2)]
    assert sorted(i for b in epochs[1] for i in b) == list(range(40))
    assert set(epochs[0]) != set(epochs[1])
    unshuffled = GraphBatchLoader(data.graphs, data.node_feats, np.arange(40), 16, device="cpu",
                                  shuffle=False)
    assert [y.tolist() for _, _, _, y in unshuffled] == [list(range(16)), list(range(16, 32)),
                                                        list(range(32, 40))]


def test_prefetch_raises_the_workers_error():
    def items():
        yield 1
        yield 2
        raise KeyError("collate failed")

    it = prefetch(items(), depth=1)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="collate failed"):
        next(it)
    assert list(prefetch(iter(range(5)))) == [0, 1, 2, 3, 4]


def test_prefetch_closed_early_stops_its_worker():
    """main_gcn's profile stops an epoch after a few steps: closing the
    consumer ends the worker, which produced at most one item more than the
    queue holds, and leaves no thread behind."""
    produced = []

    def items():
        for i in range(1000):
            produced.append(i)
            yield i

    before = set(threading.enumerate())
    it = prefetch(items(), depth=2)
    assert next(it) == 0 and next(it) == 1
    (worker,) = [t for t in threading.enumerate() if t not in before and "worker" in t.name]
    it.close()
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert len(produced) <= 2 + 2 + 1  # taken, queued, and the one it was putting


def test_batches_of_the_suite_hold_no_long_row():
    """A molhiv batch of 64 graphs has no row over T: the split's combine
    does not launch."""
    b, _, _, _ = next(iter(_port_loader(_graphs("ogbg-molhiv", 64, seed=6), 64)))
    assert max(int(b.graph.in_degrees().max()), int(b.graph.out_degrees().max()),
               int(b.num_nodes_per_graph.max())) <= SPLIT_T
    assert (b.graph.split.num_long, b.graph.reverse.split.num_long,
            b.graph_split.num_long) == (0, 0, 0)
