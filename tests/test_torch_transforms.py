"""The port's copy of the edge-list transforms, on CPU tensors, against
``dgl_tpu.graph.transforms`` on the same numpy arrays: the same arrays, bit
for bit, dtype included."""

import numpy as np
import pytest
import torch

from dgl_tpu.graph import transforms as jt

from dgl_tpu_torch.graph import transforms as tt


def _edges(seed, n=60, e=400, dtype=np.int64):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(dtype)
    dst = rng.integers(0, n, e).astype(dtype)
    src[:20] = dst[:20]  # some self-loops
    src[20:40], dst[20:40] = src[40:60], dst[40:60]  # some duplicate edges
    return src, dst, n


def _same(a, b):
    for x, y in zip(a, b):
        x = x.numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("name", ["to_bidirected", "add_self_loops", "coalesce"])
def test_transform_matches_jax_package(name, dtype):
    src, dst, n = _edges(3, dtype=dtype)
    _same(getattr(tt, name)(*_t(src, dst), n), getattr(jt, name)(src, dst, n))


def test_remove_self_loops_matches_jax_package():
    src, dst, _ = _edges(4)
    got = tt.remove_self_loops(*_t(src, dst))
    _same(got, jt.remove_self_loops(src, dst))
    assert not torch.any(got[0] == got[1])


def test_add_self_loops_on_an_empty_edge_list():
    empty = np.zeros(0, np.int64)
    _same(tt.add_self_loops(*_t(empty, empty), 5), jt.add_self_loops(empty, empty, 5))


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_reindex_and_node_subgraph_match_jax_package(dtype):
    src, dst, n = _edges(5, dtype=dtype)
    ids = np.array([7, 3, 3, 59, 0, 12, 7], dtype=dtype)
    uniq, mapping = tt.reindex(torch.from_numpy(ids), n)
    juniq, jmapping = jt.reindex(ids, n)
    _same((uniq, mapping), (juniq, jmapping))
    nodes = np.array([12, 0, 40, 3, 59, 7], dtype=np.int64)
    got = tt.node_subgraph(*_t(src, dst), n, torch.from_numpy(nodes))
    _same(got, jt.node_subgraph(src, dst, n, nodes))


@pytest.mark.parametrize("name", ["to_bidirected_graph", "add_self_loops_graph"])
def test_graph_wrappers_match_jax_package(name):
    import dgl_tpu
    from dgl_tpu_torch.graph import from_edges

    src, dst, n = _edges(6)
    got = getattr(tt, name)(from_edges(src, dst, n, device="cpu"))
    want = getattr(jt, name)(dgl_tpu.from_edges(src, dst, n))
    ws, wd = want.edges_numpy()
    assert got.num_edges == want.num_edges and got.num_src_nodes == n
    np.testing.assert_array_equal(got.src.numpy(), ws)
    np.testing.assert_array_equal(got.dst.numpy(), wd)
