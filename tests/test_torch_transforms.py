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
