"""Port parity: the CSR graph equals the JAX package's canonical arrays."""

import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu_torch


def _edges(rng, n_src, n_dst, e):
    return rng.integers(0, n_src, e), rng.integers(0, n_dst, e)


@pytest.mark.parametrize(
    "n_src,n_dst,e,isolated",
    [(200, None, 2000, False), (200, None, 600, True), (150, 90, 1200, False)],
)
def test_from_edges_matches_jax(n_src, n_dst, e, isolated):
    rng = np.random.default_rng(n_src + e)
    nd = n_src if n_dst is None else n_dst
    src, dst = _edges(rng, n_src, nd, e)
    if isolated:
        # nodes 100..199 neither send nor receive
        src, dst = src % 100, dst % 100
    ref = dgl_tpu.from_edges(src, dst, n_src, n_dst)
    got = dgl_tpu_torch.from_edges(src, dst, n_src, n_dst, device="cpu")
    assert got.num_edges == ref.num_edges == e
    assert (got.num_src_nodes, got.num_dst_nodes) == (ref.num_src_nodes, ref.num_dst_nodes)
    for g_t, g_j in ((got, ref), (got.reverse, ref.reverse)):
        for name in ("src", "dst", "eid"):
            a = getattr(g_t, name)
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(g_j, name))[:e], err_msg=name)
        np.testing.assert_array_equal(g_t.indptr.numpy(), np.asarray(g_j.indptr))
    np.testing.assert_array_equal(got.in_degrees().numpy(), np.asarray(ref.in_degrees()))
    np.testing.assert_array_equal(got.out_degrees().numpy(), np.asarray(ref.out_degrees()))
    np.testing.assert_array_equal(got.in_degrees().numpy(), np.bincount(dst, minlength=nd))
    np.testing.assert_array_equal(got.out_degrees().numpy(), np.bincount(src, minlength=n_src))
    # the reverse has no reverse of its own: its out-degrees count sources
    np.testing.assert_array_equal(got.reverse.out_degrees().numpy(), got.in_degrees().numpy())
    if isolated:
        assert int(got.in_degrees()[100:].sum()) == 0 and int(got.out_degrees()[100:].sum()) == 0


@pytest.mark.parametrize(
    "src,dst,n_src,n_dst",
    [([0, 5], [1, 2], 5, None), ([0, 1], [1, 9], 10, 9), ([-1, 0], [0, 0], 4, None)],
)
def test_from_edges_out_of_range_raises(src, dst, n_src, n_dst):
    with pytest.raises(ValueError, match="out of range"):
        dgl_tpu_torch.from_edges(src, dst, n_src, n_dst, device="cpu")


def test_graph_to_and_empty():
    g = dgl_tpu_torch.from_edges([], [], 3, device="cpu")
    assert g.num_edges == 0 and g.indptr.tolist() == [0, 0, 0, 0]
    g2 = g.to("cpu")
    assert g2.reverse is not None and g2.reverse.num_edges == 0
    with pytest.raises(ValueError, match="1-D and equal length"):
        dgl_tpu_torch.from_edges([0, 1], [0], 3, device="cpu")
