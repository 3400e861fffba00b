"""The row split (``dgl_tpu_torch/graph/split.py``): the plan of a CSR's
long rows that K1, K2 and both K3 passes take, built on the host with the
graph.

The plan must cover every edge of every long row exactly once, in
ascending order, in chunks of at most T edges, and list no row of at most
T edges; ``from_edges`` builds one for each CSR, ``Graph.to`` carries it,
the wrappers refuse a plan that does not match their ``indptr`` (on CPU
tensors too), and every op of the package hands the kernels the graph's
own plan, so none builds one from a device ``indptr``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dgl_tpu_torch
from dgl_tpu_torch.graph.split import SPLIT_T, RowSplit, row_split
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_fwd
from dgl_tpu_torch.kernels.seg_sum import seg_sum


def _indptr(degrees):
    out = np.zeros(len(degrees) + 1, np.int64)
    np.cumsum(degrees, out=out[1:])
    return out


def _degree_cases(t):
    rng = np.random.default_rng(t)
    return {
        "around_t": [0, t - 1, t, t + 1, 2 * t, 2 * t + 1, 0, 1, 3 * t + 2],
        "all_long": [t + 1 + i for i in range(20)],
        "no_long": [t] * 3 + rng.integers(0, t + 1, 50).tolist(),
        "empty_rows_only": [0] * 6,  # E = 0
        "skewed": (rng.zipf(1.3, 200) % (20 * t)).tolist(),
    }


def _check_plan(plan: RowSplit, indptr: np.ndarray, t: int):
    deg = np.diff(indptr)
    assert plan.t == t
    assert (plan.num_rows, plan.num_edges) == (len(indptr) - 1, int(indptr[-1]))
    rows = plan.rows.numpy()
    ptr = plan.chunk_ptr.numpy()
    chunks = plan.chunks.numpy().reshape(-1, 2)
    assert plan.rows.dtype == plan.chunk_ptr.dtype == plan.chunks.dtype == torch.int64
    # exactly the rows of more than t edges, ascending, and no chunk for the others
    np.testing.assert_array_equal(rows, np.flatnonzero(deg > t))
    assert ptr[0] == 0 and ptr[-1] == len(chunks) == plan.num_chunks
    assert len(ptr) == plan.num_long + 1 and np.all(np.diff(ptr) >= 1)
    sizes = chunks[:, 1] - chunks[:, 0]
    assert np.all(sizes >= 1) and np.all(sizes <= t)
    for i, r in enumerate(rows):
        own = chunks[ptr[i]:ptr[i + 1]]
        # the chunks tile the row: contiguous, ascending, first to last edge
        assert own[0, 0] == indptr[r] and own[-1, 1] == indptr[r + 1]
        np.testing.assert_array_equal(own[1:, 0], own[:-1, 1])
    # every edge of every long row in exactly one chunk
    covered = np.zeros(int(indptr[-1]), np.int64)
    for b, e in chunks:
        covered[b:e] += 1
    long_edge = np.repeat(deg > t, deg)
    np.testing.assert_array_equal(covered, long_edge.astype(np.int64))


@pytest.mark.parametrize("t", [1, 4, 37, SPLIT_T])
@pytest.mark.parametrize("case", ["around_t", "all_long", "no_long", "empty_rows_only", "skewed"])
def test_plan_covers_every_long_row_in_ascending_chunks_of_at_most_t(case, t):
    indptr = _indptr(_degree_cases(t)[case])
    _check_plan(row_split(indptr, t), indptr, t)


def test_plan_of_a_tensor_matches_the_plan_of_its_numpy_array():
    indptr = _indptr(_degree_cases(8)["around_t"])
    a, b = row_split(indptr, 8), row_split(torch.from_numpy(indptr).int(), 8)
    assert (a.t, a.num_rows, a.num_edges) == (b.t, b.num_rows, b.num_edges)
    for name in ("rows", "chunk_ptr", "chunks"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert b.rows.device.type == "cpu"
    with pytest.raises(ValueError, match="t >= 1"):
        row_split(indptr, 0)


def test_kernel_args_follow_the_c_entry_points_order():
    """``long_t, rows, chunk_ptr, n_long, chunks, n_chunks, partials``, as
    ``seg_sum_f32`` and K3's entry points take them, and then ``counters``
    for ``csr_spmm_f32``, which folds the long rows in its launch; a plan
    with no chunks may pass a null partials pointer."""
    plan = row_split(_indptr([2, 9, 0, 17]), 4)
    partials = torch.empty(plan.num_chunks, 3)
    assert plan.kernel_args(partials) == (
        4, plan.rows.data_ptr(), plan.chunk_ptr.data_ptr(), 2,
        plan.chunks.data_ptr(), plan.num_chunks, partials.data_ptr())
    assert plan.kernel_args(partials, counters=True) == (
        plan.kernel_args(partials) + (plan.counters.data_ptr(),))
    assert plan.num_chunks == 3 + 5
    short = row_split(_indptr([2, 3]), 4)
    assert short.kernel_args(None)[5:] == (0, None)


@pytest.mark.parametrize("case", ["around_t", "all_long", "no_long", "empty_rows_only"])
def test_counters_are_one_zeroed_int32_a_long_row_and_move_with_the_plan(case):
    """K1's arrival counters: built zeroed on the plan's device, one a long
    row, carried by ``to`` (and by ``Graph.to``), and checked by ``check``."""
    indptr = _indptr(_degree_cases(4)[case])
    plan = row_split(indptr, 4)
    assert plan.counters.dtype == torch.int32 and plan.counters.shape == (plan.num_long,)
    assert not plan.counters.any() and plan.counters.device.type == "cpu"
    moved = plan.to("cpu")
    assert torch.equal(moved.counters, plan.counters)
    plan.check(torch.from_numpy(indptr), int(indptr[-1]), "k1")
    if plan.num_long:
        bad = dataclasses.replace(plan, counters=plan.counters[:-1])
        with pytest.raises(ValueError, match="counters"):
            bad.check(torch.from_numpy(indptr), int(indptr[-1]), "k1")
        bad = dataclasses.replace(plan, counters=plan.counters.long())
        with pytest.raises(ValueError, match="counters"):
            csr_spmm(torch.from_numpy(indptr), torch.zeros(int(indptr[-1]), dtype=torch.int32),
                     torch.ones(1, 2), split=bad)


def test_from_edges_builds_a_plan_for_both_csrs_and_to_carries_them():
    rng = np.random.default_rng(3)
    n = 400
    # node 7 sends 2T + 1 edges (a long reverse row), node 5 receives 3T
    src = np.concatenate([rng.integers(0, n, 2000), np.full(2 * SPLIT_T + 1, 7),
                          rng.integers(0, n, 3 * SPLIT_T)])
    dst = np.concatenate([rng.integers(0, n, 2000), rng.integers(0, n, 2 * SPLIT_T + 1),
                          np.full(3 * SPLIT_T, 5)])
    g = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    for gg in (g, g.reverse):
        ip = gg.indptr.numpy().astype(np.int64)
        _check_plan(gg.split, ip, SPLIT_T)
        assert gg.split.num_long >= 1
    assert 5 in g.split.rows.tolist() and 7 in g.reverse.split.rows.tolist()
    moved = g.to("cpu")
    for a, b in ((g.split, moved.split), (g.reverse.split, moved.reverse.split)):
        assert (a.t, a.num_rows, a.num_edges) == (b.t, b.num_rows, b.num_edges)
        for name in ("rows", "chunk_ptr", "chunks", "counters"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_empty_graph_has_empty_plans():
    g = dgl_tpu_torch.from_edges([], [], 3, device="cpu")
    for gg in (g, g.reverse):
        assert (gg.split.num_long, gg.split.num_chunks, gg.split.num_edges) == (0, 0, 0)
        assert gg.split.num_rows == 3


@pytest.mark.parametrize("wrapper", ["csr_spmm", "seg_sum", "gat_attention_fwd",
                                     "gat_attention_bwd"])
@pytest.mark.parametrize("mismatch", ["rows", "edges"])
def test_wrappers_refuse_a_plan_that_does_not_match_indptr(wrapper, mismatch):
    indptr = _indptr([3, 0, 2 * SPLIT_T + 1, 5])
    ip = torch.from_numpy(indptr)
    e = int(indptr[-1])
    if mismatch == "rows":
        bad = row_split(indptr[:-1])
    else:
        bad = row_split(np.concatenate([indptr[:-1], indptr[-1:] - 1]))
    good = row_split(indptr)
    idx = torch.zeros(e, dtype=torch.int32)
    kw = dict(negative_slope=0.2)
    if wrapper == "csr_spmm":
        x = torch.ones(4, 3)
        call = lambda plan: csr_spmm(ip, idx, x, split=plan)  # noqa: E731
        fn = csr_spmm
    elif wrapper == "seg_sum":
        msg = torch.ones(e, 3)
        call = lambda plan: seg_sum(ip, msg, split=plan)  # noqa: E731
        fn = seg_sum
    elif wrapper == "gat_attention_fwd":
        v, a = torch.ones(4, 2, 3), torch.zeros(4, 2)
        call = lambda plan: gat_attention_fwd(ip, idx, v, a, a, split=plan, **kw)  # noqa: E731
        fn = gat_attention_fwd
    else:
        g, node, a = torch.ones(4, 2, 3), torch.ones(4, 2, 4), torch.zeros(4, 2)
        call = lambda plan: gat_attention_bwd(ip, idx, idx, g, node, a, g, split=plan,  # noqa: E731
                                              **kw)
        fn = gat_attention_bwd
    before = fn.launches
    with pytest.raises(ValueError, match="row split"):
        call(bad)
    assert fn.launches == before
    torch.testing.assert_close(call(good), call(None))


def test_every_op_hands_the_kernels_the_graphs_own_plan(monkeypatch):
    """gspmm (copy_u both ways, copy_e), gather_src_rows, spread_dst,
    seg_sum_dst and edge_softmax call K1 and K2, and a fused GATConv's
    forward and backward call K3's two passes, with the plan of the CSR they
    run over, so no path of the package reaches the wrappers' branch that
    builds a plan from indptr."""
    from dgl_tpu_torch.kernels import gat_attention as gat_mod
    from dgl_tpu_torch.nn import GATConv
    from dgl_tpu_torch.ops import edge_softmax, gather_src_rows, spread_dst
    from dgl_tpu_torch.ops import gather as gather_mod
    from dgl_tpu_torch.ops import segment as segment_mod
    from dgl_tpu_torch.ops import spmm as spmm_mod

    rng = np.random.default_rng(5)
    n = 300
    src = np.concatenate([rng.integers(0, n, 1500), np.full(SPLIT_T + 3, 2)])
    dst = np.concatenate([rng.integers(0, n, 1500), np.full(SPLIT_T + 3, 9)])
    g = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    plans = {id(g.split): "dst", id(g.reverse.split): "reverse"}
    seen = []

    def spy(real):
        def wrapped(indptr, *args, split=None, **kw):
            assert split is not None, f"{real.__name__} called without a row split"
            assert split.num_rows == indptr.numel() - 1
            seen.append((real.__name__, plans[id(split)]))
            return real(indptr, *args, split=split, **kw)
        return wrapped

    monkeypatch.setattr(spmm_mod, "csr_spmm", spy(csr_spmm))
    monkeypatch.setattr(gather_mod, "csr_spmm", spy(csr_spmm))
    monkeypatch.setattr(segment_mod, "seg_sum", spy(seg_sum))
    monkeypatch.setattr(gat_mod, "gat_attention_fwd", spy(gat_attention_fwd))
    monkeypatch.setattr(gat_mod, "gat_attention_bwd", spy(gat_attention_bwd))

    x = torch.randn(n, 4, requires_grad=True)
    e = torch.randn(g.num_edges, 2, 3, requires_grad=True)
    logits = torch.randn(g.num_edges, 2, requires_grad=True)
    v = torch.randn(n, 2, requires_grad=True)
    conv = GATConv(4, 3, 2, attn_drop=0.3, fused=True, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    total = (dgl_tpu_torch.gspmm(g, "copy_u", "mean", x=x).sum()
             + dgl_tpu_torch.gspmm(g, "copy_e", "sum", e=e).sum()
             + gather_src_rows(g, x).sum() + spread_dst(g, v).sum()
             + (edge_softmax(g, logits) * torch.randn(g.num_edges, 2)).sum()
             + conv(g, x, generator=torch.Generator().manual_seed(1)).sum())
    total.backward()
    assert ("csr_spmm", "dst") in seen and ("csr_spmm", "reverse") in seen
    assert ("seg_sum", "dst") in seen
    assert {s for s in seen if s[0] == "seg_sum"} == {("seg_sum", "dst")}
    assert {s for s in seen if s[0].startswith("gat")} == {
        ("gat_attention_fwd", "dst"), ("gat_attention_bwd", "reverse")}
