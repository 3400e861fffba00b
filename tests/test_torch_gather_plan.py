"""The plan of a row gather (``dgl_tpu_torch/kernels/row_gather.py:
gather_plan``): the indices' CSR by source row, which P1 in source order
(``row_gather_by_source``) walks.

Held against numpy on the same indices: ``indptr`` is the cumulative
``bincount``, ``pos`` a stable ``argsort`` (each row's positions ascending),
the split ``row_split`` of that ``indptr``; int32 and int64 indices, rows
with no position, rows longer than T, e = 0 and n = 0. An index outside
``[0, n)`` raises. A graph's own CSRs are such plans: the plan of ``src``
is the reverse CSR (``reverse.indptr``, ``reverse.eid``), the plan of
``dst`` the dst CSR with positions equal to slots.
"""

import numpy as np
import pytest
import torch

import dgl_tpu_torch
from dgl_tpu_torch.graph.split import SPLIT_T, row_split
from dgl_tpu_torch.kernels.row_gather import GatherPlan, gather_plan, row_gather_by_source


def _cases():
    rng = np.random.default_rng(0)
    return {
        "uniform": (rng.integers(0, 300, 5000), 300),
        "upper_rows_unread": (rng.integers(0, 100, 3000), 400),
        "long_rows": (np.concatenate([np.full(3 * SPLIT_T + 5, 7), np.full(SPLIT_T + 1, 0),
                                      np.full(SPLIT_T, 2), rng.integers(0, 50, 700)]), 50),
        "skewed": ((rng.zipf(1.3, 8000) - 1) % 1000, 1000),
        "no_index": (np.zeros(0, np.int64), 20),
        "no_row": (np.zeros(0, np.int64), 0),
    }


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", list(_cases()))
def test_plan_matches_numpy(case, dtype):
    idx_np, n = _cases()[case]
    rng = np.random.default_rng(1)
    rng.shuffle(idx_np)
    plan = gather_plan(torch.from_numpy(idx_np).to(dtype), n)
    assert isinstance(plan, GatherPlan)
    want_ip = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(idx_np, minlength=n), out=want_ip[1:])
    assert plan.indptr.dtype == plan.pos.dtype == torch.int32  # e fits
    np.testing.assert_array_equal(plan.indptr.numpy(), want_ip)
    np.testing.assert_array_equal(plan.pos.numpy(), np.argsort(idx_np, kind="stable"))
    want = row_split(want_ip)
    assert (plan.split.t, plan.split.num_rows, plan.split.num_edges) == (SPLIT_T, n, len(idx_np))
    for field in ("rows", "chunk_ptr", "chunks"):
        assert torch.equal(getattr(plan.split, field), getattr(want, field)), field
    assert (plan.split.num_long > 0) == (case in ("long_rows", "skewed"))
    x = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    assert torch.equal(row_gather_by_source(x, *plan), x[torch.from_numpy(idx_np)])


def test_plan_takes_its_t_and_refuses_indices_outside_the_rows():
    idx = torch.tensor([3, 3, 3, 0, 3, 1], dtype=torch.int32)
    plan = gather_plan(idx, 5, t=2)
    assert plan.split.t == 2 and plan.split.rows.tolist() == [3]
    assert plan.split.chunks.tolist() == [[2, 4], [4, 6]]
    assert plan.pos.tolist() == [3, 5, 0, 1, 2, 4]
    for bad in ([0, 5], [-1, 2]):
        with pytest.raises(ValueError, match=r"outside \[0, 5\)"):
            gather_plan(torch.tensor(bad), 5)
    with pytest.raises(TypeError, match="int32/int64"):
        gather_plan(idx.float(), 5)
    with pytest.raises(ValueError, match="n >= 0"):
        gather_plan(idx, -1)


def test_a_graphs_csrs_are_the_plans_of_its_src_and_dst():
    rng = np.random.default_rng(4)
    n = 200
    src = np.concatenate([rng.integers(0, n, 2000), np.full(SPLIT_T + 9, 11)])
    dst = rng.integers(0, n // 2, src.size)
    g = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    rev = g.reverse
    by_src = gather_plan(g.src, n)
    assert torch.equal(by_src.indptr, rev.indptr) and torch.equal(by_src.pos, rev.eid)
    assert torch.equal(by_src.split.chunks, rev.split.chunks) and rev.split.num_long == 1
    by_dst = gather_plan(g.dst, n)
    assert torch.equal(by_dst.indptr, g.indptr)
    assert torch.equal(by_dst.pos, torch.arange(g.num_edges, dtype=torch.int32))
