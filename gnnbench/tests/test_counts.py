"""The frozen counts give the hand-worked values at the cells' shapes."""

from __future__ import annotations

import json
import os

import pytest

from gnnbench import counts
from gnnbench.models import gat, sage
from gnnbench.tests.conftest import PKG

PRODUCTS_N, PRODUCTS_E = 2_449_029, 123_718_280  # ogbn-products bidirected, as DGL loads it
ARXIV_N, ARXIV_E = 169_343, 2_315_598 + 169_343  # ogbn-arxiv bidirected, and its self-loops


def test_k1_bound_at_products_width_64():
    # indices E·4, indptr (N+1)·4, x read N·64·4, out written N·64·4
    moved = PRODUCTS_E * 4 + (PRODUCTS_N + 1) * 4 + 2 * PRODUCTS_N * 64 * 4
    assert moved == 1_758_572_088
    ms, by = counts.spmm_bound(PRODUCTS_N, PRODUCTS_N, PRODUCTS_E, 64, 4)
    assert by == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.52495, abs=1e-5)


def test_k3_forward_bound_at_arxiv():
    n, e, h, d = ARXIV_N, ARXIV_E, 4, 16
    moved = 4 * ((n + 1) + e + n * h + n * h + 2 * n * h * d + 3 * n * h) + 4 * n * h * d
    ms, by = counts.k3_fwd_bound(n, n, e, h, d)
    assert by == "bytes" and ms == pytest.approx(moved / 3.35e9)


def test_gather_bound_counts_distinct_rows_once():
    ms, by = counts.gather_bound(1_056_000, 500_000, 4, 400)
    assert ms == pytest.approx((500_000 * 400 + 1_056_000 * 4 + 1_056_000 * 400) / 3.35e9)


def test_launch_lists_follow_the_layers():
    assert counts.sage_k1_launches(100, 64, 47, 3, hoisted=False) == [
        (0, "fwd", 64), (0, "bwd", 64), (1, "fwd", 64), (1, "bwd", 64), (2, "fwd", 47),
        (2, "bwd", 47)]
    assert [(k, h, d, drop) for _, k, h, d, drop in
            counts.gat_k3_launches(128, 16, 40, [4, 4, 4], 0.18)] == [
        ("fwd", 4, 16, False), ("b2", 4, 16, False), ("fwd", 4, 16, True), ("b2", 4, 16, True),
        ("fwd", 4, 40, True), ("b2", 4, 40, True)]


@pytest.mark.parametrize("d_in,d_out,grad", [(100, 64, False), (64, 64, True), (64, 47, True),
                                             (16, 64, True)])
def test_a_layer_counts_the_least_of_its_orders(d_in, d_out, grad):
    n, e = 1000, 20000
    w = counts.sage_layer_full(n, e, d_in, d_out, grad)
    first = (counts.linear_fwd_bwd(n, 2 * d_in, d_out, grad) + counts.csr_aggregate(n, n, e, d_in)
             + (counts.csr_aggregate(n, n, e, d_in) if grad else counts.Work()))
    project = (counts.linear_fwd_bwd(n, d_in, 2 * d_out, grad)
               + counts.csr_aggregate(n, n, e, d_out) + counts.csr_aggregate(n, n, e, d_out))
    assert w.flops == min(first.flops, project.flops) and w.bytes == min(first.bytes, project.bytes)


def test_step_work_at_the_cells_shapes():
    with open(os.path.join(PKG, "configs", "sage_products.json")) as f:
        products = json.load(f)
    with open(os.path.join(PKG, "configs", "gat_arxiv.json")) as f:
        arxiv = json.load(f)
    w = sage.work_full(products, PRODUCTS_N, PRODUCTS_E)
    # the aggregations alone: 4 passes at 64 and 2 at 47 wide, each moving its CSR and rows
    agg = sum(counts.csr_aggregate(PRODUCTS_N, PRODUCTS_N, PRODUCTS_E, d).bytes
              for d in (64, 64, 64, 64, 47, 47))
    assert agg < w.bytes < 2 * agg + 20e9
    assert w.least_s() == pytest.approx(w.bytes / 3.35e12)  # bytes-bound
    g = gat.work_full(arxiv, ARXIV_N, ARXIV_E)
    assert 0 < g.least_s() < 2e-3
