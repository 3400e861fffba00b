"""The generator draws the configurations' published edge counts."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from gnnbench import data
from gnnbench.tests.conftest import PKG

# edges after to_bidirected, as DGL loads ogbn-products and makes of ogbn-arxiv
PUBLISHED = {"sage_products": 123_718_280, "gat_arxiv": 2_315_598}


def _small(bidirected=None, community=True):
    g = {"num_nodes": 600, "num_edges": 4000, "num_classes": 5, "homophily": 0.7,
         "data_seed": 3}
    if community:
        g["community"] = [16, 0.5]
    if bidirected is not None:
        g["bidirected_edges"] = bidirected
    return g


def _pairs(src, dst, n):
    s, d = src.astype(np.int64), dst.astype(np.int64)
    return np.minimum(s, d) * n + np.maximum(s, d)


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_configs_state_the_published_bidirected_count(name):
    with open(os.path.join(PKG, "configs", f"{name}.json")) as f:
        assert json.load(f)["graph"]["bidirected_edges"] == PUBLISHED[name]


@pytest.mark.parametrize("community", [True, False])
def test_the_bidirected_graph_has_exactly_the_stated_edges(community):
    g = _small(bidirected=9000, community=community)
    src, dst, labels = data.generate(g)
    n = g["num_nodes"]
    key = _pairs(src, dst, n)
    assert len(src) == 4500 and not np.any(src == dst)
    assert len(np.unique(key)) == 4500  # distinct unordered pairs: bidirected, 9,000 edges
    # the first draw is the frozen stream's: its distinct pairs come first, in order
    s0, d0, l0 = data.generate(_small(community=community))
    assert np.array_equal(labels, l0)
    first = data._first_distinct(s0.astype(np.int64), d0.astype(np.int64), n)
    assert len(first) < 4500
    assert np.array_equal(src[:len(first)], s0[first]) and np.array_equal(dst[:len(first)],
                                                                         d0[first])


def test_an_unreachable_count_is_refused():
    with pytest.raises(ValueError):
        data.generate(_small(bidirected=9001))
    with pytest.raises(ValueError):
        data.generate(_small(bidirected=600 * 599 + 2))
