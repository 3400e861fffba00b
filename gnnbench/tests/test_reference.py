"""The plain reference against the port's CPU path on tiny graphs: the
same logits from the same weights and dropout stream, and every tiny cell
judged correct end to end."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnnbench import data
from gnnbench.models import gat, sage
from gnnbench.reference import common
from gnnbench.run import make_cell, run_cell

CPU = torch.device("cpu")


def _graph(n=300, e=2000, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32), n


def _cfg(tiny_root, name):
    cell, *_ = make_cell(tiny_root, f"{name}.full", 5, CPU)
    return cell.cfg


@pytest.mark.parametrize("family,name,bidirect,loops", [(sage, "tiny_sage", True, False),
                                                        (gat, "tiny_gat", True, True)])
def test_full_graph_logits_match_in_training_mode(tiny_root, family, name, bidirect, loops):
    from dgl_tpu_torch.graph import from_edges, transforms

    cfg = _cfg(tiny_root, name)
    src, dst, n = _graph()
    s, d = torch.from_numpy(src).long(), torch.from_numpy(dst).long()
    if bidirect:
        s, d = transforms.to_bidirected(s, d, n)
    if loops:
        s, d = transforms.add_self_loops(s, d, n)
    g = from_edges(s, d, n, device=CPU)
    rg = common.build_graph(src, dst, n, bidirect=bidirect, self_loops=loops, device=CPU)
    assert torch.equal(rg.src, g.src.long()) and torch.equal(rg.dst, g.dst.long())
    w = data.weights(family.reference.layout(cfg), 11, CPU)
    model = family.build(cfg, CPU, w)
    x = torch.randn(n, cfg["model"]["in_feats"], generator=torch.Generator().manual_seed(1))
    model.train()
    got = model(g, x, generator=torch.Generator().manual_seed(99))
    want = family.reference.forward_full(w, rg, x, cfg, common.Replay(99, CPU))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family,name", [(sage, "tiny_sage"), (gat, "tiny_gat")])
def test_block_logits_match_in_training_mode(tiny_root, family, name):
    from dgl_tpu_torch.sampling import MultiLayerNeighborSampler

    cfg = _cfg(tiny_root, name)
    fanouts, b = [2, 3, 4], 8
    blocks = MultiLayerNeighborSampler(fanouts).skeleton_blocks(b, CPU)
    sizes = list(zip(common.block_sizes(b, fanouts), fanouts))
    rows = blocks[0].num_src_nodes
    x = torch.randn(rows, cfg["model"]["in_feats"], generator=torch.Generator().manual_seed(2))
    w = data.weights(family.reference.layout(cfg), 12, CPU)
    model = family.build(cfg, CPU, w)
    model.train()
    got = model(blocks, x, generator=torch.Generator().manual_seed(7))
    want = family.reference.forward_blocks(w, sizes, x, cfg, common.Replay(7, CPU))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_blocked_mean_equals_one_block(monkeypatch):
    src, dst, n = _graph(200, 5000)
    g = common.build_graph(src, dst, n, bidirect=False, self_loops=False, device=CPU)
    x = torch.randn(n, 8, requires_grad=True)
    whole = common.mean_aggregate(g, x)
    (gw,) = torch.autograd.grad(whole.square().sum(), x)
    monkeypatch.setattr(common, "_BLOCK_BYTES", 4 * 8 * 7)  # blocks of 7 edges
    part = common.mean_aggregate(g, x)
    (gp,) = torch.autograd.grad(part.square().sum(), x)
    torch.testing.assert_close(part, whole)
    torch.testing.assert_close(gp, gw)


@pytest.mark.parametrize("cell", ["tiny_sage.full", "tiny_gat.full", "tiny_sage.tiny_ns",
                                  "tiny_gat.tiny_ns"])
def test_tiny_cells_are_correct_on_the_cpu(tiny_root, cell):
    result, rows = run_cell(tiny_root, cell, 2**31 + 12345, 0.3, False, CPU)
    assert result["correct"], rows
    assert result["attempted"] > 0 and result["failed"] == 0
