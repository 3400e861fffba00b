"""GraphSAGE in plain PyTorch: the reference of the ``sage`` family.

The reference suite's hand-built SAGEConv (``main_dgl_product_sage.py``,
``ns-sage-dgl.py``): ``fc_self(x) + fc_neigh(mean of the in-neighbours'
x) + bias``, relu between layers, dropout on the last layer's input, no
BatchNorm. Written from that definition (the mean is taken of the inputs,
then projected), not from the program's order of work. The program's
dropout draws are followed in its order: over a whole graph one mask on
the last layer's input; over blocks one mask on the sources, then one on
the destinations.

``layout`` is the benchmark's weight layout, which both sides are given:
the program's parameter names, xavier-uniform bounds with the relu gain,
zero biases.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from gnnbench.reference import common

__all__ = ["layout", "forward_full", "forward_blocks"]


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    m = cfg["model"]
    if m.get("batch_norm"):
        raise ValueError("the sage reference has no BatchNorm")
    widths = common.layer_widths(m)
    gain = math.sqrt(2.0)
    out = []
    for i in range(m["layers"]):
        d_in, d_out = widths[i], widths[i + 1]
        bound = common.xavier_bound(d_in, d_out, gain)
        out += [(f"convs.{i}.fc_self.weight", (d_out, d_in), bound),
                (f"convs.{i}.fc_neigh.weight", (d_out, d_in), bound),
                (f"convs.{i}.fc_neigh_bias", (d_out,), 0.0)]
    return out


def _layer(p, i, x_src, x_dst, neigh_mean, tf32):
    return (common.linear(x_dst, p[f"convs.{i}.fc_self.weight"], tf32)
            + common.linear(neigh_mean, p[f"convs.{i}.fc_neigh.weight"], tf32)
            + p[f"convs.{i}.fc_neigh_bias"])


def forward_full(p: Dict[str, torch.Tensor], g: common.RefGraph, x: torch.Tensor, cfg: dict,
                 replay: common.Replay, tf32: bool = False) -> torch.Tensor:
    m = cfg["model"]
    h = x
    for i in range(m["layers"]):
        last = i == m["layers"] - 1
        if last:
            h = replay.dropout(h, m["dropout"])
        h = _layer(p, i, h, h, common.mean_aggregate(g, h), tf32)
        if not last:
            h = F.relu(h)
    return h


def forward_blocks(p: Dict[str, torch.Tensor], sizes: Sequence[Tuple[int, int]],
                   x: torch.Tensor, cfg: dict, replay: common.Replay,
                   tf32: bool = False) -> torch.Tensor:
    """``sizes``: each positional block's (destinations, fanout), outermost
    first; destination ``j``'s sources are rows ``nd + j·f ...`` of the
    block's input, its own row is ``j``."""
    m = cfg["model"]
    h = x
    for i, (nd, f) in enumerate(sizes):
        last = i == len(sizes) - 1
        h_src, h_dst = h, h[:nd]
        if last:
            h_src = replay.dropout(h_src, m["dropout"])
            h_dst = replay.dropout(h_dst, m["dropout"])
        neigh = h_src[nd: nd + nd * f].reshape(nd, f, -1).mean(1)
        h = _layer(p, i, h_src, h_dst, neigh, tf32)
        if not last:
            h = F.relu(h)
    return h
