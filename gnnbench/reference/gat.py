"""GAT in plain PyTorch: the reference of the ``gat`` family.

DGL's GATConv as the reference suite uses it (``main_dgl_arxiv_gat.py``):
per head the projection ``z = W x``, scores ``a_src = z·attn_r`` on the
source side and ``a_dst = z·attn_l`` on the destination side, logits
``leaky_relu(a_src[s] + a_dst[d])``, a softmax over each node's in-edges
(shifted by its detached maximum), attention dropout on the weights, and
the weighted sum of ``z[s]``; elu between layers with the heads
concatenated, the last layer's heads averaged; no bias, no residual; the
first layer without feature or attention dropout. Over a whole graph the
attention-dropout factor of an edge and head is the hash of its position
in the dst-sorted edge order (``common.keep_mask``), seeded by one int32
drawn per layer after the layer's feature dropout; over a positional block
it is a ``bernoulli_`` mask of the (destinations, fanout, heads) weights,
after the sources' and the destinations' feature dropout.

``layout``: the program's parameter names, xavier-uniform projections,
scores uniform in ``±sqrt(6 / (H + D))``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from gnnbench.reference import common

__all__ = ["layout", "forward_full", "forward_blocks"]


def _dims(m: dict):
    widths, out = m["in_feats"], []
    for i, h in enumerate(m["heads"]):
        d = m["classes"] if i == len(m["heads"]) - 1 else m["hidden"]
        out.append((widths, h, d))
        widths = h * d
    return out


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    m = cfg["model"]
    if m.get("residual"):
        raise ValueError("the gat reference has no residual")
    out = []
    for i, (d_in, h, d) in enumerate(_dims(m)):
        att = math.sqrt(6.0 / (h + d))
        out += [(f"convs.{i}.fc.weight", (h * d, d_in), common.xavier_bound(d_in, h * d)),
                (f"convs.{i}.attn_l", (1, h, d), att),
                (f"convs.{i}.attn_r", (1, h, d), att)]
    return out


def _attention(g: common.RefGraph, z, a_src, a_dst, slope, keep, seed):
    n, (heads, d) = g.num_nodes, z.shape[1:]
    logit = F.leaky_relu(a_src.index_select(0, g.src) + a_dst.index_select(0, g.dst), slope)
    shift = torch.full((n, heads), -math.inf, dtype=z.dtype, device=z.device).scatter_reduce(
        0, g.dst.unsqueeze(1).expand(-1, heads), logit.detach(), "amax")
    p = torch.exp(logit - shift.index_select(0, g.dst))
    total = torch.zeros((n, heads), dtype=z.dtype, device=z.device).index_add(0, g.dst, p)
    alpha = p / total.index_select(0, g.dst)
    if keep < 1.0:
        alpha = alpha * common.keep_mask(g.num_edges, heads, seed, keep, z.device)
    msg = alpha.unsqueeze(-1) * z.index_select(0, g.src)
    return torch.zeros((n, heads, d), dtype=z.dtype, device=z.device).index_add(0, g.dst, msg)


def _finish(h, i, layers):
    return h.mean(1) if i == layers - 1 else F.elu(h).flatten(1)


def forward_full(p: Dict[str, torch.Tensor], g: common.RefGraph, x: torch.Tensor, cfg: dict,
                 replay: common.Replay, tf32: bool = False) -> torch.Tensor:
    m = cfg["model"]
    h, layers = x, len(m["heads"])
    for i, (_, heads, d) in enumerate(_dims(m)):
        drop = 0.0 if i == 0 else m["dropout"]
        h = replay.dropout(h, drop)
        z = common.linear(h, p[f"convs.{i}.fc.weight"], tf32).view(-1, heads, d)
        a_src = (z * p[f"convs.{i}.attn_r"]).sum(-1)
        a_dst = (z * p[f"convs.{i}.attn_l"]).sum(-1)
        keep, seed = 1.0, None
        if drop > 0.0:
            keep, seed = 1.0 - drop, replay.seed_int32()
        h = _finish(_attention(g, z, a_src, a_dst, m["negative_slope"], keep, seed), i, layers)
    return h


def forward_blocks(p: Dict[str, torch.Tensor], sizes: Sequence[Tuple[int, int]],
                   x: torch.Tensor, cfg: dict, replay: common.Replay,
                   tf32: bool = False) -> torch.Tensor:
    m = cfg["model"]
    h, layers = x, len(m["heads"])
    for i, ((_, heads, d), (nd, f)) in enumerate(zip(_dims(m), sizes)):
        drop = 0.0 if i == 0 else m["dropout"]
        h_src, h_dst = replay.dropout(h, drop), replay.dropout(h[:nd], drop)
        w = p[f"convs.{i}.fc.weight"]
        z_n = common.linear(h_src[nd: nd + nd * f], w, tf32).view(nd, f, heads, d)
        z_dst = common.linear(h_dst, w, tf32).view(nd, heads, d)
        logits = F.leaky_relu((z_n * p[f"convs.{i}.attn_r"]).sum(-1)
                              + (z_dst * p[f"convs.{i}.attn_l"]).sum(-1).unsqueeze(1),
                              m["negative_slope"])
        alpha = replay.dropout(torch.softmax(logits, 1), drop)
        h = _finish((alpha.unsqueeze(-1) * z_n).sum(1), i, layers)
    return h
