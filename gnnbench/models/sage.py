"""The ``sage`` family: the port's ``GraphSAGE`` built from a configuration,
and its step's model work.

The model is the one ``main_sage`` (full graph) and ``ns_sage`` (blocks)
train: mean or sum aggregation, relu between layers, dropout on the last
layer's input, no BatchNorm; its weights are the benchmark's
(``reference/sage.py:layout``), loaded strictly, so a renamed or added
parameter fails the run.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from gnnbench import counts
from gnnbench.reference import common, sage as ref

__all__ = ["build", "work_full", "work_blocks", "reference"]

reference = ref


def build(cfg: dict, device: torch.device, weights: Dict[str, torch.Tensor]) -> torch.nn.Module:
    from dgl_tpu_torch.models import GraphSAGE

    m = cfg["model"]
    model = GraphSAGE(m["in_feats"], m["hidden"], m["classes"], num_layers=m["layers"],
                      aggr=m["aggr"], dropout=m["dropout"], batch_norm=False, device=device,
                      generator=torch.Generator().manual_seed(0))
    model.load_state_dict(weights, strict=True)
    return model


def _num_params(cfg: dict) -> int:
    return sum(int(torch.Size(shape).numel()) for _, shape, _ in ref.layout(cfg))


def work_full(cfg: dict, n: int, e: int) -> counts.Work:
    """One epoch over a graph of ``n`` nodes and ``e`` edges."""
    m = cfg["model"]
    widths = common.layer_widths(m)
    w = counts.adam(_num_params(cfg))
    for i in range(m["layers"]):
        w = w + counts.sage_layer_full(n, e, widths[i], widths[i + 1], input_grad=i > 0)
    return w


def work_blocks(cfg: dict, sizes: Sequence, row_bytes: int) -> counts.Work:
    """One step over positional blocks ``sizes`` ((destinations, fanout),
    outermost first), without the sampling and the feature gather."""
    m = cfg["model"]
    widths = common.layer_widths(m)
    w = counts.adam(_num_params(cfg))
    for i, (nd, f) in enumerate(sizes):
        w = w + counts.sage_layer_block(nd, f, widths[i], widths[i + 1], input_grad=i > 0)
    return w
