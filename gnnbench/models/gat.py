"""The ``gat`` family: the port's ``GAT`` built from a configuration, and
its step's model work.

The model is the one ``main_gat`` (full graph, ``fused``: K3) and ``ns_gat``
(blocks) train: heads concatenated with elu between layers, averaged at
the last, feature and attention dropout from the second layer on, no
residual; its weights are the benchmark's (``reference/gat.py:layout``),
loaded strictly.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from gnnbench import counts
from gnnbench.reference import gat as ref

__all__ = ["build", "work_full", "work_blocks", "reference"]

reference = ref


def build(cfg: dict, device: torch.device, weights: Dict[str, torch.Tensor]) -> torch.nn.Module:
    from dgl_tpu_torch.models import GAT

    m = cfg["model"]
    model = GAT(m["in_feats"], m["hidden"], m["classes"], tuple(m["heads"]),
                feat_drop=m["dropout"], attn_drop=m["dropout"],
                negative_slope=m["negative_slope"], fused=m["fused"], device=device,
                generator=torch.Generator().manual_seed(0))
    model.load_state_dict(weights, strict=True)
    return model


def _num_params(cfg: dict) -> int:
    return sum(int(torch.Size(shape).numel()) for _, shape, _ in ref.layout(cfg))


def work_full(cfg: dict, n: int, e: int) -> counts.Work:
    w = counts.adam(_num_params(cfg))
    for i, (d_in, h, d) in enumerate(ref._dims(cfg["model"])):
        w = w + counts.gat_layer(n, n, d_in, h, d, input_grad=i > 0, e=e)
    return w


def work_blocks(cfg: dict, sizes: Sequence, row_bytes: int) -> counts.Work:
    w = counts.adam(_num_params(cfg))
    for i, ((d_in, h, d), (nd, f)) in enumerate(zip(ref._dims(cfg["model"]), sizes)):
        w = w + counts.gat_layer(nd, nd * (1 + f), d_in, h, d, input_grad=i > 0, fanout=f)
    return w
