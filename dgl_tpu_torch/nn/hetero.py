"""Heterogeneous graph convolution: a conv per relation, reduced across
relations.

Counterpart of ``dgl_tpu/nn/hetero.py`` (``dgl.nn.HeteroGraphConv`` as GCMC
uses it, ``gcmc_dgl/model.py:205``): one conv per relation, its outputs
grouped by destination node type and combined with stack, sum, mean, max
or min.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn

from ..graph.hetero import HeteroGraph

__all__ = ["HeteroGraphConv"]


def _combine(agg: str, outs: List[torch.Tensor]) -> torch.Tensor:
    if agg == "stack":
        return torch.stack(outs, dim=1)  # (N, R, ...)
    if agg == "sum":
        return sum(outs)
    if agg == "mean":
        return sum(outs) / len(outs)
    if agg in ("max", "min"):
        pick = torch.maximum if agg == "max" else torch.minimum
        out = outs[0]
        for o in outs[1:]:
            out = pick(out, o)
        return out
    raise ValueError(f"unknown cross-relation agg: {agg!r}")


class HeteroGraphConv(nn.Module):
    """``convs``: {relation name: module}, each called as
    ``conv(g_rel, (x_src, x_dst), **mod_kwargs[rel])``; ``agg``: 'stack',
    'sum', 'mean', 'max' or 'min'. ``forward(hg, feats, mod_kwargs)`` maps
    node type to features and returns {destination type: combined output}
    (stack gives (N, R_dst, D), DGL's stack). Relations of ``hg`` without a
    conv are skipped; relations run in ``hg.etypes`` order."""

    def __init__(self, convs: Mapping[str, nn.Module], agg: str = "stack"):
        super().__init__()
        if agg not in ("stack", "sum", "mean", "max", "min"):
            raise ValueError(f"unknown cross-relation agg: {agg!r}")
        self.convs = nn.ModuleDict(convs)
        self.agg = agg

    def forward(self, hg: HeteroGraph, feats: Mapping[str, torch.Tensor],
                mod_kwargs: Optional[Mapping[str, Dict[str, Any]]] = None
                ) -> Dict[str, torch.Tensor]:
        mod_kwargs = mod_kwargs or {}
        by_dst: Dict[str, list] = {}
        for stype, rel, dtype in hg.etypes:
            if rel not in self.convs:
                continue
            out = self.convs[rel](hg[(stype, rel, dtype)], (feats[stype], feats[dtype]),
                                  **mod_kwargs.get(rel, {}))
            by_dst.setdefault(dtype, []).append(out)
        return {nt: _combine(self.agg, outs) for nt, outs in by_dst.items()}
