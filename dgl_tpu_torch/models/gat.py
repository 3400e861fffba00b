"""GAT over one full graph or a list of sampled blocks.

Counterpart of ``dgl_tpu/models/gat.py:GAT`` (the reference's
``main_dgl_citation_gat.py`` net): layer 0 without feature or attention
dropout, hidden layers with elu and their heads concatenated, the output
layer averaging its heads. ``fused`` picks GATConv's form for every layer,
``lowering="scatter"`` its PyG twin (the edge form with ``index_add_`` sums).
Dropout masks and attention-dropout seeds come from the ``generator``
passed to ``forward``; the initial weights from the CPU ``generator``
passed to the constructor. Over blocks (``ns-gat-dgl.py:22-60``) layer
``i`` runs on ``graphs[i]`` with ``(h, h[:num_dst_nodes])`` and takes
GATConv's positional block form. The JAX model's ``remat`` is a TPU memory
workaround and is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph, per_layer
from ..nn import GATConv

__all__ = ["GAT"]


class GAT(nn.Module):
    def __init__(
        self,
        in_feats: int,
        hidden_feats: int,
        out_feats: int,
        heads: Sequence[int],
        feat_drop: float = 0.0,
        attn_drop: float = 0.0,
        negative_slope: float = 0.2,
        residual: bool = False,
        *,
        fused: bool = False,
        lowering: str = "fused",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.convs = nn.ModuleList()
        width = in_feats
        for i, h in enumerate(heads):
            last = i == len(heads) - 1
            d = out_feats if last else hidden_feats
            self.convs.append(GATConv(
                width, d, h,
                feat_drop=0.0 if i == 0 else feat_drop,
                attn_drop=0.0 if i == 0 else attn_drop,
                negative_slope=negative_slope,
                residual=residual,
                activation=None if last else F.elu,
                fused=fused,
                lowering=lowering,
                device="cpu",
                generator=generator,
            ))
            width = h * d
        self.to(dev)

    def forward(self, graphs: Union[Graph, Sequence[Graph]], x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``graphs``: one graph, or one block per layer, outermost first."""
        h = x
        for i, (conv, g) in enumerate(zip(self.convs, per_layer(graphs, len(self.convs)))):
            h = conv(g, (h, h[:g.num_dst_nodes]) if g.is_block else h, generator=generator)
            h = h.mean(1) if i == len(self.convs) - 1 else h.flatten(1)
        return h
