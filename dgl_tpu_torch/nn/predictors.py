"""Edge scorers for link prediction.

Counterpart of ``dgl_tpu/nn/predictors.py``: the reference's dot-product
scorer (``apply_edges(fn.u_dot_v)``, ``cluster_gcn_dgl.py:91-102``) and its
MLP ``LinkPredictor`` over the hadamard product of the endpoint embeddings
(``cluster_gcn_dgl.py:64-88``: Linear, relu, dropout, ``num_layers - 1``
times, then Linear to 1), on a graph's edges or on explicit pairs.

The MLPs' ``Linear`` layers are named as the flax ``Dense`` layers are
(``lins.i`` for ``lin_i``, ``lin_out``), drawn with flax's default
(``lecun_normal`` weights, zero biases) from the CPU ``generator``;
``convert.py:predictor_state_dict_from_flax`` carries the JAX weights
over. Dropout masks come from the ``generator`` passed to ``forward``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph
from ..ops.sddmm import u_dot_v, u_mul_v
from .conv import dropout
from .init import lecun_normal_

__all__ = ["DotPredictor", "MLPPredictor", "PairMLPPredictor"]


class DotPredictor(nn.Module):
    """``score[e] = h[src] · h[dst]``, (E,) in the graph's canonical order."""

    def forward(self, g: Graph, h: torch.Tensor) -> torch.Tensor:
        return u_dot_v(g, h, h)[:, 0]


class _MLPHead(nn.Module):
    def __init__(self, in_feats: int, hidden: int, num_layers: int = 3, dropout: float = 0.0, *,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        widths = [in_feats] + [hidden] * (num_layers - 1)
        self.lins = nn.ModuleList(nn.utils.skip_init(nn.Linear, a, b)
                                  for a, b in zip(widths[:-1], widths[1:]))
        self.lin_out = nn.utils.skip_init(nn.Linear, widths[-1], 1)
        for lin in (*self.lins, self.lin_out):
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        self.to(resolve_device(device))

    def _head(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        for lin in self.lins:
            x = dropout(F.relu(lin(x)), self.dropout, self.training, generator)
        return self.lin_out(x)[..., 0]


class MLPPredictor(_MLPHead):
    """The MLP over ``h[src] * h[dst]`` of every edge, (E,)."""

    def forward(self, g: Graph, h: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._head(u_mul_v(g, h, h), generator)


class PairMLPPredictor(_MLPHead):
    """The same MLP on explicit pairs ``x_i * x_j`` (broadcasting), the
    leading shape kept (the reference's evaluation feeds gathered pairs,
    ``cluster_gcn_dgl.py:176-189``)."""

    def forward(self, x_i: torch.Tensor, x_j: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._head(x_i * x_j, generator)
