"""Categorical feature encoders of the OGB molecule datasets.

Counterpart of ``dgl_tpu/nn/encoders.py`` (OGB's ``AtomEncoder`` and
``BondEncoder``, ``main_dgl_molhiv_gcn.py:14``): one embedding table per
integer input column, the embeddings summed. Each index is clipped into its
table. The vocabulary sizes are OGB's public mol feature dimensions, so
nothing is downloaded. Tables are xavier-uniform, drawn from the CPU
``generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .init import xavier_uniform_

__all__ = ["CategoricalEncoder", "AtomEncoder", "BondEncoder", "ATOM_FEATURE_DIMS",
           "BOND_FEATURE_DIMS"]

# atom: [atomic_num, chirality, degree, formal_charge, num_h, num_rad_e,
#        hybridization, is_aromatic, is_in_ring]
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
# bond: [bond_type, bond_stereo, is_conjugated]
BOND_FEATURE_DIMS = (5, 6, 2)


class CategoricalEncoder(nn.Module):
    """Sum of per-column embeddings of (N, F) integer features."""

    def __init__(self, emb_dim: int, feature_dims: Sequence[int], *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feature_dims = tuple(feature_dims)
        self.embs = nn.ModuleList(
            nn.utils.skip_init(nn.Embedding, vocab, emb_dim) for vocab in self.feature_dims)
        for emb in self.embs:
            xavier_uniform_(emb.weight, 1.0, generator)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = 0.0
        for i, (emb, vocab) in enumerate(zip(self.embs, self.feature_dims)):
            out = out + emb(x[:, i].clamp(0, vocab - 1))
        return out


class AtomEncoder(CategoricalEncoder):
    def __init__(self, emb_dim: int, **kw):
        super().__init__(emb_dim, ATOM_FEATURE_DIMS, **kw)


class BondEncoder(CategoricalEncoder):
    def __init__(self, emb_dim: int, **kw):
        super().__init__(emb_dim, BOND_FEATURE_DIMS, **kw)
