"""Heterogeneous graphs: typed node sets and typed bipartite relations.

Counterpart of ``dgl_tpu/graph/hetero.py`` (the DGL heterograph that GCMC
builds, ``gcmc_dgl/data.py:257-263``): a dict of :class:`Graph` relations
keyed by the canonical edge type ``(src_type, relation, dst_type)`` and a
node count per type. Convolutions loop over the relations in Python
(``nn/gcmc.py``, ``nn/hetero.py``); each relation is an ordinary CSR pair,
bipartite where its two node types differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

from ..device import DeviceLike
from .graph import Graph

EType = Tuple[str, str, str]

__all__ = ["HeteroGraph", "EType"]


@dataclasses.dataclass(frozen=True)
class HeteroGraph:
    """``relations``: {(src_type, rel, dst_type): Graph};
    ``num_nodes``: {node_type: count}."""

    relations: Dict[EType, Graph]
    num_nodes: Mapping[str, int]

    def __getitem__(self, etype: EType) -> Graph:
        return self.relations[etype]

    @property
    def etypes(self) -> List[EType]:
        return sorted(self.relations.keys())

    def node_types(self) -> List[str]:
        return sorted(self.num_nodes.keys())

    def validate(self) -> "HeteroGraph":
        """Every relation's node counts equal its node types'; raises
        ``ValueError`` otherwise."""
        for (st, rel, dt), g in self.relations.items():
            if g.num_src_nodes != self.num_nodes[st] or g.num_dst_nodes != self.num_nodes[dt]:
                raise ValueError(f"relation {(st, rel, dt)}: {g} does not match "
                                 f"{st}={self.num_nodes[st]}, {dt}={self.num_nodes[dt]}")
        return self

    def to(self, device: DeviceLike) -> "HeteroGraph":
        return HeteroGraph({k: g.to(device) for k, g in self.relations.items()},
                           dict(self.num_nodes))
