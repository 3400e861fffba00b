"""Distribution: the halo exchange, edge-sharded SpMM, data parallelism and
process start-up, over ``torch.distributed``.

Counterpart of ``dgl_tpu/parallel``. One process drives one rank; the
JAX mesh becomes the rank grid (``multihost.RankMesh``) and ``shard_map``'s
collectives become those of ``comm.py``. ``launch.spawn`` starts k local
ranks. The JAX package's ``halo_<model>_init`` / ``halo_<model>_apply``
pairs are the modules ``HaloSAGE``, ``HaloGAT`` and ``HaloRGCN``
(constructor and forward), and ``place`` gives one rank its part of a plan.
"""

from .dp import make_dp_train_step, stack_minibatches
from .halo import (
    BoundarySharded,
    ShardedGraph,
    halo_gat_boundary,
    halo_rgcn_boundary,
    halo_spmm,
    halo_spmm_boundary,
    place,
    plan_layout_edata_boundary,
    shard_fullgraph,
    shard_fullgraph_boundary,
)
from .halo_train import (
    HaloGAT,
    HaloRGCN,
    HaloSAGE,
    exchange_stats,
    make_halo_gat_train_step,
    make_halo_rgcn_train_step,
    make_halo_train_step,
)
from .multihost import global_mesh, initialize
from .spmd import device_mesh, graph_sharding, node_sharding, replicated, shard_graph

__all__ = [
    "device_mesh",
    "replicated",
    "graph_sharding",
    "node_sharding",
    "shard_graph",
    "ShardedGraph",
    "shard_fullgraph",
    "halo_spmm",
    "place",
    "BoundarySharded",
    "shard_fullgraph_boundary",
    "halo_spmm_boundary",
    "HaloSAGE",
    "halo_gat_boundary",
    "HaloGAT",
    "halo_rgcn_boundary",
    "HaloRGCN",
    "plan_layout_edata_boundary",
    "make_halo_train_step",
    "make_halo_gat_train_step",
    "make_halo_rgcn_train_step",
    "exchange_stats",
    "stack_minibatches",
    "make_dp_train_step",
    "initialize",
    "global_mesh",
]
