"""Edge-partitioned full-graph aggregation with a halo exchange.

Counterpart of ``dgl_tpu/parallel/halo.py``. Nodes are owned in contiguous
ranges of ``nodes_per_shard`` rows, one range per rank (relabel by a
locality partition first for smaller halos); each rank holds the in-edges
of its own rows and its own rows of every node array.

The plans are host numpy, built once, and equal the JAX plans row for row:
``nodes_per_shard`` (rounded up to 8), ``n_pad``, the rows per pair ``H``,
``send_tab`` and the per-shard CSRs. The port keeps no 128-edge padding
(static-shape sentinels, which it does not port): ``local_src`` and
``halo_remap`` hold one array per shard, of its own length.

* ``shard_fullgraph``: the all-gather halo. ``halo_spmm`` all-gathers the
  rows (the backward reduce-scatters the cotangent) and aggregates the
  rank's in-edges, whose sources keep their global ids.
* ``shard_fullgraph_boundary``: the boundary exchange. Each rank ships
  exactly the rows another rank's edges read: ``send_tab[o, s]`` lists the
  owner-local rows ``o`` sends to ``s`` (padded with row 0), ``H`` of them
  for every pair, one ``all_to_all`` of (k·H, D) rows a layer.

``place`` puts one rank's part of a plan on its device. For the boundary
plan that is two graphs (``HaloShard``):

* ``graph``, bipartite (``graph/graph.py``): its source table is
  ``[own rows ; received rows]`` (``nodes_per_shard + k·H`` rows), local
  edges keep their source and halo edges read ``nodes_per_shard +
  halo_remap``, so local and halo edges of a destination sit in one CSR;
* ``send``, the send graph: source = the rows sent, destination = the
  payload slots. The payload is ``gather_src_rows(send, x)``, P1 in source
  order; its adjoint is K1 over the send graph's reverse CSR, which sums
  the cotangents of a row sent to several slots (row 0's padding
  included) with no atomics. ``exchange.send_adjoint_launches`` counts
  those K1 launches.

The aggregations then run the single-card kernels on ``graph``: SAGE's
``copy_u`` mean/sum through K1 (``ops/spmm.py``), RGCN through weighted K1
(``ops/rel.py:gspmm_rel``) and GAT through K3 (``kernels/gat_attention.py``),
each of whose backwards runs over ``graph``'s reverse CSR, then sends the
cotangent of the received rows back (the exchange's transpose) and through
the send graph's adjoint. Rows with no in-edge, padding rows past
``num_nodes`` among them, are 0.

Unlike the JAX design, the local edges' aggregation does not overlap the
exchange (it waits for the received rows, in one CSR with them), and GAT's
softmax shifts by the exact row maximum over all in-edges, which K3 takes,
instead of ``leaky_relu(pmax(a_src) + a_dst)``: that bound underflows
``exp`` once ``a_src`` spreads over more than ~87 and zeroes whole rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

import numpy as np
import torch

from ..csrc import native
from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph, from_edges
from ..graph.partition import partition_assignment
from ..kernels.csr_spmm import csr_spmm
from ..kernels.gat_attention import gat_attention_vectors
from ..ops.gather import _GatherSrcRows
from ..ops.rel import RelEdgeWeights, gspmm_rel
from ..ops.spmm import gspmm
from .comm import all_gather, all_to_all, world_size

__all__ = [
    "pad_length",
    "relabel",
    "ShardedGraph",
    "shard_fullgraph",
    "BoundarySharded",
    "shard_fullgraph_boundary",
    "plan_layout_edata_boundary",
    "AllGatherShard",
    "HaloShard",
    "place",
    "exchange",
    "halo_spmm",
    "halo_spmm_boundary",
    "halo_rgcn_boundary",
    "halo_gat_boundary",
]

_LANES = 128


def pad_length(n: int, multiple: int = _LANES) -> int:
    """Round ``n`` up to a multiple (minimum one multiple): the port's copy
    of ``dgl_tpu/graph/graph.py:pad_length``."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def _i64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64)


def relabel(src, dst, num_nodes: int, k: int, seed: int):
    """The locality relabel before a plan: nodes sorted by their ``lp``
    part (``graph/partition.py:partition_assignment``). Returns ``(src,
    dst, order)`` in the new ids, ``order[i]`` the input id of new node
    ``i``."""
    src, dst = _i64(src), _i64(dst)
    part = partition_assignment(src, dst, num_nodes, k, seed=seed)
    order = np.argsort(part, kind="stable")
    new_id = np.empty(num_nodes, np.int64)
    new_id[order] = np.arange(num_nodes)
    return new_id[src], new_id[dst], order


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """The all-gather plan: shard ``s`` owns rows ``[s·nps, (s+1)·nps)``;
    ``src[s]`` the global source ids of its in-edges, dst-sorted by
    ``indptr[s]`` (k, nps + 1)."""

    src: List[np.ndarray]
    indptr: np.ndarray
    num_nodes: int
    nodes_per_shard: int
    num_shards: int


def shard_fullgraph(src, dst, num_nodes: int, num_shards: int) -> Tuple[ShardedGraph, int]:
    """Partition the edges by contiguous dst ranges. Returns ``(plan,
    n_pad)``; node arrays are padded to ``n_pad = nodes_per_shard · k`` rows."""
    src, dst = _i64(src), _i64(dst)
    nps = pad_length(-(-num_nodes // num_shards), 8)
    shard_of = dst // nps
    srcs, indptr = [], np.zeros((num_shards, nps + 1), np.int64)
    for s in range(num_shards):
        m = shard_of == s
        indptr[s], src_sorted, _ = native.build_csr(dst[m] - s * nps, src[m], nps)
        srcs.append(src_sorted)
    return ShardedGraph(srcs, indptr, num_nodes, nps, num_shards), nps * num_shards


@dataclasses.dataclass(frozen=True)
class BoundarySharded:
    """The boundary-exchange plan (``dgl_tpu.parallel.BoundarySharded``
    without its padding). For shard ``s``: ``local_src[s]`` the owner-local
    sources of its local edges, dst-sorted by ``local_indptr[s]``;
    ``halo_remap[s]`` the rows of the received (k·H)-row table its halo
    edges read, dst-sorted by ``halo_indptr[s]``. ``send_tab`` (k, k, H):
    ``send_tab[o, s]`` the owner-local rows ``o`` ships to ``s``, 0 as
    padding."""

    local_src: List[np.ndarray]
    local_indptr: np.ndarray
    halo_remap: List[np.ndarray]
    halo_indptr: np.ndarray
    send_tab: np.ndarray
    num_nodes: int
    nodes_per_shard: int
    num_shards: int
    rows_per_pair: int


def shard_fullgraph_boundary(src, dst, num_nodes: int, num_shards: int,
                             return_eids: bool = False):
    """Host build of the boundary-exchange plan: ``(plan, n_pad)``, and with
    ``return_eids`` also ``(local_eids, halo_eids)``, each shard's input
    edge ids in its local and halo order (for ``plan_layout_edata_boundary``)."""
    src, dst = _i64(src), _i64(dst)
    k = num_shards
    nps = pad_length(-(-num_nodes // k), 8)
    shard_of, src_shard = dst // nps, src // nps
    local_src, halo_src, local_eids, halo_eids, needed = [], [], [], [], []
    local_indptr = np.zeros((k, nps + 1), np.int64)
    halo_indptr = np.zeros((k, nps + 1), np.int64)
    for s in range(k):
        m = shard_of == s
        loc, hal = m & (src_shard == s), m & (src_shard != s)
        local_indptr[s], ls, lord = native.build_csr(dst[loc] - s * nps, src[loc] - s * nps, nps)
        halo_indptr[s], hs, hord = native.build_csr(dst[hal] - s * nps, src[hal], nps)
        local_src.append(ls)
        halo_src.append(hs)
        if return_eids:
            local_eids.append(np.flatnonzero(loc)[lord])
            halo_eids.append(np.flatnonzero(hal)[hord])
        uniq = np.unique(hs)
        owners = uniq // nps
        needed.append([uniq[owners == o] - o * nps for o in range(k)])

    H = max(max((len(rows) for req in needed for rows in req), default=1), 1)
    send_tab = np.zeros((k, k, H), np.int64)
    lookup = np.zeros(nps * k, np.int64)
    halo_remap = []
    for s in range(k):
        for o in range(k):
            rows = needed[s][o]
            send_tab[o, s, :len(rows)] = rows
            lookup[o * nps + rows] = o * H + np.arange(len(rows))
        halo_remap.append(lookup[halo_src[s]])
    plan = BoundarySharded(local_src, local_indptr, halo_remap, halo_indptr, send_tab,
                           num_nodes, nps, k, H)
    if return_eids:
        return plan, nps * k, local_eids, halo_eids
    return plan, nps * k


def plan_layout_edata_boundary(bs: BoundarySharded, local_eids, halo_eids, edata):
    """Per-edge data in input edge order → each shard's local and halo
    layouts: two lists of (E_s, ...) arrays, in ``local_src`` /
    ``halo_remap`` order."""
    edata = np.asarray(edata)
    return ([edata[e] for e in local_eids[:bs.num_shards]],
            [edata[e] for e in halo_eids[:bs.num_shards]])


def _rows_of(indptr: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))


@dataclasses.dataclass(frozen=True)
class AllGatherShard:
    """One rank's part of a ``ShardedGraph``: its in-edges as a bipartite
    graph from the ``n_pad`` gathered rows to its ``nodes_per_shard`` rows."""

    graph: Graph
    rank: int
    num_shards: int
    nodes_per_shard: int
    group: object = None


@dataclasses.dataclass(frozen=True)
class HaloShard:
    """One rank's part of a ``BoundarySharded`` plan (see the module
    docstring); ``group`` is the process group of the plan's k ranks (None:
    the world)."""

    graph: Graph
    send: Graph
    rank: int
    num_shards: int
    nodes_per_shard: int
    rows_per_pair: int
    group: object = None

    @staticmethod
    def build(local_src, local_indptr, halo_remap, halo_indptr, send_row, *, rank: int,
              num_shards: int, rows_per_pair: int, device: DeviceLike = None,
              group=None) -> "HaloShard":
        """From shard ``rank``'s arrays of a plan (``send_row`` =
        ``send_tab[rank]``), on ``device``."""
        dev = resolve_device(device)
        nps = len(local_indptr) - 1
        slots = num_shards * rows_per_pair
        src = np.concatenate([_i64(local_src), nps + _i64(halo_remap)])
        dst = np.concatenate([_rows_of(_i64(local_indptr)), _rows_of(_i64(halo_indptr))])
        graph = from_edges(src, dst, nps + slots, nps, device=dev)
        send = from_edges(_i64(send_row).reshape(-1), np.arange(slots), nps, slots, device=dev)
        return HaloShard(graph, send, rank, num_shards, nps, rows_per_pair, group)

    def edge_weights(self, w_local, w_halo) -> RelEdgeWeights:
        """Per-edge relation weights (this shard's local and halo layouts
        from ``plan_layout_edata_boundary``, (E, R)) laid out for K1 on
        ``graph``: local edges first, then halo edges, in the input order
        of ``graph`` (its ``eid``)."""
        w = torch.from_numpy(np.ascontiguousarray(
            np.concatenate([np.asarray(w_local, np.float32), np.asarray(w_halo, np.float32)])))
        w = w.to(self.graph.src.device)
        return RelEdgeWeights.build(self.graph, w.index_select(0, self.graph.eid.long()))


Shard = Union[AllGatherShard, HaloShard]


def place(plan: Union[ShardedGraph, BoundarySharded], rank: int, device: DeviceLike = None,
          group=None) -> Shard:
    """Shard ``rank``'s part of ``plan`` on ``device``."""
    if isinstance(plan, ShardedGraph):
        nps = plan.nodes_per_shard
        graph = from_edges(plan.src[rank], _rows_of(plan.indptr[rank]), nps * plan.num_shards,
                           nps, device=device)
        return AllGatherShard(graph, rank, plan.num_shards, nps, group)
    return HaloShard.build(plan.local_src[rank], plan.local_indptr[rank], plan.halo_remap[rank],
                           plan.halo_indptr[rank], plan.send_tab[rank], rank=rank,
                           num_shards=plan.num_shards, rows_per_pair=plan.rows_per_pair,
                           device=device, group=group)


class _SendGather(_GatherSrcRows):
    """``gather_src_rows`` over a send graph: its adjoint adds the K1
    launches it makes to ``exchange.send_adjoint_launches``."""

    @staticmethod
    def backward(ctx, ge):
        before = csr_spmm.launches
        grads = _GatherSrcRows.backward(ctx, ge)
        exchange.send_adjoint_launches += csr_spmm.launches - before
        return grads


def exchange(shard: HaloShard, x: torch.Tensor) -> torch.Tensor:
    """The source table ``[x ; received rows]`` ((nps + k·H, ...)): the
    payload ``x[send_tab[rank]]`` (P1 in source order), one ``all_to_all``,
    then the received rows after this rank's own."""
    if world_size(shard.group) != shard.num_shards:
        raise ValueError(f"a plan of {shard.num_shards} shards runs on as many ranks, not "
                         f"{world_size(shard.group)}")
    flat = x.reshape(x.shape[0], -1)
    recv = all_to_all(_SendGather.apply(flat, shard.send), shard.group)
    return torch.cat([flat, recv]).reshape((-1,) + tuple(x.shape[1:]))


exchange.send_adjoint_launches = 0


def halo_spmm(shard: AllGatherShard, x: torch.Tensor, reduce: str = "mean") -> torch.Tensor:
    """``copy_u`` SpMM over the all-gather plan: ``x`` (nps, D) this rank's
    rows; returns its (nps, D) rows."""
    return gspmm(shard.graph, "copy_u", reduce, x=all_gather(x, shard.group))


def halo_spmm_boundary(shard: HaloShard, x: torch.Tensor, reduce: str = "mean") -> torch.Tensor:
    """``copy_u`` SpMM exchanging only the boundary rows: ``x`` (nps, D)
    this rank's rows; returns its (nps, D) rows (K1)."""
    return gspmm(shard.graph, "copy_u", reduce, x=exchange(shard, x))


def halo_rgcn_boundary(shard: HaloShard, y: torch.Tensor, weights: RelEdgeWeights, n_rel: int,
                       reduce: str = "mean") -> torch.Tensor:
    """Relation-contracted SpMM across shards (RGCN): per edge
    ``Σ_r w[e, r] · y[src, r·D:(r+1)·D]``, reduced by dst. ``y`` (nps, R·D)
    node-major, as the JAX function takes it, so one exchange ships each
    node's R projections in one row; the table is then laid out
    relation-major for ``gspmm_rel`` (weighted K1, R passes), one visible
    copy a layer. ``weights`` from ``HaloShard.edge_weights``."""
    table = exchange(shard, y)
    d = y.shape[1] // n_rel
    rel_major = table.reshape(table.shape[0], n_rel, d).permute(1, 0, 2).contiguous()
    return gspmm_rel(reduce, shard.graph, rel_major, weights)


def halo_gat_boundary(shard: HaloShard, z: torch.Tensor, attn_src: torch.Tensor,
                      attn_dst: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """Multi-head attention aggregation over all in-edges of this rank's
    rows, local and halo: ``z`` (nps, H, D), the attention vectors
    ``attn_src`` and ``attn_dst`` (1, H, D) (GATConv's ``attn_r`` and
    ``attn_l``). One exchange ships z's rows; K3 (keep 1, with its node
    passes) then scores every row of the table, ``a_src = Σ_D z·attn_src``,
    and this rank's rows, ``a_dst = Σ_D z·attn_dst``, and takes the softmax
    of ``leaky_relu(a_src[u] + a_dst[v])`` over each row with its exact
    maximum. The JAX function takes the scores and ships them beside z.
    The attention vectors' gradients are this rank's share: their sum over
    the ranks is the gradient. Returns (nps, H, D)."""
    return gat_attention_vectors(shard.graph, exchange(shard, z), attn_src, attn_dst, z_dst=z,
                                 negative_slope=negative_slope)
