"""Cluster-GCN style partition-batched iteration.

Counterpart of ``dgl_tpu/sampling/cluster.py`` (the reference's
``ClusterIter`` and ``subgraph_collate_fn``, ``cluster-sage/dgl/
sampler.py:11-71``, and the link-prediction variant with its negative-edge
graph, ``dgl_cluster_sampler.py:30-109``). The graph is partitioned once
(``graph/partition.py``, cached on disk); each epoch shuffles the parts and
each step takes ``batch_size`` of them:

* on the host, in a prefetch thread: the parts' nodes, the node-induced
  subgraph (the native extractor, ``csrc/native.py``), with
  ``with_negatives`` one uniform negative destination per edge, and the
  batch's graphs on CPU tensors (``_host_graph``: both CSRs by the native
  counting sort, and their row splits), pinned when the batch goes to a
  card;
* on the consumer's side: the graphs and the node ids copied to the card
  with ``non_blocking``, then ``x`` as P1 in index order
  (``row_gather_async``) over the features, ``y`` and the train mask by
  ``index_select``, from the copies the iterator keeps on the card.

The same ``seed`` gives the JAX iterator's partition, its per-epoch
``rng.permutation(psize)``, its batches and, with ``with_negatives``, its
``rng.integers`` negatives, drawn in its order: ``first()`` draws them too.
Batches are the unpadded ones: the JAX iterator pads nodes and edges to
buckets (``_bucket``, ``quantize_trace_meta``) for the TPU's static shapes,
and freezes one grouping behind ``freeze``; neither is ported (the
reference regroups every epoch). ``has_train`` is decided on the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Union

import numpy as np
import torch

from ..csrc import native
from ..device import DeviceLike, resolve_device
from ..graph.batch import _map_tensors
from ..graph.graph import Graph
from ..graph.partition import get_partition_list, partition_assignment, partition_stats
from ..graph.split import row_split
from ..kernels.row_gather import row_gather_async
from .dataloader import prefetch

__all__ = ["ClusterIter", "ClusterBatch"]

Array = Union[np.ndarray, torch.Tensor]

_PREFETCH_DEPTH = 2  # host batches collated ahead of the consumer


@dataclasses.dataclass
class ClusterBatch:
    graph: Graph
    nodes: np.ndarray  # original node ids, on the host
    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor  # the train mask of the batch's nodes
    neg_graph: Optional[Graph] = None  # with_negatives: one uniform negative per edge
    # the skip-batch check (cluster-sage main.py:138) without a read from the card
    has_train: bool = True


@dataclasses.dataclass
class _HostBatch:
    """What the prefetch thread collates: CPU tensors, pinned for a card."""

    graph: Graph
    nodes: np.ndarray
    nodes_t: torch.Tensor
    neg_graph: Optional[Graph]
    has_train: bool


def _host_graph(src: np.ndarray, dst: np.ndarray, n: int) -> Graph:
    """``from_edges(src, dst, n, device="cpu")``, the same arrays bit for
    bit, by two O(E) native counting sorts (``native.build_csr``, stable as
    from_edges' sorts are) in place of torch's: a few milliseconds less a
    batch on the host."""
    def rows(indptr):
        return np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    def t(a):
        return torch.from_numpy(a.astype(np.int32))

    indptr, s, eid = native.build_csr(dst, src, n)
    d = rows(indptr)
    rindptr, rs, reid = native.build_csr(s, d, n)
    rev = Graph(t(rs), t(rows(rindptr)), t(rindptr), t(reid), n, n, row_split(rindptr))
    return Graph(t(s), t(d), t(indptr), t(eid), n, n, row_split(indptr), rev)


def _on(dev: torch.device, a: Array) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dev)


class ClusterIter:
    """``len(self)`` batches an epoch of ``batch_size`` random parts each (the
    last one shorter). ``features``, ``labels`` and ``train_mask`` go to
    ``device`` once (tensors already there are used as they are); ``src`` and
    ``dst`` stay on the host. ``collate_s`` gathers every batch's host
    seconds (its subgraph, graphs and pinning)."""

    def __init__(
        self,
        name: str,
        src: np.ndarray,
        dst: np.ndarray,
        num_nodes: int,
        features: Array,
        labels: Array,
        train_mask: Array,
        psize: int,
        batch_size: int,
        *,
        method: str = "metis",
        seed: int = 0,
        cache_dir: Optional[str] = None,
        with_negatives: bool = False,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.num_nodes, self.psize, self.batch_size = num_nodes, psize, batch_size
        self.rng = np.random.default_rng(seed)
        self.with_negatives = with_negatives
        self.features = _on(self.device, features).float()
        self.labels = _on(self.device, labels)
        self.train_mask = _on(self.device, train_mask)
        self._train_host = np.asarray(train_mask.cpu() if isinstance(train_mask, torch.Tensor)
                                      else train_mask, bool)
        part = partition_assignment(src, dst, num_nodes, psize, method=method, seed=seed,
                                    cache_dir=cache_dir, cache_key=name)
        self.part_stats = partition_stats(src, dst, part, psize)
        print(f"partition[{method}] k={psize}: edge_cut={self.part_stats['edge_cut']:.3f} "
              f"balance={self.part_stats['balance']:.2f}")
        self.par_li = get_partition_list(part, psize)
        indptr, dst_sorted, _ = native.build_csr(src, dst, num_nodes)
        self._extractor = native.SubgraphExtractor(indptr, dst_sorted, num_nodes)
        self.collate_s: List[float] = []

    def __len__(self) -> int:
        return (self.psize + self.batch_size - 1) // self.batch_size

    def _collate_host(self, part_ids: np.ndarray) -> _HostBatch:
        t0 = time.perf_counter()
        nodes = np.concatenate([self.par_li[i] for i in part_ids])
        s, d = self._extractor.extract(nodes)
        n = len(nodes)
        g = _host_graph(s, d, n)
        neg = None
        if self.with_negatives:  # dgl_cluster_sampler.py:97-109
            neg = _host_graph(s, self.rng.integers(0, max(n, 1), size=len(s)), n)
        b = _HostBatch(g, nodes, torch.from_numpy(nodes), neg,
                       bool(self._train_host[nodes].any()))
        if self.device.type == "cuda":
            b = _map_tensors(b, lambda t: t.pin_memory())
        self.collate_s.append(time.perf_counter() - t0)
        return b

    def _finish(self, b: _HostBatch) -> ClusterBatch:
        """The host batch on the card, with its rows gathered there."""
        b = _map_tensors(b, lambda t: t.to(self.device, non_blocking=True))
        g, neg, idx = b.graph, b.neg_graph, b.nodes_t
        return ClusterBatch(graph=g, nodes=b.nodes, x=row_gather_async(self.features, idx),
                            y=self.labels.index_select(0, idx),
                            mask=self.train_mask.index_select(0, idx), neg_graph=neg,
                            has_train=b.has_train)

    def first(self) -> ClusterBatch:
        """The batch of parts ``0 .. batch_size - 1``, without the prefetch
        thread; the JAX drivers build their model from it, and with
        ``with_negatives`` it draws its negatives from the stream."""
        return self._finish(self._collate_host(np.arange(min(self.batch_size, self.psize))))

    def _gen(self) -> Iterator[_HostBatch]:
        perm = self.rng.permutation(self.psize)
        for i in range(0, self.psize, self.batch_size):
            yield self._collate_host(perm[i: i + self.batch_size])

    def __iter__(self) -> Iterator[ClusterBatch]:
        stream = prefetch(self._gen(), _PREFETCH_DEPTH)
        try:
            for b in stream:
                yield self._finish(b)
        finally:
            stream.close()  # a consumer that stops early stops the thread
