"""Graph-classification minibatches, collated on the host ahead of the card.

Counterpart of ``dgl_tpu/sampling/dataloader.py`` (the reference's
``GraphDataLoader``). A background thread (``prefetch``) collates each batch
in numpy: the block-diagonal union with its dst sort and both row splits
(``graph/batch.py``), the node features, the edge features put into the
union's canonical (dst-sorted) order by ``eid``, and the labels. On the way
to a card it pins them; the consumer copies them with ``non_blocking=True``,
so a training step waits on nothing the host does.

Batch composition is reshuffled every epoch, as the reference's loader
does; the JAX loader replays its first epoch's batches from a device cache
(a workaround for its host link) and is not followed there. The first
epoch's order is the JAX loader's for the same seed: both shuffle with
``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..graph.batch import GraphBatch, batch_graphs

__all__ = ["prefetch", "GraphBatchLoader"]


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue; an
    error in the thread is raised in the consumer. A consumer that stops
    early (``close()``) stops the thread: it produces at most one more
    item."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                if stop.is_set():
                    break
                q.put(item)
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()
    finished = False
    try:
        while True:
            item = q.get()
            if item is end:
                finished = True
                if err:
                    raise err[0]
                return
            yield item
    finally:
        if not finished:  # closed early: free the worker's put until it ends
            stop.set()
            while q.get() is not end:
                pass


class GraphBatchLoader:
    """Yields ``(batch, node_feats, edge_feats or None, labels)`` on
    ``device``, ``len(self)`` batches an epoch of at most ``batch_size``
    graphs (the last one shorter)."""

    def __init__(
        self,
        graphs: Sequence[Tuple[np.ndarray, np.ndarray, int]],
        node_feats: Sequence[np.ndarray],
        labels: np.ndarray,
        batch_size: int,
        *,
        edge_feats: Optional[Sequence[Optional[np.ndarray]]] = None,
        shuffle: bool = True,
        seed: int = 0,
        prefetch_depth: int = 2,
        device: DeviceLike = None,
    ):
        self.graphs = graphs
        self.node_feats = node_feats
        self.edge_feats = edge_feats
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch_depth = prefetch_depth
        self.device = resolve_device(device)

    def __len__(self) -> int:
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def _collate(self, idx: np.ndarray):
        batch = batch_graphs([self.graphs[i] for i in idx], device="cpu")
        nf = torch.from_numpy(np.concatenate([self.node_feats[i] for i in idx]))
        ef = None
        if self.edge_feats is not None and self.edge_feats[idx[0]] is not None:
            flat = np.concatenate([self.edge_feats[i] for i in idx])
            ef = torch.from_numpy(flat[batch.graph.eid.numpy()])  # canonical order
        y = torch.from_numpy(self.labels[idx])
        if self.device.type == "cuda":
            batch, nf, y = batch.pin_memory(), nf.pin_memory(), y.pin_memory()
            ef = None if ef is None else ef.pin_memory()
        return batch, nf, ef, y

    def _epoch_indices(self):
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            yield idx[i: i + self.batch_size]

    def __iter__(self) -> Iterator[Tuple[GraphBatch, torch.Tensor, Optional[torch.Tensor],
                                         torch.Tensor]]:
        dev = self.device
        for batch, nf, ef, y in prefetch(map(self._collate, self._epoch_indices()),
                                         self.prefetch_depth):
            if dev.type == "cpu":
                yield batch, nf, ef, y
            else:
                yield (batch.to(dev, non_blocking=True), nf.to(dev, non_blocking=True),
                       None if ef is None else ef.to(dev, non_blocking=True),
                       y.to(dev, non_blocking=True))
