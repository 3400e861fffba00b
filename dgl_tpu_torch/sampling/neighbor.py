"""Host-side neighbour sampling into positional blocks.

Counterpart of ``dgl_tpu/sampling/neighbor.py`` (DGL's
``MultiLayerNeighborSampler`` and ``NodeDataLoader``,
``ns-sage-dgl.py:132-141``):

* every seed gets exactly ``fanout`` sampled in-neighbours (with
  replacement, or distinct ones filled cyclically where the degree is
  smaller, ``csrc/native.py``), so a block of ``B`` destinations has
  ``B + B·fanout`` sources and ``B·fanout`` edges whatever was sampled;
* sources are not deduplicated: the seeds come first (``h_dst = h[:B]``,
  as ``ns-sage-dgl.py:51-57`` slices), then each seed's samples in order;
* so a block's structure depends only on ``(B, fanout)``: edge ``(i, j)``
  runs from source slot ``B + i·fanout + j`` to destination ``i``. The
  skeleton blocks are built once per ``(B, device)`` on the device, with no
  sort, and serve every step; only ``input_nodes``, the padded seeds and
  their mask change.

The random stream is the JAX sampler's: the loader shuffles the ids once an
epoch with its numpy ``Generator`` and each layer, innermost first, draws
one ``integers(0, 2**63 - 1)`` from it as the native sampler's seed, so the
same seed gives the same ``input_nodes`` bit for bit wherever the OpenMP
team size is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..csrc import native
from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph, _as_int64, _build_sorted
from ..graph.split import row_split
from .dataloader import prefetch

__all__ = ["CSRGraph", "MiniBatch", "MultiLayerNeighborSampler", "NodeDataLoader"]

_PREFETCH_DEPTH = 3  # host batches sampled ahead of the consumer

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class CSRGraph:
    """Host in-edge CSR for sampling: the in-neighbours of node ``v`` are
    ``indices[indptr[v]:indptr[v + 1]]``, in input edge order (int64)."""

    indptr: np.ndarray
    indices: np.ndarray
    num_nodes: int

    @staticmethod
    def from_edges(src, dst, num_nodes: int, *, device: DeviceLike = None) -> "CSRGraph":
        """Sort the edges by destination (stably, on ``device``: ``None``
        means ``cuda``) and copy the CSR to the host."""
        dev = resolve_device(device)
        s, d = _as_int64(src, dev), _as_int64(dst, dev)
        if s.dim() != 1 or s.shape != d.shape:
            raise ValueError(f"src/dst must be 1-D and equal length, got {tuple(s.shape)} vs "
                             f"{tuple(d.shape)}")
        if max(s.numel(), num_nodes) > _INT32_MAX:
            raise ValueError(f"graph too large for int32 ids: {s.numel()} edges, {num_nodes} nodes")
        if s.numel() and (min(s.min(), d.min()) < 0 or max(s.max(), d.max()) >= num_nodes):
            raise ValueError(f"node ids out of range [0, {num_nodes})")
        indices, _, indptr, _ = _build_sorted(s, d, num_nodes)
        return CSRGraph(indptr.cpu().numpy().astype(np.int64),
                        indices.cpu().numpy().astype(np.int64), num_nodes)


@dataclasses.dataclass
class MiniBatch:
    """One sampled step; ``blocks`` are outermost first (apply in order)."""

    blocks: List[Graph]
    input_nodes: torch.Tensor  # (num_src_nodes of blocks[0],) int32
    seeds: torch.Tensor  # (B,) int32, padded with 0
    seed_mask: torch.Tensor  # (B,) bool, False on the padding

    def to(self, device: DeviceLike, non_blocking: bool = False) -> "MiniBatch":
        dev = resolve_device(device)
        return MiniBatch([g.to(dev) for g in self.blocks],
                         self.input_nodes.to(dev, non_blocking=non_blocking),
                         self.seeds.to(dev, non_blocking=non_blocking),
                         self.seed_mask.to(dev, non_blocking=non_blocking))


def _skeleton_block(n_dst: int, fanout: int, dev: torch.device) -> Graph:
    """The positional block of ``n_dst`` destinations and ``fanout`` slots
    each, with its analytic reverse: in-degree 0 for the first ``n_dst``
    source slots, 1 for every other. Both CSRs are already sorted and share
    one edge order; their row splits are planned from host copies of the
    offsets (empty while fanout ≤ T)."""
    n_e = n_dst * fanout
    n_src = n_dst + n_e
    if n_src > _INT32_MAX:
        raise ValueError(f"a block of {n_dst} destinations at fanout {fanout} needs {n_src} "
                         "source slots, more than int32 ids hold")
    eid = torch.arange(n_e, dtype=torch.int32, device=dev)
    e_src = eid + n_dst
    e_dst = torch.div(eid, fanout, rounding_mode="floor")
    indptr = fanout * np.arange(n_dst + 1, dtype=np.int64)
    rev_indptr = np.maximum(np.arange(n_src + 1, dtype=np.int64) - n_dst, 0)

    def on_dev(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    rev = Graph(e_dst, e_src, on_dev(rev_indptr), eid, n_dst, n_src,
                row_split(rev_indptr, device=dev))
    return Graph(e_src, e_dst, on_dev(indptr), eid, n_src, n_dst, row_split(indptr, device=dev),
                 rev, block_fanout=fanout)


class MultiLayerNeighborSampler:
    """Fanout per layer, listed outermost first (DGL's
    ``MultiLayerNeighborSampler([10, 25])``). ``replace=False`` samples
    distinct neighbours (the reference's reddit default); seeds with fewer
    in-neighbours than the fanout fill their slots cyclically, so mean
    aggregation weights them up to ±1 repeat and sum aggregation
    over-counts them (``csrc/graph_ops.cpp``)."""

    def __init__(self, fanouts: Sequence[int], replace: bool = True):
        self.fanouts = [int(f) for f in fanouts]
        if not self.fanouts or min(self.fanouts) < 1:
            raise ValueError(f"fanouts must be positive, got {list(fanouts)}")
        if not replace and max(self.fanouts) > native.NOREPLACE_MAX_FANOUT:
            raise ValueError(f"without replacement a fanout is at most "
                             f"{native.NOREPLACE_MAX_FANOUT}, got {self.fanouts}")
        self.replace = replace
        self._skel = {}

    def sample_layer(self, csr: CSRGraph, seeds: np.ndarray, fanout: int,
                     rng: np.random.Generator) -> np.ndarray:
        """(len(seeds), fanout) sampled in-neighbour ids; a seed with no
        in-edge samples itself."""
        fn = native.sample_neighbors if self.replace else native.sample_neighbors_noreplace
        return fn(csr.indptr, csr.indices, seeds, fanout, int(rng.integers(0, 2**63 - 1)))

    def skeleton_blocks(self, b_pad: int, device: DeviceLike = None) -> List[Graph]:
        """The blocks of a batch of ``b_pad`` seeds on ``device``, outermost
        first; built once per ``(b_pad, device)`` and cached."""
        dev = resolve_device(device)
        key = (b_pad, str(dev))
        blocks = self._skel.get(key)
        if blocks is None:
            blocks, n_dst = [], b_pad
            for fanout in reversed(self.fanouts):
                blocks.append(_skeleton_block(n_dst, fanout, dev))
                n_dst = blocks[-1].num_src_nodes
            blocks.reverse()
            self._skel[key] = blocks
        return blocks

    def sample_host(self, csr: CSRGraph, seeds, rng: np.random.Generator,
                    b_pad: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(input_nodes, seeds, seed_mask)`` of one step as numpy arrays:
        the seeds padded to ``b_pad`` with node 0 (which is sampled too, as
        in the JAX sampler), then each layer's samples, innermost first."""
        b = len(seeds)
        if b > b_pad:
            raise ValueError(f"{b} seeds do not fit a batch of {b_pad}")
        seeds_p = np.zeros(b_pad, dtype=np.int64)
        seeds_p[:b] = seeds
        mask = np.zeros(b_pad, dtype=bool)
        mask[:b] = True
        cur = seeds_p
        for fanout in reversed(self.fanouts):
            cur = np.concatenate([cur, self.sample_layer(csr, cur, fanout, rng).reshape(-1)])
        return cur.astype(np.int32), seeds_p.astype(np.int32), mask

    def sample(self, csr: CSRGraph, seeds, rng: np.random.Generator, b_pad: int, *,
               device: DeviceLike = None) -> MiniBatch:
        """One step's ``MiniBatch`` on ``device`` (``None`` means ``cuda``)."""
        dev = resolve_device(device)
        inp, seeds_p, mask = self.sample_host(csr, seeds, rng, b_pad)
        return MiniBatch(self.skeleton_blocks(b_pad, dev), torch.from_numpy(inp).to(dev),
                         torch.from_numpy(seeds_p).to(dev), torch.from_numpy(mask).to(dev))


class NodeDataLoader:
    """Shuffled seed batches with host sampling in a background thread.

    Counterpart of ``dgl.dataloading.NodeDataLoader`` (``ns-sage-dgl.py:
    134-141``): a shuffle an epoch, batches of ``batch_size`` seeds, the
    last one padded (or dropped with ``drop_last``), sampled ahead of the
    consumer by ``prefetch``. On a card the thread pins each batch's arrays
    and the consumer copies them with ``non_blocking=True``, so a training
    step waits on nothing the host does; the blocks are the sampler's
    cached skeletons on the card.
    """

    def __init__(
        self,
        csr: CSRGraph,
        nids,
        sampler: MultiLayerNeighborSampler,
        batch_size: int,
        *,
        seed: int = 0,
        drop_last: bool = False,
        device: DeviceLike = None,
    ):
        self.csr = csr
        self.nids = np.asarray(nids)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def __len__(self) -> int:
        n = len(self.nids)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _gen(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        idx = self.nids.copy()
        self.rng.shuffle(idx)
        stop = len(idx) - len(idx) % self.batch_size if self.drop_last else len(idx)
        for i in range(0, stop, self.batch_size):
            arrays = self.sampler.sample_host(self.csr, idx[i: i + self.batch_size], self.rng,
                                              self.batch_size)
            tensors = tuple(torch.from_numpy(a) for a in arrays)
            yield tuple(t.pin_memory() for t in tensors) if self.device.type == "cuda" else tensors

    def __iter__(self) -> Iterator[MiniBatch]:
        dev = self.device
        blocks = self.sampler.skeleton_blocks(self.batch_size, dev)  # built here, not in the thread
        for inp, seeds, mask in prefetch(self._gen(), _PREFETCH_DEPTH):
            yield MiniBatch(blocks, inp.to(dev, non_blocking=True),
                            seeds.to(dev, non_blocking=True), mask.to(dev, non_blocking=True))
