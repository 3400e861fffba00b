"""Neighbour sampling on the card.

Counterpart of ``dgl_tpu/sampling/device.py``: the in-edge CSR (int32)
lives on the device and each step maps its seeds to ``input_nodes`` with
the host sampler's rule, innermost layer first. Slot ``j`` of node ``v``
draws ``u`` uniform in [0, 1) and takes ``indices[indptr[v] + off]`` with
``off = min(floor(u·deg), max(deg - 1, 0))``, so every in-neighbour is
equally likely; a node with no in-edge samples itself. The blocks are the
host sampler's cached skeletons, so a step copies nothing from the host.

Plain PyTorch, as the JAX module is plain ``jnp``: the draws come from an
explicit ``torch.Generator`` on the sampler's device, the gathers are
``index_select``, and nothing reads back to the host (no ``.item()``, no
shape that depends on the data). It matches the native sampler in
distribution, not bit for bit.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np
import torch

from .. import trace
from ..device import DeviceLike, resolve_device
from ..graph.graph import Graph
from .neighbor import CSRGraph, MiniBatch, MultiLayerNeighborSampler

__all__ = ["DeviceNeighborSampler"]


class DeviceNeighborSampler:
    """With-replacement sampling on ``device`` (``None`` means ``cuda``);
    ``fanouts`` outermost first, as ``MultiLayerNeighborSampler``'s."""

    def __init__(self, csr: CSRGraph, fanouts: Sequence[int], *, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._host = MultiLayerNeighborSampler(fanouts)
        self.fanouts = tuple(self._host.fanouts)
        if len(csr.indices) >= np.iinfo(np.int32).max:
            raise ValueError(f"{len(csr.indices)} edges do not fit int32 offsets")
        self.indptr = torch.from_numpy(csr.indptr.astype(np.int32)).to(self.device)
        # one slot past the end: a node with no in-edge (offset 0 at
        # indptr[v] = E) gathers inside the array, and its draw is replaced
        self.indices = torch.from_numpy(
            np.append(csr.indices, 0).astype(np.int32)).to(self.device)

    def input_nodes(self, seeds: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """(b_pad,) seeds on the device → (num_src_nodes of the outermost
        block,) int32 ids: the seeds, then each layer's samples."""
        cur = seeds.to(torch.int32)
        for fanout in reversed(self.fanouts):
            start = self.indptr.index_select(0, cur)
            deg = (self.indptr.index_select(0, cur + 1) - start).unsqueeze(1)
            u = torch.rand((cur.shape[0], fanout), generator=generator, device=self.device)
            off = torch.minimum((u * deg).to(torch.int32), (deg - 1).clamp(min=0))
            nbr = self.indices.index_select(0, (start.unsqueeze(1) + off).flatten())
            nbr = torch.where(deg > 0, nbr.view(-1, fanout), cur.unsqueeze(1))
            cur = torch.cat([cur, nbr.flatten()])
        return cur

    def skeleton_blocks(self, b_pad: int) -> List[Graph]:
        return self._host.skeleton_blocks(b_pad, self.device)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def batches(self, nids, b_pad: int, generator: torch.Generator) -> Iterator[MiniBatch]:
        """The minibatches of ``nids`` in the given order, ``b_pad`` seeds a
        step, the last padded with node 0 and mask False. The padded seeds
        and masks go to the device in one copy; each step then samples
        there."""
        nids = np.asarray(nids)
        n_steps = -(-len(nids) // b_pad)
        seeds = np.zeros(n_steps * b_pad, dtype=np.int32)
        seeds[:len(nids)] = nids
        mask = np.zeros(n_steps * b_pad, dtype=bool)
        mask[:len(nids)] = True
        seeds_d = self._upload(seeds.reshape(n_steps, b_pad))
        mask_d = self._upload(mask.reshape(n_steps, b_pad))
        blocks = self.skeleton_blocks(b_pad)
        for s in range(n_steps):
            with trace.span("dgl_tpu_torch.DeviceNeighborSampler.draw"):
                input_nodes = self.input_nodes(seeds_d[s], generator)
            yield MiniBatch(blocks, input_nodes, seeds_d[s], mask_d[s])
