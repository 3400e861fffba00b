"""Neighbour-sampled training: one step is one mini-batch of seeds.

The step is ``dgl_tpu_torch.benchmarks.sampling.pipeline.make_train_step``
(P1's gather of ``x[input_nodes]``, the forward over the positional blocks,
masked cross-entropy on the seeds, backward, Adam), fed by
``DeviceNeighborSampler`` on the card: with-replacement samples of the
traffic's fan-outs over the configuration's graph, ``batch_size`` seeds a
step in an order drawn from ``--seed`` once an epoch, the last batch of an
epoch padded. The sampler's CSR is built by the port
(``graph/transforms.py``, ``CSRGraph.from_edges``). Spans: ``sample``
(the next batch, its samples drawn on the card) and ``train_step``.

The reference cannot draw the program's samples again without copying its
sampler, so it judges them instead (every sampled neighbour an in-neighbour
of its destination, a node with none sampling itself, the seeds in the
benchmark's order) and then follows the steps on the program's samples.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from gnnbench import data
from gnnbench.loops.full import half_mask
from gnnbench.reference import common

__all__ = ["SPANS", "Program", "reference"]

SPANS = ("sample", "train_step")


class Program:
    unit = "seed"

    def __init__(self, cell):
        t_imports = time.perf_counter()
        from dgl_tpu_torch.benchmarks.sampling.pipeline import make_train_step
        from dgl_tpu_torch.graph import transforms
        from dgl_tpu_torch.sampling import CSRGraph, DeviceNeighborSampler

        cfg, dev, gd, tr = cell.cfg, cell.device, cell.graph, cell.traffic
        g_cfg = cfg["graph"]
        if not tr["replace"]:
            raise ValueError("DeviceNeighborSampler samples with replacement only")
        self.device, self.b, self.fanouts = dev, tr["batch_size"], list(tr["fanouts"])
        t0 = time.perf_counter()
        self.setup_phases = {"imports": t0 - t_imports}
        src = torch.from_numpy(gd.src).to(dev, torch.int64)
        dst = torch.from_numpy(gd.dst).to(dev, torch.int64)
        if g_cfg["bidirect"]:
            src, dst = transforms.to_bidirected(src, dst, gd.num_nodes)
        if g_cfg["self_loops"]:
            src, dst = transforms.add_self_loops(src, dst, gd.num_nodes)
        csr = CSRGraph.from_edges(src, dst, gd.num_nodes, device=dev)
        self.num_edges = int(src.numel())
        del src, dst
        self.sampler = DeviceNeighborSampler(csr, self.fanouts, device=dev)
        del csr
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.graph_build_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        y = torch.from_numpy(gd.labels).to(dev, torch.int64)
        x = data.features(g_cfg["feat_dim"], gd.num_classes, y, cell.seed, g_cfg["noise"])
        mask = data.train_mask(gd.num_nodes, g_cfg["train_fraction"], cell.seed, dev)
        self.train_nid = torch.nonzero(mask).flatten().cpu().numpy().astype(np.int64)
        self.row_bytes = x.shape[1] * x.element_size()
        t2 = time.perf_counter()
        self.order_rng = np.random.default_rng(data.derive_seed(cell.seed, "order"))
        self.sample_gen = torch.Generator(device=dev).manual_seed(
            data.derive_seed(cell.seed, "sample"))
        self.model = cell.family.build(cfg, dev, data.weights(cell.family.reference.layout(cfg),
                                                               cell.seed, dev))
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg["optimizer"]["lr"],
                                    weight_decay=cfg["optimizer"]["weight_decay"])
        drop_gen = torch.Generator(device=dev).manual_seed(data.derive_seed(cell.seed, "dropout"))
        self.train_step = make_train_step(self.model, self.opt, x, y, drop_gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_phases.update(graph=self.graph_build_s, inputs=t2 - t1,
                                 model=time.perf_counter() - t2)
        self.first_order = None
        self.kept: List[torch.Tensor] = []  # input_nodes of the steps the reference follows
        self.keep_steps = 0
        self.last_loss, self.last_mb = None, None
        self.done = 0.0
        self._epoch()

    def _epoch(self) -> None:
        order = self.order_rng.permutation(self.train_nid)
        if self.first_order is None:
            self.first_order = order
        n_steps = -(-len(order) // self.b)
        self._seeds = [self.b] * (n_steps - 1) + [len(order) - (n_steps - 1) * self.b]
        self._at = 0
        self._it = self.sampler.batches(order, self.b, self.sample_gen)

    def step(self) -> None:
        with record_function("sample"):
            mb = next(self._it, None)
            if mb is None:
                self._epoch()
                mb = next(self._it)
        with record_function("train_step"):
            loss, _ = self.train_step(mb)
        if len(self.kept) < self.keep_steps:
            self.kept.append(mb.input_nodes.clone())
        self.last_loss, self.last_mb = loss, mb
        self.done += self._seeds[self._at]
        self._at += 1

    def stats(self) -> Dict[str, int]:
        return {"nodes": len(self.train_nid), "edges": self.num_edges, "batch": self.b,
                "row_bytes": self.row_bytes}

    def record(self) -> dict:
        return {"order": self.first_order,
                "input_nodes": [t.cpu() for t in self.kept]}


def reference(cell, record: dict, *, steps: int, tf32: bool = False,
              half_batch: bool = False, dtype: torch.dtype = torch.float64):
    cfg, dev, gd, tr = cell.cfg, cell.device, cell.graph, cell.traffic
    g_cfg = cfg["graph"]
    b, fanouts = tr["batch_size"], list(tr["fanouts"])
    g = common.build_graph(gd.src, gd.dst, gd.num_nodes, bidirect=g_cfg["bidirect"],
                           self_loops=g_cfg["self_loops"], device=dev)
    order = record["order"]
    seeds, masks = [], []
    for s in range(steps):
        chunk = order[s * b: (s + 1) * b]
        pad = np.zeros(b, np.int64)
        pad[: len(chunk)] = chunk
        m = torch.zeros(b, dtype=torch.bool, device=dev)
        m[: len(chunk)] = True
        seeds.append(torch.from_numpy(pad).to(dev))
        masks.append(half_mask(m) if half_batch else m)
    keys = common.edge_keys(g)
    inputs = [t.to(dev, torch.int64) for t in record["input_nodes"]]
    bad = sum(common.check_samples(g, keys, ids, s, fanouts) for ids, s in zip(inputs, seeds))
    del keys
    y = torch.from_numpy(gd.labels).to(dev, torch.int64)
    x = data.features(g_cfg["feat_dim"], gd.num_classes, y, cell.seed, g_cfg["noise"])
    del g
    sizes = list(zip(common.block_sizes(b, fanouts), fanouts))
    ref = cell.family.reference
    params = {k: v.to(dtype) for k, v in data.weights(ref.layout(cfg), cell.seed, dev).items()}
    x = x.to(dtype)
    replay = common.Replay(data.derive_seed(cell.seed, "dropout"), dev)

    def loss_fn(s, p):
        logits = ref.forward_blocks(p, sizes, x.index_select(0, inputs[s]), cfg, replay, tf32)
        return common.masked_ce(logits, y.index_select(0, seeds[s]), masks[s])

    opt = cfg["optimizer"]
    readings = common.follow_steps(params, loss_fn, steps, lr=opt["lr"],
                                   weight_decay=opt["weight_decay"])
    return readings, {"bad_samples": float(bad)}
