"""Full-graph training: one step is one epoch.

The step is the one ``main_sage`` and ``main_gat`` run, built from the
port's public modules: the forward over the whole graph with dropout from
the benchmark's generator, masked cross-entropy on the train mask
(``benchmarks/common.py:masked_softmax_ce``), backward, and
``torch.optim.Adam`` with the configuration's coupled weight decay. The
graph is built by the port (``graph/transforms.py``, ``graph/graph.py:
from_edges`` with its row splits) from the benchmark's raw edges. Spans:
``forward``, ``loss``, ``backward``, ``optimizer``.
"""

from __future__ import annotations

import time
from typing import Dict

import torch
from torch.profiler import record_function

from gnnbench import data
from gnnbench.reference import common

__all__ = ["SPANS", "Program", "reference"]

SPANS = ("forward", "loss", "backward", "optimizer")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    unit = "epoch"

    def __init__(self, cell):
        t_imports = time.perf_counter()
        from dgl_tpu_torch.benchmarks import common as port_common
        from dgl_tpu_torch.graph import from_edges, transforms

        cfg, dev, gd = cell.cfg, cell.device, cell.graph
        g_cfg = cfg["graph"]
        self.device, self._common = dev, port_common
        t0 = time.perf_counter()
        self.setup_phases = {"imports": t0 - t_imports}
        src = torch.from_numpy(gd.src).to(dev, torch.int64)
        dst = torch.from_numpy(gd.dst).to(dev, torch.int64)
        if g_cfg["bidirect"]:
            src, dst = transforms.to_bidirected(src, dst, gd.num_nodes)
        if g_cfg["self_loops"]:
            src, dst = transforms.add_self_loops(src, dst, gd.num_nodes)
        self.g = from_edges(src, dst, gd.num_nodes, device=dev)
        del src, dst
        _sync(dev)
        self.graph_build_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        self.y = torch.from_numpy(gd.labels).to(dev, torch.int64)
        self.x = data.features(g_cfg["feat_dim"], gd.num_classes, self.y, cell.seed,
                               g_cfg["noise"])
        self.mask = data.train_mask(gd.num_nodes, g_cfg["train_fraction"], cell.seed, dev)
        _sync(dev)
        t2 = time.perf_counter()
        self.model = cell.family.build(cfg, dev, data.weights(cell.family.reference.layout(cfg),
                                                               cell.seed, dev))
        opt = cfg["optimizer"]
        self.opt = torch.optim.Adam(self.model.parameters(), lr=opt["lr"],
                                    weight_decay=opt["weight_decay"])
        self.drop_gen = torch.Generator(device=dev).manual_seed(data.derive_seed(cell.seed,
                                                                                 "dropout"))
        _sync(dev)
        self.setup_phases.update(graph=self.graph_build_s, inputs=t2 - t1,
                                 model=time.perf_counter() - t2)
        self.last_loss = None
        self.done = 0.0

    def step(self) -> None:
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        with record_function("forward"):
            logits = self.model(self.g, self.x, generator=self.drop_gen)
        with record_function("loss"):
            loss = self._common.masked_softmax_ce(logits, self.y, self.mask)
        with record_function("backward"):
            loss.backward()
        with record_function("optimizer"):
            self.opt.step()
        self.last_loss = loss.detach()
        self.done += 1.0

    def stats(self) -> Dict[str, int]:
        return {"nodes": self.g.num_dst_nodes, "edges": self.g.num_edges}

    def record(self) -> dict:
        return {}


def half_mask(mask: torch.Tensor) -> torch.Tensor:
    """``mask`` with every second set entry cleared: the fault of a step
    that leaves half of its batch out."""
    idx = torch.nonzero(mask).flatten()
    out = torch.zeros_like(mask)
    out[idx[::2]] = True
    return out


def reference(cell, record: dict, *, steps: int, tf32: bool = False,
              half_batch: bool = False, dtype: torch.dtype = torch.float64):
    """The configuration's model followed over the program's first
    ``steps`` steps, from the same inputs, weights and dropout stream."""
    cfg, dev, gd = cell.cfg, cell.device, cell.graph
    g_cfg = cfg["graph"]
    g = common.build_graph(gd.src, gd.dst, gd.num_nodes, bidirect=g_cfg["bidirect"],
                           self_loops=g_cfg["self_loops"], device=dev)
    y = torch.from_numpy(gd.labels).to(dev, torch.int64)
    x = data.features(g_cfg["feat_dim"], gd.num_classes, y, cell.seed, g_cfg["noise"])
    mask = data.train_mask(gd.num_nodes, g_cfg["train_fraction"], cell.seed, dev)
    if half_batch:
        mask = half_mask(mask)
    ref = cell.family.reference
    params = {k: v.to(dtype) for k, v in data.weights(ref.layout(cfg), cell.seed, dev).items()}
    x = x.to(dtype)
    replay = common.Replay(data.derive_seed(cell.seed, "dropout"), dev)

    def loss_fn(_, p):
        return common.masked_ce(ref.forward_full(p, g, x, cfg, replay, tf32), y, mask)

    opt = cfg["optimizer"]
    readings = common.follow_steps(params, loss_fn, steps, lr=opt["lr"],
                                   weight_decay=opt["weight_decay"])
    return readings, {}
