"""The neighbour-sampled training loop that ``ns_sage`` and ``ns_gat`` share.

Counterpart of the pipeline of ``benchmarks/sampling/ns_sage.py`` and
``ns_gat.py`` (the reference's ``ns-sage-dgl.py`` and ``ns-gat-dgl.py``):
the same CLI, defaults and stdout. Each step:

* a minibatch of ``--batch-size`` training seeds, sampled on the card
  (``DeviceNeighborSampler``, the default) or on the host in a prefetch
  thread (``--host-sampler``; ``--no-replace`` samples distinct neighbours
  and implies it), whose blocks are the cached positional skeletons;
* the feature gather ``x[input_nodes]`` by P1 in index order
  (``kernels/row_gather.py:row_gather_async``, one launch): the indices are
  new every step, so the source order's plan would be paid every step;
* ``y[seeds]``, the forward over the blocks (positional, no K1, K2 or K3),
  masked cross-entropy on the seed mask, backward and Adam; the train
  accuracy comes from the training forward's logits.

Only the logging step (every ``--log-every``) reads from the card during an
epoch; every epoch ends in a device synchronise. Every ``--eval-every``
epochs (not the first) the evaluation is one full-graph forward of the
model (layer-wise inference: K1 or K3 over the whole graph), whose logits
give both the ``Eval Acc`` and the ``Test Acc`` line. ``Avg epoch time`` is
the mean of the epochs from the sixth on. ``--profile STEPS`` runs that
many further steps under ``torch.profiler``.

Not ported: ``--scan-steps``, a workaround for the TPU's host link, raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable

import numpy as np
import torch

from ...data import load_node_dataset
from ...device import resolve_device
from ...graph import from_edges
from ...kernels.row_gather import row_gather_async
from ...sampling import CSRGraph, DeviceNeighborSampler, MultiLayerNeighborSampler, NodeDataLoader
from ...train.timing import device_profile, synchronize
from ..common import masked_accuracy, masked_softmax_ce, print_data_stats

__all__ = ["parser", "make_train_step", "run"]

WARMUP_EPOCHS = 5  # epochs left out of "Avg epoch time" (ns-sage-dgl.py:181-182)


def parser(description: str) -> argparse.ArgumentParser:
    """The JAX drivers' shared flags, with ``--device`` and ``--profile``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--gpu", type=int, default=0, help="kept for the reference's CLI; "
                   "--device picks the card")
    p.add_argument("--dataset", type=str, default="reddit",
                   choices=["reddit", "ogbn-products", "ogbn-arxiv", "cora", "pubmed"])
    p.add_argument("--num-epochs", type=int, default=20)
    p.add_argument("--num-hidden", type=int, default=16)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--fan-out", type=str, default="10,25")
    p.add_argument("--batch-size", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--lr", type=float, default=0.003)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, default=1.0,
                   help="shrink factor for the synthetic data (rehearsals)")
    p.add_argument("--host-sampler", action="store_true",
                   help="sample on host threads instead of on the card")
    p.add_argument("--no-replace", action="store_true",
                   help="without-replacement neighbour sampling (distinct neighbours per "
                        "seed, DGL's default); implies --host-sampler")
    p.add_argument("--scan-steps", action="store_true",
                   help="not ported: a workaround for the TPU's host link")
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile", type=int, default=0, metavar="STEPS",
                   help="profile this many further steps after training (stderr)")
    return p


def make_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer, x: torch.Tensor,
                    y: torch.Tensor, generator: torch.Generator) -> Callable:
    """``step(minibatch) -> (loss, train accuracy)``, both left on the
    device: the feature gather by P1 in index order, ``y[seeds]``, the
    forward over the blocks with dropout masks from ``generator``, masked
    cross-entropy, backward and an optimiser step."""
    def step(mb):
        model.train()
        opt.zero_grad(set_to_none=True)
        batch_x = row_gather_async(x, mb.input_nodes)
        batch_y = y.index_select(0, mb.seeds)
        logits = model(mb.blocks, batch_x, generator=generator)
        loss = masked_softmax_ce(logits, batch_y, mb.seed_mask)
        loss.backward()
        opt.step()
        return loss.detach(), masked_accuracy(logits.detach(), batch_y, mb.seed_mask)
    return step


def run(args: argparse.Namespace,
        make_model: Callable[[int, int, torch.device], torch.nn.Module]) -> dict:
    """Train ``make_model(in_feats, num_classes, device)`` as the reference's
    NS driver does, printing its lines.

    Returns ``{"device", "synthetic", "load_s", "setup_s", "steps",
    "steps_per_epoch", "eval_epochs", "epochs_s", "avg_epoch_s",
    "samples_per_s", "losses", "eval_acc", "test_acc", "profile",
    "setup_bytes", "train_peak_bytes"}``: ``losses`` every step's loss,
    ``samples_per_s`` the mean of the per-step rates after the first three
    (the logged figure); on a card ``setup_bytes`` is the device memory
    the graph, the data and the samplers hold when training starts and
    ``train_peak_bytes`` the peak from there to the end (None on the CPU).
    """
    if args.scan_steps:
        raise NotImplementedError("--scan-steps runs each epoch as one dispatch to hide the TPU's "
                                  "host link; it is a TPU workaround and is not ported")
    if args.no_replace:
        args.host_sampler = True
    print(args)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    data = load_node_dataset(args.dataset, seed=args.seed, scale=args.scale)
    load_s = time.perf_counter() - t0
    print_data_stats(data)
    fanouts = [int(f) for f in args.fan_out.split(",")]
    if len(fanouts) != args.num_layers:
        raise ValueError("--fan-out length must equal --num-layers")
    n = data.num_nodes
    train_nid = np.flatnonzero(data.train_mask)

    t0 = time.perf_counter()
    src_tr, dst_tr = data.src, data.dst
    if getattr(args, "inductive", False):
        # the train-time graph keeps only edges between training nodes, ids
        # global so features and labels index unchanged
        keep = np.zeros(n, bool)
        keep[train_nid] = True
        m = keep[data.src] & keep[data.dst]
        src_tr, dst_tr = data.src[m], data.dst[m]
    csr = CSRGraph.from_edges(src_tr, dst_tr, n, device=dev)
    g_full = from_edges(data.src, data.dst, n, device=dev)
    x = torch.from_numpy(np.asarray(data.features, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(data.labels)).to(dev)
    masks = {k: torch.from_numpy(np.asarray(getattr(data, f"{k}_mask"))).to(dev)
             for k in ("val", "test")}
    b = args.batch_size
    if args.host_sampler:
        loader = NodeDataLoader(csr, train_nid,
                                MultiLayerNeighborSampler(fanouts, replace=not args.no_replace),
                                b, seed=args.seed, device=dev)
        batches = loader.__iter__
    else:
        dsampler = DeviceNeighborSampler(csr, fanouts, device=dev)
        loader_rng = np.random.default_rng(args.seed)
        sample_gen = torch.Generator(device=dev).manual_seed(args.seed + 17)

        def batches():
            return dsampler.batches(loader_rng.permutation(train_nid), b, sample_gen)
    synchronize(dev)
    setup_s = time.perf_counter() - t0
    setup_bytes = None
    if dev.type == "cuda":  # the training's own peak, without the graph build's
        setup_bytes = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    model = make_model(x.shape[1], data.num_classes, dev)
    train_step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=args.lr), x, y,
                                 torch.Generator(device=dev).manual_seed(args.seed))

    def evaluate():
        model.eval()
        with torch.no_grad():
            logits = model(g_full, x)
        return [float(masked_accuracy(logits, y, masks[k])) for k in ("val", "test")]

    def mem_mb():
        return torch.cuda.memory_allocated(dev) / 1e6 if dev.type == "cuda" else 0.0

    losses, iter_tput, epochs_s, eval_epochs, accs = [], [], [], [], []
    steps_per_epoch = 0
    for epoch in range(args.num_epochs):
        tic = tic_step = time.perf_counter()
        step = -1
        for step, mb in enumerate(batches()):
            loss, acc = train_step(mb)
            losses.append(loss)
            iter_tput.append(b / (time.perf_counter() - tic_step))
            if step % args.log_every == 0:  # the only read from the card in an epoch
                print("Epoch {:05d} | Step {:05d} | Loss {:.4f} | Train Acc {:.4f} | "
                      "Speed (samples/sec) {:.4f} | GPU {:.1f} MiB".format(
                          epoch, step, float(loss), float(acc),
                          float(np.mean(iter_tput[3:])) if len(iter_tput) > 3 else 0.0, mem_mb()))
            tic_step = time.perf_counter()
        steps_per_epoch = step + 1
        synchronize(dev)
        epochs_s.append(time.perf_counter() - tic)
        print("Epoch Time(s): {:.4f}".format(epochs_s[-1]))
        if epoch % args.eval_every == 0 and epoch != 0:
            eval_epochs.append(epoch)
            accs.append(evaluate())
            print("Eval Acc {:.4f}".format(accs[-1][0]))
            print("Test Acc: {:.4f}".format(accs[-1][1]))
    avg = None
    if args.num_epochs > WARMUP_EPOCHS:
        avg = float(np.mean(epochs_s[WARMUP_EPOCHS:]))
        print("Avg epoch time: {}".format(avg))
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError(f"non-finite training loss: {losses}")
    profile = None
    if args.profile:
        def epochs():
            while True:
                yield from batches()

        stream = epochs()
        try:
            profile = device_profile(lambda: train_step(next(stream)), args.profile, dev,
                                     unit="step")
        finally:
            stream.close()  # stops the host loader's prefetch thread
        print(f"# profile={json.dumps(profile)}", file=sys.stderr)
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "synthetic": data.synthetic,
        "load_s": load_s,
        "setup_s": setup_s,
        "steps": len(losses),
        "steps_per_epoch": steps_per_epoch,
        "eval_epochs": eval_epochs,
        "epochs_s": epochs_s,
        "avg_epoch_s": avg,
        "samples_per_s": float(np.mean(iter_tput[3:])) if len(iter_tput) > 3 else None,
        "losses": losses,
        "eval_acc": [a[0] for a in accs],
        "test_acc": [a[1] for a in accs],
        "profile": profile,
        "setup_bytes": setup_bytes,
        "train_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }
