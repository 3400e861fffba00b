"""Headline benchmark of the port: full-graph GraphSAGE training on reddit.

The workload of the root ``bench.py``: 2-layer SAGE, mean aggregation,
hidden 16, masked cross-entropy and an Adam(1e-2) step over the whole graph
(232,965 nodes, 11.6M edges, 602-d features; the structurally matched
synthetic graph when the real dataset is absent). Reference: DGL 0.6.1 on
one V100, 0.3627 s/epoch.

The primary metric is the unhoisted epoch, the full per-epoch work. The
hoisted epoch, with layer 1's aggregation ``x_agg`` computed once by K1 at
the input width, is reported beside it. Every epoch ends in a device
synchronise (the reference protocol), and the reported value is the mean of
the timed epochs after the warmup.

    python -m dgl_tpu_torch.bench [--dataset reddit] [--epochs 15] [--warmup 3]
                                  [--hoisted-only | --unhoisted-only] [--device cuda]
                                  [--profile EPOCHS]

Prints one JSON line on stdout; the per-epoch times go to stderr.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional

import torch

from .benchmarks.common import masked_softmax_ce
from .data import load_node_dataset
from .device import DeviceLike, resolve_device
from .graph import from_edges
from .models import GraphSAGE
from .ops import gspmm
from .train.timing import EpochTimer, device_profile, synchronize

__all__ = ["BASELINE_S", "run", "main"]

BASELINE_S = 0.3627  # DGL 0.6.1 on one V100 (BASELINE.md)


def _train(g, x, y, mask, num_classes, x_agg, epochs, warmup, device, seed, profile_epochs):
    """Train a fresh model; returns its epoch times, losses and profile."""
    model = GraphSAGE(
        x.shape[1], 16, num_classes, num_layers=2, device=device,
        generator=torch.Generator().manual_seed(seed),
    )
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    drop_gen = torch.Generator(device=device).manual_seed(seed)
    model.train()

    def step():
        opt.zero_grad(set_to_none=True)
        loss = masked_softmax_ce(model(g, x, x_agg=x_agg, generator=drop_gen), y, mask)
        loss.backward()
        opt.step()
        return loss.detach()

    timer = EpochTimer(warmup, device=device)
    losses = []
    for _ in range(warmup + epochs):
        timer.start()
        losses.append(step())
        timer.stop()
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError(f"non-finite training loss: {losses}")
    res = {"epoch_s": timer.mean, "epochs_s": timer.durations, "losses": losses}
    if profile_epochs:
        res["profile"] = device_profile(step, profile_epochs, device)
    return res


def run(
    dataset: str = "reddit",
    epochs: int = 15,
    warmup: int = 3,
    device: DeviceLike = None,
    *,
    hoisted: bool = True,
    unhoisted: bool = True,
    seed: int = 0,
    profile_epochs: int = 0,
) -> dict:
    """Train the benchmark's GraphSAGE in each selected mode.

    Returns ``{"device", "synthetic", "setup_s", "unhoisted": {...},
    "hoisted": {...}, "precompute_s"}``; each mode holds ``epoch_s`` (mean
    of the timed epochs), ``epochs_s`` and the per-step ``losses``
    (warmup included), and with ``profile_epochs`` a ``profile`` of that
    many further epochs. Both modes start from the same weights and dropout
    seed.
    """
    dev = resolve_device(device)
    if not (hoisted or unhoisted):
        raise ValueError("nothing to run: both modes are off")
    data = load_node_dataset(dataset)
    t0 = time.perf_counter()
    g = from_edges(data.src, data.dst, data.num_nodes, device=dev)
    x = torch.from_numpy(data.features).to(dev)
    y = torch.from_numpy(data.labels).to(dev)
    mask = torch.from_numpy(data.train_mask).to(dev, torch.float32)
    synchronize(dev)
    out = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "synthetic": data.synthetic,
        "setup_s": time.perf_counter() - t0,
    }
    args = (g, x, y, mask, data.num_classes)
    if unhoisted:
        out["unhoisted"] = _train(*args, None, epochs, warmup, dev, seed, profile_epochs)
    if hoisted:
        t0 = time.perf_counter()
        x_agg = gspmm(g, "copy_u", "mean", x=x)
        synchronize(dev)
        out["precompute_s"] = time.perf_counter() - t0
        out["hoisted"] = _train(*args, x_agg, epochs, warmup, dev, seed, profile_epochs)
    return out


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", default="reddit")
    parser.add_argument("--epochs", type=int, default=15, help="timed epochs per mode")
    parser.add_argument("--warmup", type=int, default=3)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--hoisted-only", action="store_true")
    mode.add_argument("--unhoisted-only", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profile", type=int, default=0, metavar="EPOCHS",
                        help="profile this many further epochs per mode (stderr)")
    args = parser.parse_args(argv)

    res = run(args.dataset, args.epochs, args.warmup, args.device,
              hoisted=not args.unhoisted_only, unhoisted=not args.hoisted_only,
              profile_epochs=args.profile)
    primary = res.get("unhoisted", res.get("hoisted"))["epoch_s"]
    # the DGL-V100 baseline is reddit's; other datasets report no ratio
    ratio = (lambda s: BASELINE_S / s) if args.dataset == "reddit" else (lambda s: None)
    line = {
        "metric": f"{args.dataset}_sage_epoch_time",
        "value": primary,
        "unit": "s",
        "vs_baseline": ratio(primary),
    }
    if "hoisted" in res and "unhoisted" in res:
        line["hoisted_s"] = res["hoisted"]["epoch_s"]
        line["hoisted_vs_baseline"] = ratio(res["hoisted"]["epoch_s"])
    line.update(setup_s=res["setup_s"], backend="torch-cuda" if res["device"] != "cpu" else "torch-cpu",
                device=res["device"])
    print(json.dumps(line))
    for name in ("unhoisted", "hoisted"):
        if name in res:
            print(f"# {name}_epochs_s={res[name]['epochs_s']} "
                  f"final_loss={res[name]['losses'][-1]}", file=sys.stderr)
            if "profile" in res[name]:
                print(f"# {name}_profile={json.dumps(res[name]['profile'])}", file=sys.stderr)
    print(f"# synthetic_data={res['synthetic']} precompute_s={res.get('precompute_s')}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
