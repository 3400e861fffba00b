"""Neighbour-sampled minibatch GraphSAGE on one card.

Counterpart of ``benchmarks/sampling/ns_sage.py`` (the reference's
``sampling/node-classification/reddit/ns-sage-dgl.py``): fanouts ``10,25``,
batch 1000, hidden 16, lr 3e-3, dropout 0.5 on the last layer's input,
mean aggregation; the pipeline, its lines and its flags are
``pipeline.py``'s. ``--inductive`` samples and trains on the subgraph of
the training nodes (``ns-sage-dgl.py:225-228``). The evaluation is a
full-graph forward: K1 at the hidden width in both layers (layer 1
projects 602 → 16 first, layer 2 aggregates its 16-wide input).

    python -m dgl_tpu_torch.benchmarks.sampling.ns_sage [--dataset reddit]
        [--num-epochs N] [--fan-out 10,25] [--batch-size 1000] [--inductive]
        [--host-sampler] [--no-replace] [--device cuda] [--scale S] [--profile STEPS]
"""

from __future__ import annotations

from typing import Optional

import torch

from ...models import GraphSAGE
from .pipeline import parser, run

__all__ = ["main"]


def _model(args, in_feats: int, classes: int, dev: torch.device) -> GraphSAGE:
    return GraphSAGE(in_feats, args.num_hidden, classes, num_layers=args.num_layers,
                     dropout=args.dropout, device=dev,
                     generator=torch.Generator().manual_seed(args.seed))


def main(argv: Optional[list] = None) -> dict:
    p = parser("Neighbour-sampling SAGE (dgl_tpu_torch)")
    p.add_argument("--inductive", action="store_true",
                   help="inductive split: sample and train only on the train-node subgraph")
    args = p.parse_args(argv)
    return run(args, lambda in_feats, classes, dev: _model(args, in_feats, classes, dev))


if __name__ == "__main__":
    main()
