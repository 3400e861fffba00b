"""Neighbour-sampled minibatch GAT on one card.

Counterpart of ``benchmarks/sampling/ns_gat.py`` (the reference's
``sampling/node-classification/reddit/ns-gat-dgl.py``): the pipeline of
``ns_sage`` (``pipeline.py``) with a GAT of heads ``(H,) * (L - 1) + (1,)``
(``--num-heads 8``), hidden 16, feature and attention dropout 0.5, the
hidden layers' heads concatenated and the last layer's averaged. Sampled
steps take GATConv's positional block form (no K3). The model is built
fused, so the full-graph evaluation runs K3 forward (reddit: H = 8,
D = 16, then H = 1, D = 41); the edge form would need a 5.9 GB (E, 8, 16)
message there.

    python -m dgl_tpu_torch.benchmarks.sampling.ns_gat [--dataset reddit]
        [--num-epochs N] [--num-heads 8] [--host-sampler] [--no-replace]
        [--device cuda] [--scale S] [--profile STEPS]
"""

from __future__ import annotations

from typing import Optional

import torch

from ...models import GAT
from .pipeline import parser, run

__all__ = ["main"]


def _model(args, in_feats: int, classes: int, dev: torch.device) -> GAT:
    heads = (args.num_heads,) * (args.num_layers - 1) + (1,)
    return GAT(in_feats, args.num_hidden, classes, heads, feat_drop=args.dropout,
               attn_drop=args.dropout, fused=True, device=dev,
               generator=torch.Generator().manual_seed(args.seed))


def main(argv: Optional[list] = None) -> dict:
    p = parser("Neighbour-sampling GAT (dgl_tpu_torch)")
    p.add_argument("--num-heads", type=int, default=8)
    args = p.parse_args(argv)
    return run(args, lambda in_feats, classes, dev: _model(args, in_feats, classes, dev))


if __name__ == "__main__":
    main()
