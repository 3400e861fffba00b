"""Convert public dataset files into the canonical npz formats the loaders read first.

Counterpart of ``tools/convert_dataset.py``, inside the package. The
drivers search ``$DGL_TPU_DATA_DIR`` (default ``<repo>/.data_cache``) in
this order (``dgl_tpu_torch/data/loaders.py``):

  1. canonical npz: ``<name>.npz`` (node tasks) / ``<name>_graphs.npz``
     (graph tasks), the interchange format this tool writes, the same as
     the JAX package's, so either package reads the other's;
  2. the public raw formats: Planetoid pickles, DGL reddit npz, OGB csv.gz,
     TU text files (and MovieLens ``u.*`` files, ``data/movielens.py``);
  3. the synthetic fallback.

Raw files go under the data root:

  cora/pubmed:  <root>/<name>/ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}
  reddit:       <root>/reddit/reddit_{data,graph}.npz
  ogbn-*:       <root>/ogbn_<ds>/{raw/*.csv.gz, split/...}   (the ogb zip layout)
  ENZYMES:      <root>/ENZYMES/ENZYMES_{A,graph_indicator,graph_labels,node_attributes}.txt
  ogbg-*:       <root>/ogbg_<ds>/{raw/*.csv.gz, split/...}
  ml-100k:      <root>/ml-100k/u.{data,user,item}

The drivers parse them directly; this tool caches them as canonical npz
(a faster start for the csv.gz formats):

  python -m dgl_tpu_torch.tools.convert_dataset node ogbn-arxiv
  python -m dgl_tpu_torch.tools.convert_dataset graph ogbg-molhiv

``--via ogb`` / ``--via dgl`` export through the reference's own loaders
instead (every dataset, ogbn-proteins' species split and 8-column edge
features included); they import the ``ogb`` or ``dgl`` package, which this
repository does not depend on, only when asked for. Each write is read
back through the loader the drivers use and printed with its shapes.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from ..data.loaders import data_root, load_graph_dataset, load_node_dataset

NODE_DATASETS = ("cora", "pubmed", "reddit", "ogbn-arxiv", "ogbn-products",
                 "ogbn-proteins")
GRAPH_DATASETS = ("ENZYMES", "ogbg-molhiv", "ogbg-ppa")


def _save_node_npz(path, src, dst, x, y, train, val, test, ef=None):
    payload = dict(src=src.astype(np.int64), dst=dst.astype(np.int64),
                   x=x, y=y, train=train, val=val, test=test)
    if ef is not None:
        payload["ef"] = ef
    np.savez_compressed(path, **payload)


def _node_via_ogb(name, root):
    from ogb.nodeproppred import NodePropPredDataset  # noqa: deferred dep

    ds = NodePropPredDataset(name, root=os.path.join(root, "_ogb_download"))
    g, y = ds[0]
    split = ds.get_idx_split()
    n = g["num_nodes"]
    masks = {}
    for part in ("train", "valid", "test"):
        m = np.zeros(n, bool)
        m[split[part]] = True
        masks[part] = m
    y = np.asarray(y)
    y = y[:, 0] if (y.ndim == 2 and y.shape[1] == 1) else y  # multilabel kept 2D
    x = g["node_feat"]
    ef = g.get("edge_feat")
    if x is None:  # ogbn-proteins: features live on edges
        x = np.ones((n, 1), np.float32)
    _save_node_npz(os.path.join(root, f"{name}.npz"),
                   g["edge_index"][0], g["edge_index"][1],
                   x, y, masks["train"], masks["valid"], masks["test"], ef)


def _node_via_dgl(name, root):
    import dgl  # noqa: deferred dep
    import dgl.data as dgldata

    ds = {"cora": dgldata.CoraGraphDataset,
          "pubmed": dgldata.PubmedGraphDataset,
          "reddit": dgldata.RedditDataset}[name]()
    g = ds[0]
    src, dst = (t.numpy() for t in g.edges())
    nd = g.ndata
    _save_node_npz(
        os.path.join(root, f"{name}.npz"), src, dst,
        nd["feat"].numpy(), nd["label"].numpy().astype(np.int64),
        nd["train_mask"].numpy().astype(bool),
        nd["val_mask"].numpy().astype(bool),
        nd["test_mask"].numpy().astype(bool),
    )


def _graph_via_ogb(name, root):
    from ogb.graphproppred import GraphPropPredDataset  # noqa: deferred dep

    ds = GraphPropPredDataset(name, root=os.path.join(root, "_ogb_download"))
    split = ds.get_idx_split()
    graphs = [g for g, _ in ds]
    labels = np.asarray([int(y[0] if np.ndim(y) else y) for _, y in ds])
    _save_graphs_npz(os.path.join(root, f"{name}_graphs.npz"), name, [
        (g["edge_index"][0], g["edge_index"][1], g["num_nodes"],
         g["node_feat"], g.get("edge_feat"))
        for g in graphs
    ], labels, {k: np.asarray(v) for k, v in
                (("train", split["train"]), ("valid", split["valid"]),
                 ("test", split["test"]))})


def _save_graphs_npz(path, name, graphs, labels, splits=None):
    """graphs: list of (src, dst, num_nodes, node_feat, edge_feat|None)."""
    srcs, dsts, nns, nfs, efs = [], [], [], [], []
    for s, d, n, nf, ef in graphs:
        srcs.append(np.asarray(s)); dsts.append(np.asarray(d))
        nns.append(n); nfs.append(np.asarray(nf))
        efs.append(None if ef is None else np.asarray(ef))
    edge_counts = np.asarray([len(s) for s in srcs], np.int64)
    node_counts = np.asarray(nns, np.int64)
    payload = dict(
        src=np.concatenate(srcs), dst=np.concatenate(dsts),
        edge_offsets=np.concatenate([[0], np.cumsum(edge_counts)]),
        num_nodes=node_counts,
        node_offsets=np.concatenate([[0], np.cumsum(node_counts)]),
        node_feat=np.concatenate(nfs),
        labels=np.asarray(labels, np.int64),
    )
    if efs[0] is not None:
        payload["edge_feat"] = np.concatenate(efs)
    if splits:
        for k, v in splits.items():
            payload[f"split_{k}"] = np.asarray(v, np.int64)
    np.savez_compressed(path, **payload)


def _cache_from_loader(kind, name, root):
    """Parse on-disk raw format via our own loaders, re-save as canonical."""
    if kind == "node":
        d = load_node_dataset(name, root=root)
        if d.synthetic:
            raise FileNotFoundError(
                f"no raw {name} artifacts under {root} (see module docstring "
                "for the expected layout)")
        _save_node_npz(os.path.join(root, f"{name}.npz"), d.src, d.dst,
                       d.features, d.labels, d.train_mask, d.val_mask,
                       d.test_mask, d.edge_feat)
    else:
        d = load_graph_dataset(name, root=root)
        if d.synthetic:
            raise FileNotFoundError(
                f"no raw {name} artifacts under {root} (see module docstring "
                "for the expected layout)")
        _save_graphs_npz(
            os.path.join(root, f"{name}_graphs.npz"), name,
            [(s, dd, n, nf, ef) for (s, dd, n), nf, ef in
             zip(d.graphs, d.node_feats, d.edge_feats)],
            d.labels, d.splits)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kind", choices=("node", "graph"))
    ap.add_argument("name", help=f"node: {NODE_DATASETS}; graph: {GRAPH_DATASETS}")
    ap.add_argument("--root", default=None,
                    help="data root (default $DGL_TPU_DATA_DIR or .data_cache)")
    ap.add_argument("--via", choices=("raw", "ogb", "dgl"), default="raw",
                    help="source: 'raw' = parse the on-disk public formats with "
                         "the package's loaders; 'ogb'/'dgl' = export through "
                         "those pip packages, which must be installed: this "
                         "repository does not depend on them")
    args = ap.parse_args(argv)
    root = args.root or data_root()
    os.makedirs(root, exist_ok=True)

    if args.via == "ogb":
        (_node_via_ogb if args.kind == "node" else _graph_via_ogb)(args.name, root)
    elif args.via == "dgl":
        if args.kind != "node":
            raise SystemExit("--via dgl supports node datasets (cora/pubmed/reddit)")
        _node_via_dgl(args.name, root)
    else:
        _cache_from_loader(args.kind, args.name, root)

    # verify: re-read through the exact loader the drivers use
    if args.kind == "node":
        d = load_node_dataset(args.name, root=root)
        assert not d.synthetic, "canonical npz did not round-trip"
        print(f"OK {args.name}: N={d.num_nodes} E={len(d.src)} "
              f"feat={d.features.shape} classes={d.num_classes} "
              f"train/val/test={int(d.train_mask.sum())}/"
              f"{int(d.val_mask.sum())}/{int(d.test_mask.sum())}")
    else:
        d = load_graph_dataset(args.name, root=root)
        assert not d.synthetic, "canonical npz did not round-trip"
        print(f"OK {args.name}: G={len(d.graphs)} classes={d.num_classes} "
              f"splits={'ogb' if d.splits else 'random-80/10/10'}")


if __name__ == "__main__":
    main()
