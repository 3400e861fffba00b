"""Dataset loading: canonical npz, then synthetic.

Node classification: ``<root>/<name>.npz`` (keys src, dst, x, y, train,
val, test, optional ef) → the structurally matched synthetic generator
(``synthetic.py``), which caches its arrays under ``root``. Graph
classification: ``<root>/<name>_graphs.npz`` (see
``_load_canonical_graphs_npz``) → the synthetic generator. The raw formats
the JAX package also parses (Planetoid, DGL reddit, OGB csv.gz, TU text)
are not read here. The data root is ``$DGL_TPU_DATA_DIR`` or
``<repo>/.data_cache``, shared with the JAX package so both read the same
files.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

from .synthetic import (
    GraphClassificationData,
    NodeClassificationData,
    synthetic_graph_classification,
    synthetic_node_classification,
)

__all__ = ["data_root", "load_node_dataset", "load_graph_dataset"]


def data_root() -> str:
    return os.environ.get(
        "DGL_TPU_DATA_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), ".data_cache"),
    )


def _load_canonical_npz(path: str, name: str) -> NodeClassificationData:
    z = np.load(path)
    return NodeClassificationData(
        name=name,
        src=z["src"],
        dst=z["dst"],
        num_nodes=int(z["x"].shape[0]),
        features=z["x"],
        labels=z["y"],
        train_mask=z["train"],
        val_mask=z["val"],
        test_mask=z["test"],
        num_classes=int(z["y"].max()) + 1 if z["y"].ndim == 1 else z["y"].shape[1],
        edge_feat=z["ef"] if "ef" in z.files else None,
        synthetic=False,
    )


def load_node_dataset(
    name: str, root: Optional[str] = None, seed: int = 0, scale: float = 1.0
) -> NodeClassificationData:
    """Load by search order: canonical npz → synthetic.

    ``scale`` (< 1) is honoured only by the synthetic fallback: real data is
    never subsampled silently. ``DGL_TPU_SYNTH_STRUCTURAL=1`` switches the
    fallback to the structure-required construction.
    """
    root = root or data_root()
    npz = os.path.join(root, f"{name}.npz")
    if os.path.exists(npz):
        return _load_canonical_npz(npz, name)
    return synthetic_node_classification(
        name, seed=seed, cache_dir=root, scale=scale,
        structure_required=bool(os.environ.get("DGL_TPU_SYNTH_STRUCTURAL")),
    )


def _load_canonical_graphs_npz(path: str, name: str) -> GraphClassificationData:
    """The JAX package's per-graph interchange npz: ``src``/``dst`` (sum_E,)
    graph-local ids, ``edge_offsets`` (G+1,), ``num_nodes`` (G,),
    ``node_feat`` (sum_N, F) with ``node_offsets`` (G+1,), optional
    ``edge_feat`` (sum_E, Fe), ``labels`` (G,), optional
    ``split_train``/``split_valid``/``split_test`` graph indices."""
    z = np.load(path)
    eo, no = z["edge_offsets"], z["node_offsets"]
    nn = z["num_nodes"]
    # each z[key] reads and decompresses the whole array: once per key
    src, dst, nf = z["src"], z["dst"], z["node_feat"]
    ef = z["edge_feat"] if "edge_feat" in z.files else None
    graphs, node_feats, edge_feats = [], [], []
    for i in range(len(nn)):
        graphs.append((src[eo[i]:eo[i + 1]].astype(np.int64),
                       dst[eo[i]:eo[i + 1]].astype(np.int64), int(nn[i])))
        node_feats.append(nf[no[i]:no[i + 1]])
        edge_feats.append(ef[eo[i]:eo[i + 1]] if ef is not None else None)
    labels = z["labels"].astype(np.int64)
    splits = None
    if "split_train" in z.files:
        splits = {k: z[f"split_{k}"].astype(np.int64) for k in ("train", "valid", "test")}
    return GraphClassificationData(
        name, graphs, node_feats, edge_feats, labels,
        int(labels.max()) + 1, synthetic=False, splits=splits,
    )


def load_graph_dataset(
    name: str, root: Optional[str] = None, seed: int = 0, num_graphs: Optional[int] = None,
) -> GraphClassificationData:
    """ENZYMES, ogbg-molhiv or ogbg-ppa by search order: canonical npz →
    synthetic. ``num_graphs`` caps the dataset; real data is cut (with a
    notice on stderr) only when a cap is asked for."""
    root = root or data_root()
    npz = os.path.join(root, f"{name}_graphs.npz")
    if not os.path.exists(npz):
        return synthetic_graph_classification(name, seed=seed, num_graphs=num_graphs)
    data = _load_canonical_graphs_npz(npz, name)
    if num_graphs is not None and num_graphs < len(data.graphs):
        print(f"[dgl_tpu_torch.data] {name}: capping {len(data.graphs)} -> "
              f"{num_graphs} graphs (--num-graphs)", file=sys.stderr)
        splits = None
        if data.splits is not None:
            splits = {k: v[v < num_graphs] for k, v in data.splits.items()}
        data = GraphClassificationData(
            name, data.graphs[:num_graphs], data.node_feats[:num_graphs],
            data.edge_feats[:num_graphs], data.labels[:num_graphs], data.num_classes,
            synthetic=False, splits=splits,
        )
    return data
