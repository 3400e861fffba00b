"""Synthetic datasets with reference-matched statistics.

A numpy-only copy of ``dgl_tpu/data/synthetic.py``: for the same ``(name,
seed, homophily, noise, scale, structure_required)`` (node classification)
or ``(name, seed, num_graphs)`` (graph classification) it returns
bit-identical arrays, so the port and the JAX package train on the same
data. No dataset can be downloaded here, so the benchmark runs on graphs
generated to match each dataset's structural statistics (node count, edge
count, feature width, class count, power-law degree skew), with a planted
learnable signal (homophilous edges and class-informative features).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "NodeClassificationData",
    "GraphClassificationData",
    "synthetic_node_classification",
    "synthetic_graph_classification",
    "NODE_DATASET_STATS",
    "GRAPH_DATASET_STATS",
]

# name: (num_nodes, num_edges, feat_dim, num_classes)
NODE_DATASET_STATS: Dict[str, Tuple[int, int, int, int]] = {
    "cora": (2_708, 10_556, 1_433, 7),  # bidirected 5429*2 - dups
    "pubmed": (19_717, 88_651, 500, 3),
    "reddit": (232_965, 11_606_919, 602, 41),
    "ogbn-arxiv": (169_343, 1_166_243, 128, 40),
    "ogbn-products": (2_449_029, 61_859_140, 100, 47),
    # ogbn-proteins: 8 edge-feature relations, 112 binary tasks
    "ogbn-proteins": (132_534, 39_561_252, 8, 112),
}

# Fine community layer for the big graphs: the real datasets have small
# dense communities (co-purchase clusters, citation neighbourhoods), which
# flat class-level homophily alone does not produce.
# name: (community_size, fraction of edges within the community). reddit is
# absent on purpose: its labels are its communities (41 subreddits).
_COMMUNITY_STRUCTURE = {
    "ogbn-products": (64, 0.55),
    "ogbn-arxiv": (32, 0.45),
}

# name: (num_graphs, avg_nodes, avg_edges, feat_desc, num_classes)
GRAPH_DATASET_STATS = {
    "ENZYMES": (600, 33, 62, 18, 6),
    "ogbg-molhiv": (41_127, 26, 28, "mol", 2),
    "ogbg-ppa": (158_100, 244, 2266, "ppa", 37),
}


@dataclasses.dataclass
class NodeClassificationData:
    name: str
    src: np.ndarray
    dst: np.ndarray
    num_nodes: int
    features: np.ndarray  # (N, D) float32
    labels: np.ndarray  # (N,) int64 or (N, T) float32 multilabel
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    edge_feat: Optional[np.ndarray] = None  # (E, R) e.g. proteins relations
    synthetic: bool = True


@dataclasses.dataclass
class GraphClassificationData:
    name: str
    graphs: List[Tuple[np.ndarray, np.ndarray, int]]  # (src, dst, num_nodes)
    node_feats: List[np.ndarray]
    edge_feats: List[Optional[np.ndarray]]
    labels: np.ndarray
    num_classes: int
    synthetic: bool = True
    # OGB's scaffold/species splits (graph indices) when the real data ships
    # them; None: the drivers' random 80/10/10 split with numpy seed 42
    splits: Optional[Dict[str, np.ndarray]] = None


def _powerlaw_targets(rng, n: int, e: int, alpha: float = 0.8) -> np.ndarray:
    """Sample e endpoints with zipf-ish popularity (social-graph skew)."""
    # p(i) ∝ (i+1)^-alpha over a random permutation of nodes
    ranks = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    p = ranks / ranks.sum()
    perm = rng.permutation(n)
    return perm[rng.choice(n, size=e, p=p)]


def _grouped_pick(rng, group: np.ndarray, src: np.ndarray) -> np.ndarray:
    """For each src node, a uniform random node from src's group."""
    order = np.argsort(group, kind="stable")
    counts = np.bincount(group)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    gidx = group[src]
    r = rng.random(len(src))
    idx = (offsets[gidx] + (r * counts[gidx]).astype(np.int64)).clip(0, len(group) - 1)
    return order[idx]


def _homophilous_edges(
    rng, labels: np.ndarray, e: int, homophily: float, alpha: float = 0.8
):
    """Edges where a `homophily` fraction connect same-class nodes."""
    n = len(labels)
    src = _powerlaw_targets(rng, n, e, alpha)
    same = rng.random(e) < homophily
    dst = np.empty(e, dtype=np.int64)
    dst[same] = _grouped_pick(rng, labels, src[same])
    dst[~same] = rng.integers(0, n, size=(~same).sum())
    return src.astype(np.int64), dst


def _community_edges(
    rng, comm: np.ndarray, labels: np.ndarray, e: int,
    p_comm: float, homophily: float, alpha: float = 0.8,
):
    """Two-level edges: a ``p_comm`` fraction stay inside the src node's
    fine community, a further ``homophily - p_comm`` fraction connect
    same-class nodes, and the rest are uniform."""
    n = len(labels)
    src = _powerlaw_targets(rng, n, e, alpha)
    u = rng.random(e)
    in_comm = u < p_comm
    in_class = (u >= p_comm) & (u < homophily)
    dst = rng.integers(0, n, size=e)
    dst[in_comm] = _grouped_pick(rng, comm, src[in_comm])
    dst[in_class] = _grouped_pick(rng, labels, src[in_class])
    return src.astype(np.int64), dst.astype(np.int64)


def synthetic_node_classification(
    name: str,
    seed: int = 0,
    homophily: float = 0.7,
    noise: float = 1.0,
    cache_dir: Optional[str] = None,
    scale: float = 1.0,
    structure_required: bool = False,
) -> NodeClassificationData:
    """``scale`` < 1 shrinks node/edge counts proportionally (smoke tests).

    ``structure_required=True`` plants a signal that node features alone
    cannot reach: a cluster latent drives the edges, an independent code
    latent drives the features, and the label is decoded from the mean
    latent of the node's in-neighbours. A model whose aggregation is broken
    scores about chance on it.
    """
    if name not in NODE_DATASET_STATS:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(NODE_DATASET_STATS)}")
    n, e, d, c = NODE_DATASET_STATS[name]
    if not 0.0 < scale <= 1.0:
        raise ValueError(f"scale must be in (0, 1], got {scale}")
    if scale != 1.0:
        n = max(c * 4, int(n * scale))
        e = max(n, int(e * scale))

    if cache_dir:
        comm_tag = (
            "-c{}x{}".format(*_COMMUNITY_STRUCTURE[name])
            if name in _COMMUNITY_STRUCTURE and scale == 1.0 and not structure_required
            else ""
        )
        key = hashlib.md5(
            f"{name}-{seed}-{homophily}-{noise}-{scale}-{structure_required}-v4{comm_tag}".encode()
        ).hexdigest()[:12]
        path = os.path.join(cache_dir, f"syn_{name}_{key}.npz")
        if os.path.exists(path):
            z = np.load(path)
            return NodeClassificationData(
                name, z["src"], z["dst"], n, z["x"], z["y"],
                z["train"], z["val"], z["test"], c,
                z["ef"] if "ef" in z.files else None,
            )

    rng = np.random.default_rng(seed)
    if name == "ogbn-proteins":
        # multilabel tasks carried by structure: a latent embedding drives
        # the labels, and the 8 relation weights reflect endpoint similarity
        z = rng.standard_normal((n, 8)).astype(np.float32)
        w_lab = rng.standard_normal((8, c)).astype(np.float32)
        labels = ((z @ w_lab) > 0.8).astype(np.float32)
        src = _powerlaw_targets(rng, n, e)
        dst = rng.integers(0, n, size=e)
        sim = z[src] * z[dst]  # (e, 8) per-relation affinity
        edge_feat = (1.0 / (1.0 + np.exp(-sim))).astype(np.float32)
        x = np.ones((n, d), dtype=np.float32)

    elif structure_required:
        # cluster latent -> edges; independent code latent -> features;
        # label = argmax of a linear map of the in-neighbour-mean latent
        r = 8
        cluster = rng.integers(0, c, size=n).astype(np.int64)
        src, dst = _homophilous_edges(rng, cluster, e, homophily)
        z = rng.standard_normal((n, r)).astype(np.float32)
        w_feat = (rng.standard_normal((r, d)) / np.sqrt(r)).astype(np.float32)
        x = z @ w_feat + 0.3 * noise * rng.standard_normal((n, d)).astype(np.float32)
        agg = np.zeros((n, r), dtype=np.float64)
        np.add.at(agg, dst, z[src])
        deg = np.bincount(dst, minlength=n)
        mean_z = agg / np.maximum(deg, 1)[:, None]
        # zero-in-degree nodes: label from the node's own latent
        mean_z[deg == 0] = z[deg == 0]
        m_lab = rng.standard_normal((r, c))
        labels = np.asarray(mean_z @ m_lab).argmax(axis=1).astype(np.int64)
        edge_feat = None
    else:
        comm_cfg = _COMMUNITY_STRUCTURE.get(name)
        if comm_cfg and scale == 1.0:
            # fine communities nested in classes (see _COMMUNITY_STRUCTURE)
            comm_size, p_comm = comm_cfg
            comm = rng.integers(0, max(c, n // comm_size), size=n).astype(np.int64)
            labels = (comm % c).astype(np.int64)
            src, dst = _community_edges(rng, comm, labels, e, p_comm, homophily)
        else:
            labels = rng.integers(0, c, size=n).astype(np.int64)
            src, dst = _homophilous_edges(rng, labels, e, homophily)
        means = rng.standard_normal((c, d)).astype(np.float32)
        x = means[labels] + noise * rng.standard_normal((n, d)).astype(np.float32)
        edge_feat = None

    # split fractions follow the reference datasets' regimes:
    # citation = tiny train set; reddit/ogb = majority train
    if name in ("cora", "pubmed"):
        tr, va = 140 / n, 500 / n
    else:
        tr, va = 0.66, 0.10
    u = rng.random(n)
    train_mask = u < tr
    val_mask = (u >= tr) & (u < tr + va)
    test_mask = u >= tr + va

    data = NodeClassificationData(
        name, src, dst, n, x, labels,
        train_mask, val_mask, test_mask, c, edge_feat,
    )
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        save = dict(
            src=src, dst=dst, x=x, y=data.labels,
            train=train_mask, val=val_mask, test=test_mask,
        )
        if edge_feat is not None:
            save["ef"] = edge_feat
        np.savez(path, **save)
    return data


def synthetic_graph_classification(
    name: str, seed: int = 0, num_graphs: Optional[int] = None
) -> GraphClassificationData:
    """Graphs of Poisson node and edge counts around the dataset's means: a
    ring plus random chords whose targets the class narrows; ENZYMES has
    class-shifted float features, molhiv integer atom and bond categories
    (the first atom column class-shifted), ppa a class pattern in its 7
    float edge features and one constant node feature."""
    if name not in GRAPH_DATASET_STATS:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(GRAPH_DATASET_STATS)}")
    total, avg_n, avg_e, feat, c = GRAPH_DATASET_STATS[name]
    if num_graphs is None:
        num_graphs = total
    rng = np.random.default_rng(seed)
    graphs, node_feats, edge_feats, labels = [], [], [], []
    ys = rng.integers(0, c, size=num_graphs)
    for i in range(num_graphs):
        y = ys[i]
        n = max(3, int(rng.poisson(avg_n)))
        e = max(2, int(rng.poisson(avg_e)))
        base = np.arange(n)
        src = np.concatenate([base, rng.integers(0, n, size=e)])
        dst = np.concatenate([(base + 1) % n, rng.integers(0, max(1, n // (1 + y % 4)), size=e)])
        graphs.append((src.astype(np.int64), dst.astype(np.int64), n))
        if feat == "mol":
            nf = np.stack(
                [rng.integers(0, hi, size=n) for hi in (40, 4, 8, 8, 6, 4, 4, 2, 2)], axis=1,
            ).astype(np.int32)
            nf[:, 0] = rng.integers(0, 30, size=n) + (y % 2) * 10
            ef = np.stack([rng.integers(0, hi, size=len(src)) for hi in (5, 6, 2)],
                          axis=1).astype(np.int32)
        elif feat == "ppa":
            nf = np.zeros((n, 1), dtype=np.int32)
            proto = np.sin(np.arange(7) * (1 + y))
            ef = (proto + 0.8 * rng.standard_normal((len(src), 7))).astype(np.float32)
        else:
            means = np.linspace(-1, 1, c)[y]
            nf = (means + 0.7 * rng.standard_normal((n, feat))).astype(np.float32)
            ef = None
        node_feats.append(nf)
        edge_feats.append(ef)
        labels.append(y)
    return GraphClassificationData(
        name, graphs, node_feats, edge_feats, np.asarray(labels, dtype=np.int64), c
    )
