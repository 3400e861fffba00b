"""The cells' graphs, features, labels and masks.

The graph and its labels come from a frozen copy of the structurally
matched generator of ``dgl_tpu_torch/data/synthetic.py`` (commit b7b1c59):
power-law sources, edges inside a source's fine community, inside its class
or uniform, at the configuration's published node and edge counts. No real
dataset can be in the repository, so this stands in for it, as it does for
the port's drivers. The generator runs on the host once per checkout, from
the configuration's ``data_seed``, and its arrays are cached as int32 under
``gnnbench/.cache/``. With the same seed it draws the same edges and labels
as the port's generator, whose random stream it follows up to the labels.
Where the graph section states ``bidirected_edges`` (the published edge
count after ``to_bidirected``, as DGL loads the dataset), the generator
then keeps drawing from the same stream, with the same power-law ranks,
until the distinct unordered pairs of distinct nodes reach half that
count, and keeps the first that many in the order drawn: bidirected, the
graph has exactly the published edges, where the first draw alone loses a
quarter of products' to duplicates.

Everything else is made per run from ``--seed`` on the device, in a few
large calls: the features (each class's mean plus unit noise, as the
generator plants them), the train mask (each node with probability
``train_fraction``) and the weights (``weights``). So the same seed gives
the same inputs, every seed gives the same sizes, and a run reads about
half a gigabyte from the cache at most.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["GraphData", "CACHE_DIR", "load_graph", "generate", "derive_seed", "features",
           "train_mask", "weights"]

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")
_VERSION = "v2"


@dataclasses.dataclass
class GraphData:
    """The raw directed edges (int32, as generated: not yet bidirected or
    self-looped) and the int32 labels of one configuration."""

    src: np.ndarray
    dst: np.ndarray
    labels: np.ndarray
    num_nodes: int
    num_classes: int
    generated_s: float = 0.0  # seconds spent generating in this run (0 when cached)


# -- the frozen generator ----------------------------------------------------

def _powerlaw_targets(rng, n: int, e: int, alpha: float = 0.8, perm=None):
    ranks = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    p = ranks / ranks.sum()
    perm = rng.permutation(n) if perm is None else perm
    return perm[rng.choice(n, size=e, p=p)], perm


def _grouped_pick(rng, group: np.ndarray, src: np.ndarray) -> np.ndarray:
    order = np.argsort(group, kind="stable")
    counts = np.bincount(group)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    gidx = group[src]
    r = rng.random(len(src))
    idx = (offsets[gidx] + (r * counts[gidx]).astype(np.int64)).clip(0, len(group) - 1)
    return order[idx]


def _homophilous_edges(rng, labels: np.ndarray, e: int, homophily: float, alpha: float = 0.8,
                       perm=None):
    n = len(labels)
    src, perm = _powerlaw_targets(rng, n, e, alpha, perm)
    same = rng.random(e) < homophily
    dst = np.empty(e, dtype=np.int64)
    dst[same] = _grouped_pick(rng, labels, src[same])
    dst[~same] = rng.integers(0, n, size=(~same).sum())
    return src.astype(np.int64), dst, perm


def _community_edges(rng, comm, labels, e: int, p_comm: float, homophily: float,
                     alpha: float = 0.8, perm=None):
    n = len(labels)
    src, perm = _powerlaw_targets(rng, n, e, alpha, perm)
    u = rng.random(e)
    in_comm = u < p_comm
    in_class = (u >= p_comm) & (u < homophily)
    dst = rng.integers(0, n, size=e)
    dst[in_comm] = _grouped_pick(rng, comm, src[in_comm])
    dst[in_class] = _grouped_pick(rng, labels, src[in_class])
    return src.astype(np.int64), dst.astype(np.int64), perm


def _first_distinct(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Positions of the first draw of each unordered pair of distinct
    nodes, in the order drawn."""
    key = np.minimum(src, dst) * n + np.maximum(src, dst)
    key[src == dst] = -1
    _, first = np.unique(key, return_index=True)
    first.sort()
    return first[key[first] >= 0]


def generate(graph: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(src, dst, labels)`` of a configuration's ``graph`` section:
    ``num_nodes``, ``num_edges`` (the first draw), ``num_classes``,
    ``homophily``, ``data_seed``, for a graph with fine communities
    ``community: [size, share of edges inside]``, and optionally
    ``bidirected_edges`` (even): then the edges are ``bidirected_edges / 2``
    distinct unordered pairs of distinct nodes, each once."""
    n, e, c = graph["num_nodes"], graph["num_edges"], graph["num_classes"]
    rng = np.random.default_rng(graph["data_seed"])
    community = graph.get("community")
    if community:
        size, p_comm = community
        comm = rng.integers(0, max(c, n // size), size=n).astype(np.int64)
        labels = (comm % c).astype(np.int64)

        def draw(k, perm):
            return _community_edges(rng, comm, labels, k, p_comm, graph["homophily"], perm=perm)
    else:
        labels = rng.integers(0, c, size=n).astype(np.int64)

        def draw(k, perm):
            return _homophilous_edges(rng, labels, k, graph["homophily"], perm=perm)
    src, dst, perm = draw(e, None)
    target = graph.get("bidirected_edges")
    if target is not None:
        if target % 2 or not 0 < target <= n * (n - 1):
            raise ValueError(f"bidirected_edges {target}: not an even count of at most "
                             f"n·(n−1) = {n * (n - 1)}")
        want = target // 2
        keep = _first_distinct(src, dst, n)
        while len(keep) < want:
            # draw the shortfall over the share of the draws so far that were new
            more = int((want - len(keep)) * len(src) / len(keep) * 1.25) + 1024
            s2, d2, _ = draw(more, perm)
            src, dst = np.concatenate([src, s2]), np.concatenate([dst, d2])
            keep = _first_distinct(src, dst, n)
        keep = keep[:want]
        src, dst = src[keep], dst[keep]
    return src.astype(np.int32), dst.astype(np.int32), labels.astype(np.int32)


def _cache_path(graph: dict) -> str:
    key = hashlib.sha256(json.dumps(graph, sort_keys=True).encode()).hexdigest()[:16]
    return os.path.join(CACHE_DIR, f"graph_{key}_{_VERSION}.npz")


def load_graph(graph: dict, cache: bool = True) -> GraphData:
    """The configuration's graph, from the cache or generated (and cached)."""
    n, c = graph["num_nodes"], graph["num_classes"]
    path = _cache_path(graph)
    if cache and os.path.exists(path):
        with np.load(path) as z:
            return GraphData(z["src"], z["dst"], z["labels"], n, c)
    t0 = time.perf_counter()
    src, dst, labels = generate(graph)
    took = time.perf_counter() - t0
    if cache:
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, src=src, dst=dst, labels=labels)
        os.replace(tmp, path)
    return GraphData(src, dst, labels, n, c, generated_s=took)


# -- per-run inputs from --seed -----------------------------------------------

def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (features, weights, dropout, ...),
    drawn from ``--seed``, whatever its sign or size."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2**63 - 1)


def features(d: int, num_classes: int, labels: torch.Tensor, seed: int,
             noise: float) -> torch.Tensor:
    """(n, d) float32 on the labels' device: each class's mean (standard
    normal) plus ``noise`` times standard normal noise."""
    dev, n, c = labels.device, labels.shape[0], num_classes
    gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, "features"))
    means = torch.randn((c, d), generator=gen, device=dev)
    x = torch.randn((n, d), generator=gen, device=dev)
    x.mul_(noise).add_(means.index_select(0, labels.long()))
    return x


def train_mask(n: int, fraction: float, seed: int, dev: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, "train_mask"))
    return torch.rand((n,), generator=gen, device=dev) < fraction


def weights(layout: Sequence[Tuple[str, Tuple[int, ...], float]], seed: int,
            dev: torch.device) -> Dict[str, torch.Tensor]:
    """The initial weights: one uniform draw on the device for every leaf
    together, each leaf scaled to ``±bound`` (its entry in ``layout``: name,
    shape, bound; bound 0 makes a zero leaf)."""
    gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, "weights"))
    sizes: List[int] = [int(np.prod(shape)) for _, shape, _ in layout]
    flat = torch.rand((sum(sizes),), generator=gen, device=dev).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for (name, shape, bound), size in zip(layout, sizes):
        out[name] = (flat[at: at + size] * bound).reshape(shape).clone()
        at += size
    return out
