"""Plain PyTorch pieces every reference model shares.

Nothing here imports the program (``dgl_tpu_torch``): the graph is built
again from the raw edges with the configuration's transforms, aggregation
is ``index_select`` and ``index_add_`` over blocks of edges, the softmax is
written out, the loss and Adam are their formulas. The program's random
draws are followed, not read: a ``Replay`` holds generators seeded as the
benchmark seeded the program's, and the reference draws from them in the
program's order and shapes (``bernoulli_`` for feature dropout, one int32
for each layer's attention-dropout seed). The attention-dropout hash is a
frozen copy of ``dgl_tpu_torch/kernels/gat_attention.py:keep_mask``
(commit 2745c07), keyed on ``position · H + head`` of each edge in the
graph's dst-sorted order.

``tf32``: the control's precision. On a card the GEMMs run with TF32 on;
on the CPU, which has no TF32, the operands are rounded to TF32's 10-bit
mantissa first, which is what the card's TF32 units read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

__all__ = ["RefGraph", "build_graph", "linear", "mean_aggregate", "Replay", "keep_mask",
           "masked_ce", "follow_steps", "Readings", "layer_widths", "xavier_bound",
           "block_sizes", "edge_keys", "check_samples"]

# edges per block of an aggregation: its (block, width) buffer stays under 2 GiB
_BLOCK_BYTES = 1 << 31


@dataclasses.dataclass
class RefGraph:
    """Edges in dst-sorted order (stable, so ties keep the transformed
    list's order), int64, with the in-degree of every node."""

    src: torch.Tensor
    dst: torch.Tensor
    num_nodes: int
    in_deg: torch.Tensor  # (N,) float32

    @property
    def num_edges(self) -> int:
        return int(self.src.numel())


def build_graph(src: np.ndarray, dst: np.ndarray, n: int, *, bidirect: bool, self_loops: bool,
                device: torch.device) -> RefGraph:
    """The configuration's graph from its raw edges: bidirected (the union
    of the edges and their reverses, duplicates dropped, ordered by source
    then destination), then self-loops (existing ones dropped, one a node
    appended), then sorted stably by destination."""
    s = torch.from_numpy(np.asarray(src, np.int64)).to(device)
    d = torch.from_numpy(np.asarray(dst, np.int64)).to(device)
    if bidirect:
        key = torch.unique(torch.cat([s * n + d, d * n + s]))
        s, d = key // n, key % n
    if self_loops:
        keep = s != d
        loop = torch.arange(n, device=device)
        s, d = torch.cat([s[keep], loop]), torch.cat([d[keep], loop])
    order = torch.sort(d, stable=True).indices
    s, d = s[order], d[order]
    deg = torch.bincount(d, minlength=n).to(torch.float32)
    return RefGraph(s, d, n, deg)



def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest at TF32's 10 mantissa bits; the gradient
    passes through unchanged."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()


def linear(x: torch.Tensor, w: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``x @ w.T`` (torch's Linear layout), in float32, or in TF32 for the
    control."""
    if not tf32:
        return x @ w.t()
    if x.device.type != "cuda":
        return _round_tf32(x) @ _round_tf32(w).t()
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return x @ w.t()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _block(width: int, itemsize: int) -> int:
    return max(1, _BLOCK_BYTES // (itemsize * max(width, 1)))


class _Mean(torch.autograd.Function):
    """Mean over in-edges, summed with ``index_add_`` over blocks of edges;
    its backward is the same over the sources."""

    @staticmethod
    def forward(ctx, x, g: RefGraph):
        ctx.g = g
        d = x.shape[1]
        out = torch.zeros((g.num_nodes, d), dtype=x.dtype, device=x.device)
        step = _block(d, x.element_size())
        for a in range(0, g.num_edges, step):
            out.index_add_(0, g.dst[a: a + step], x.index_select(0, g.src[a: a + step]))
        return out / g.in_deg.to(x.dtype).clamp(min=1.0).unsqueeze(1)

    @staticmethod
    def backward(ctx, grad):
        g: RefGraph = ctx.g
        grad = grad / g.in_deg.to(grad.dtype).clamp(min=1.0).unsqueeze(1)
        gx = torch.zeros_like(grad)
        step = _block(grad.shape[1], grad.element_size())
        for a in range(0, g.num_edges, step):
            gx.index_add_(0, g.src[a: a + step], grad.index_select(0, g.dst[a: a + step]))
        return gx, None


def mean_aggregate(g: RefGraph, x: torch.Tensor) -> torch.Tensor:
    """(N, D) mean of each node's in-neighbours' rows; 0 for none."""
    return _Mean.apply(x, g)


class Replay:
    """The program's dropout stream, drawn again: a generator on the card
    seeded as the program's was, used in the program's order and shapes."""

    def __init__(self, seed: int, device: torch.device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """Inverted dropout with a ``bernoulli_`` mask of x's shape."""
        if p == 0.0:
            return x
        keep = 1.0 - p
        mask = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        mask.bernoulli_(keep, generator=self.gen)  # drawn as the program draws it, in float32
        return x * mask.to(x.dtype) / keep

    def seed_int32(self) -> torch.Tensor:
        return torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32, device=self.device,
                             generator=self.gen)


_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def keep_mask(num_edges: int, heads: int, seed: torch.Tensor, keep: float,
              device: torch.device) -> torch.Tensor:
    """(E, H) attention-dropout factors: murmur3 fmix32 of ``(position · H +
    head) ^ seed``; ``1/keep`` where its low 24 bits fall below
    ``int(keep · 2²⁴)``, else 0."""
    pos = torch.arange(num_edges, dtype=torch.int64, device=device)
    h = torch.arange(heads, dtype=torch.int64, device=device)
    key = ((pos & _U32).unsqueeze(1) * heads + h) & _U32
    x = torch.bitwise_xor(key, seed.to(torch.int64)) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    thresh = min(int(keep * float(1 << 24)), 1 << 24)
    scale = float(np.float32(1.0 / keep))
    return torch.where((x & 0xFFFFFF) < thresh, scale, 0.0).to(torch.float32)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy (log-softmax written out) over the masked rows."""
    logp = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    ce = -logp.gather(1, labels.long().unsqueeze(1)).squeeze(1)
    m = mask.to(ce.dtype)
    return (ce * m).sum() / m.sum().clamp(min=1.0)


@dataclasses.dataclass
class Readings:
    """What a training side gives over its first steps: each step's loss,
    each leaf's norm of the first gradient as the optimiser got it (with
    coupled weight decay), and each leaf's norm of its change after the
    last step."""

    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def follow_steps(params: Dict[str, torch.Tensor], loss_fn: Callable[[int, Dict], torch.Tensor],
                 steps: int, *, lr: float, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8) -> Readings:
    """``steps`` steps of Adam with coupled L2 (torch's ``Adam(weight_decay=)``)
    from ``params``; ``loss_fn(step, params)`` gives the step's loss."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    p0 = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p0.items()}
    losses, first = [], {}
    b1, b2 = betas
    for t in range(1, steps + 1):
        loss = loss_fn(t - 1, p)
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                g = torch.zeros_like(w) if g is None else g
                if weight_decay:
                    g = g + weight_decay * w
                if t == 1:
                    first[k] = _norm(g)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                step_size = lr / (1 - b1 ** t)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                w.addcdiv_(m[k], denom, value=-step_size)
        del loss, grads
    change = {k: _norm(p[k].detach() - p0[k]) for k in p}
    return Readings(losses, first, change)


def layer_widths(model: dict) -> List[int]:
    """Input, hidden and output widths of a layered model section."""
    return [model["in_feats"]] + [model["hidden"]] * (model["layers"] - 1) + [model["classes"]]


def xavier_bound(fan_in: int, fan_out: int, gain: float = 1.0) -> float:
    return gain * math.sqrt(6.0 / (fan_in + fan_out))


def block_sizes(b: int, fanouts: Sequence[int]) -> List[int]:
    """Destinations of each positional block, outermost first, for ``b``
    seeds and ``fanouts`` listed outermost first."""
    sizes, cur = [], b
    for f in reversed(list(fanouts)):
        sizes.append(cur)
        cur = cur * (1 + f)
    return sizes[::-1]


def edge_keys(g: RefGraph) -> torch.Tensor:
    """Every edge as ``dst · N + src``, sorted: the lookup of ``check_samples``."""
    return torch.sort(g.dst * g.num_nodes + g.src).values


def check_samples(g: RefGraph, keys: torch.Tensor, input_nodes: torch.Tensor,
                  seeds: torch.Tensor, fanouts: Sequence[int]) -> int:
    """How many entries of one step's ``input_nodes`` break the sampler's
    rule: the first ``b`` are the seeds; then, innermost layer first, each
    destination's ``fanout`` samples are in-neighbours of it, or itself
    where it has none. ``keys``: ``edge_keys(g)``."""
    n = g.num_nodes
    ids = input_nodes.to(g.src.device, torch.int64)
    b = seeds.numel()
    bad = int((ids[:b] != seeds.to(ids.device, torch.int64)).sum())
    cur = b
    for f in reversed(list(fanouts)):
        dst = ids[:cur].repeat_interleave(f)
        nbr = ids[cur: cur + cur * f]
        if nbr.numel() != dst.numel():
            return bad + int(dst.numel())
        want = dst * n + nbr
        pos = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
        found = keys[pos] == want
        lonely = (g.in_deg.index_select(0, dst) == 0) & (nbr == dst)
        bad += int((~(found | lonely)).sum())
        cur = cur + cur * f
    return bad + int(ids.numel() != cur)
