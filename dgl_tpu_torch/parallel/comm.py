"""The collectives the distributed modules share, over ``torch.distributed``.

* ``all_to_all(x, group)``: the halo exchange, differentiable. ``x`` holds
  one block of equal size for every rank of ``group``; block ``o`` of the
  result is the block rank ``o`` sent to this rank (JAX's
  ``all_to_all(split_axis=0, concat_axis=0)``). With equal splits the
  exchange is its own transpose, so the backward is the same exchange of
  the cotangent.
* ``all_gather(x, group)``: every rank's rows in rank order,
  differentiable (the backward is a reduce-scatter: an exchange of the
  cotangent's row blocks, then their sum); ``all_gather_rows`` without
  autograd.
* ``all_sum(t, group)``: the sum over the ranks, in rank order, from an
  all-gather: every rank gets the same bits, whatever the backend's reduce
  order (the gradients, losses and counts of the training steps;
  ``all_sum_grads_`` over a module's gradients in one collective).
* ``broadcast_(t, src, group)``: in place, from the global rank ``src``.

Under ``gloo`` a CUDA tensor is staged through pinned host memory: the
tensor is copied to the host, the collective runs there, and the result is
copied back. That is what gloo does with device tensors in any case; here
the copy is in the code, taken only under gloo (k ranks sharing one card).
Under ``nccl`` the collectives run on the device. A process with no process
group is a world of one rank, in which every collective is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["world_size", "rank_of", "all_to_all", "all_gather", "all_sum", "all_gather_rows",
           "all_sum_grads_", "broadcast_"]


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank_of(group=None) -> int:
    """This process's rank within ``group``."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    k = world_size(group)
    if k == 1:
        return x
    if x.shape[0] % k:
        raise ValueError(f"all_to_all: {x.shape[0]} rows do not split into {k} equal blocks")
    x = x.contiguous()
    if _staged(x, group):
        send = _host(x)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable exchange of equal row blocks (see the module docstring)."""
    return _AllToAll.apply(x, group)


def _gather(t: torch.Tensor, group) -> list:
    src = _host(t) if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the rows, in rank order (no
    autograd)."""
    if world_size(group) == 1:
        return t
    return torch.cat(_gather(t, group))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        # each rank's cotangent of this rank's rows, summed in rank order
        k = world_size(ctx.group)
        blocks = _exchange(g, ctx.group)
        return blocks.reshape((k, -1) + tuple(g.shape[1:])).sum(0), None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable ``all_gather_rows``; the backward is a reduce-scatter
    (an exchange of the cotangent's row blocks, then their sum)."""
    return _AllGather.apply(x, group)


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``group``, added in rank order (no
    autograd); bitwise the same on every rank."""
    if world_size(group) == 1:
        return t
    parts = _gather(t, group)
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def all_sum_grads_(params, group=None, scale: float = 1.0) -> None:
    """Replace each ``.grad`` of ``params`` by ``scale`` times its
    ``all_sum`` over the group (one collective over a flat buffer)."""
    params = [p for p in params if p.grad is not None]
    flat = all_sum(torch.cat([p.grad.reshape(-1) for p in params]), group)
    if scale != 1.0:
        flat = flat * scale
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


def broadcast_(t: torch.Tensor, src: int = 0, group: Optional[object] = None) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s ``t``."""
    if world_size(group) == 1:
        return t
    if _staged(t, group):
        h = _host(t)
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t
