"""Data-parallel sampled-minibatch training.

Counterpart of ``dgl_tpu/parallel/dp.py``: each rank of a group consumes
its own sampled minibatch, and the loss and the gradients are averaged over
the group (JAX's ``pmean``) before one optimiser step, so the replicas'
parameters stay equal. The average adds the ranks' values in rank order
(``comm.all_sum``), the same bits on every rank.

``stack_minibatches`` stacks R minibatches of the same static shapes, as
the JAX function does: their positional blocks (``sampling/neighbor.py``)
depend on the shapes alone, so the stack keeps one list of blocks and
stacks ``input_nodes``, ``seeds`` and ``seed_mask`` along a leading replica
dimension. A step takes the stack and uses the replica of its rank.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..sampling.neighbor import MiniBatch
from .comm import all_sum, all_sum_grads_, rank_of, world_size

__all__ = ["stack_minibatches", "replica", "make_dp_train_step"]


def _shape(g):
    return (g.num_src_nodes, g.num_dst_nodes, g.num_edges, g.block_fanout)


def stack_minibatches(mbs: Sequence[MiniBatch]) -> MiniBatch:
    """R same-shape minibatches stacked along a new leading replica dim."""
    first = mbs[0]
    for mb in mbs[1:]:
        if ([_shape(g) for g in mb.blocks] != [_shape(g) for g in first.blocks]
                or mb.input_nodes.shape != first.input_nodes.shape
                or mb.seeds.shape != first.seeds.shape):
            raise ValueError("stack_minibatches needs minibatches of one static shape")
    if any(g.block_fanout is None for g in first.blocks):
        raise ValueError("stack_minibatches stacks positional blocks (same shapes, same blocks)")
    return MiniBatch(first.blocks, torch.stack([mb.input_nodes for mb in mbs]),
                     torch.stack([mb.seeds for mb in mbs]),
                     torch.stack([mb.seed_mask for mb in mbs]))


def replica(stacked: MiniBatch, r: int) -> MiniBatch:
    """Replica ``r`` of a stack."""
    return MiniBatch(stacked.blocks, stacked.input_nodes[r], stacked.seeds[r],
                     stacked.seed_mask[r])


def make_dp_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, group=None):
    """``step(model, stacked, *consts) -> mean loss``. ``loss_fn(model, mb,
    *consts)`` sees one replica's minibatch: this rank's position in
    ``group``. ``consts`` (the feature matrix, the labels) are replicated."""

    def step(model: torch.nn.Module, stacked: MiniBatch, *consts):
        k = world_size(group)
        if stacked.input_nodes.shape[0] != k:
            raise ValueError(f"a stack of {stacked.input_nodes.shape[0]} replicas for {k} ranks")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, replica(stacked, rank_of(group)), *consts)
        loss.backward()
        all_sum_grads_(model.parameters(), group, 1.0 / k)
        optimizer.step()
        return all_sum(loss.detach(), group) / k

    return step
