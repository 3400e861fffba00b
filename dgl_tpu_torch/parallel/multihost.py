"""Process start-up and the rank grid.

Counterpart of ``dgl_tpu/parallel/multihost.py``. ``initialize`` joins this
process to the process group (``torch.distributed.init_process_group``),
with the JAX module's environment fall-backs: ``DGL_TPU_COORDINATOR``,
``DGL_TPU_NUM_PROCESSES`` and ``DGL_TPU_PROCESS_ID``. Each process is one
rank and drives one device. ``global_mesh`` lays the ranks out on a grid
whose first axis spans the processes, and gives each axis its sub-group.

The backend is the caller's choice, never picked here:
* ``nccl``: CUDA, one rank per card (rank ``r`` drives ``cuda:r`` unless
  ``device`` names a card). NCCL refuses two ranks on one device, so ranks
  that would share a card raise ``ValueError`` before any connection.
* ``gloo``: the CPU, or k ranks sharing one card when ``device`` is
  ``cuda`` (rank ``r`` drives ``cuda:(r mod cards)``); the collectives then
  stage through host memory (``comm.py``) and measure no multi-GPU speed.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "check_backend", "global_mesh", "RankMesh"]

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, device, num_processes: int) -> None:
    """Raise ``ValueError`` for a backend that cannot serve
    ``num_processes`` local ranks on ``device`` (``cpu`` or ``cuda``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pass one of {BACKENDS}")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"nccl runs on CUDA devices, not {dev}; use gloo on the CPU")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if num_processes > cards:
            raise ValueError(
                f"nccl puts one rank on each card: {num_processes} ranks need {num_processes} "
                f"cards and this host has {cards}; NCCL refuses two ranks on one device "
                "(use gloo for ranks that share a card)")
    elif dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str,
    device=None,
) -> torch.device:
    """Join the process group and return the device this rank drives.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there) or an
    ``init_method`` URL (``tcp://``, ``file://``); each argument left None
    is read from its ``DGL_TPU_*`` variable. ``device``: ``cpu``, ``cuda``
    (the card is derived from the rank, see the module docstring) or a
    card such as ``cuda:1``; None means ``cuda``.
    """
    coordinator_address = coordinator_address or os.environ.get("DGL_TPU_COORDINATOR")
    if num_processes is None and os.environ.get("DGL_TPU_NUM_PROCESSES"):
        num_processes = int(os.environ["DGL_TPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("DGL_TPU_PROCESS_ID"):
        process_id = int(os.environ["DGL_TPU_PROCESS_ID"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs a coordinator address, the number of processes and "
                         "this process's id (arguments or DGL_TPU_COORDINATOR, "
                         "DGL_TPU_NUM_PROCESSES, DGL_TPU_PROCESS_ID)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        check_backend(backend, dev, num_processes)
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    else:
        check_backend(backend, dev, 1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id,
                            **({"device_id": dev} if backend == "nccl" else {}))
    return dev


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The ranks of the world laid out on a grid (``ranks[c]`` is the rank
    at coordinates ``c``), this rank's coordinates, and for each axis the
    sub-group of the ranks that differ from this one along it only."""

    axis_names: Tuple[str, ...]
    ranks: np.ndarray
    coords: Tuple[int, ...]
    groups: Dict[str, object]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.ranks.shape)

    def size(self, axis: str) -> int:
        return self.ranks.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.axis_names.index(axis)]


def rank_grid(shape: Sequence[int], axis_names: Sequence[str]) -> RankMesh:
    """The world's ranks, in order, reshaped to ``shape``; every rank must
    call this with the same arguments (it creates the sub-groups)."""
    world = dist.get_world_size()
    if int(np.prod(shape)) != world or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} over axes {tuple(axis_names)} does not "
                         f"hold the {world} ranks")
    ranks = np.arange(world).reshape(tuple(shape))
    coords = tuple(int(c) for c in np.argwhere(ranks == dist.get_rank())[0])
    groups = {}
    for a, name in enumerate(axis_names):
        # every rank creates every sub-group of the axis, in the same order
        others = [range(n) for i, n in enumerate(shape) if i != a]
        for fixed in itertools.product(*others):
            idx = list(fixed)
            idx.insert(a, slice(None))
            members = [int(r) for r in ranks[tuple(idx)]]
            group = dist.new_group(members)
            if dist.get_rank() in members:
                groups[name] = group
    return RankMesh(tuple(axis_names), ranks, coords, groups)


def global_mesh(axis_names: Sequence[str] = ("data", "graph"),
                shape: Optional[Sequence[int]] = None) -> RankMesh:
    """The rank grid over all processes. The first axis spans the
    processes; ``shape`` may split them further, as a JAX mesh splits
    hosts and their devices (``(2, 2)`` for four ranks)."""
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axis_names) - 1)
    return rank_grid(shape, axis_names)
