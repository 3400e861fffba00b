"""The row split of a CSR: its long rows cut into chunks of at most T edges.

The CSR kernels walk a CSR's rows with warps (``kernels/csrc/lanes.cuh``),
and a launch lasts as long as its longest row. On the synthetic reddit graph the
reverse CSR has a row of 212,102 edges, a second of 121,314, and 1,852 rows
of more than 512 edges. So every row of more than ``T`` edges is cut into
chunks of at most ``T`` edges, in ascending edge order; a kernel runs each
chunk as one warp's work, into a partials buffer, and each long row's
partials are added in ascending chunk order (no atomic decides an order of
additions: two runs are bitwise equal) inside the launch of K1, K2 and K3,
whose last chunk warp of a row folds it, counted on the plan's
``counters``. Rows of at most ``T`` edges run on the run warps' code.

The plan is built once on the host, with the graph (``from_edges``), from
the CSR's ``indptr`` in numpy, so the ops never read ``indptr`` back from
the card. It holds no padding, no sentinels and no tiling: only the long
rows and their chunks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

__all__ = ["SPLIT_T", "RowSplit", "row_split"]

# T, the longest row one warp walks alone, in edges; of 256, 512 and 1024
# the fastest on the card (chip_smoke.py prints all three; PERF.md)
SPLIT_T = 512


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The long rows of one CSR and their chunks.

    ``rows`` (L,) int64: the rows of more than ``t`` edges, ascending;
    ``chunk_ptr`` (L + 1,) int64: long row ``i`` owns chunks
    ``chunk_ptr[i]:chunk_ptr[i + 1]``; ``chunks`` (C, 2) int64: each chunk's
    ``[begin, end)`` edge offsets, at most ``t`` edges, ascending;
    ``counters`` (L,) int32 zeros: K1, K2 and K3, which fold the long rows
    in their launch, count each long row's chunk warps there as they
    arrive, and the last sets its counter back to 0, so two launches over
    one CSR must not run at once on two streams.
    ``num_rows`` and ``num_edges`` are the CSR's, to check a plan against the
    ``indptr`` it is used with.
    """

    t: int
    num_rows: int
    num_edges: int
    rows: torch.Tensor
    chunk_ptr: torch.Tensor
    chunks: torch.Tensor
    counters: torch.Tensor

    @property
    def num_long(self) -> int:
        return int(self.rows.shape[0])

    @property
    def num_chunks(self) -> int:
        return int(self.chunks.shape[0])

    def to(self, device) -> "RowSplit":
        return dataclasses.replace(self, rows=self.rows.to(device),
                                   chunk_ptr=self.chunk_ptr.to(device),
                                   chunks=self.chunks.to(device),
                                   counters=self.counters.to(device))

    def kernel_args(self, partials: Optional[torch.Tensor], counters: bool = False) -> tuple:
        """The plan's arguments of the kernels' C entry points (``long_t,
        rows, chunk_ptr, n_long, chunks, n_chunks, partials``), with the (C, D)
        float32 ``partials`` buffer the chunks are summed into; ``None`` (a
        null pointer, which no kernel reads) for a plan with no chunks.
        ``counters``: K1's, K2's and K3's, which fold the long rows in their
        launch, take the arrival counters after ``partials``."""
        args = (self.t, self.rows.data_ptr(), self.chunk_ptr.data_ptr(), self.num_long,
                self.chunks.data_ptr(), self.num_chunks,
                None if partials is None else partials.data_ptr())
        return args + (self.counters.data_ptr(),) if counters else args

    @functools.cached_property
    def _device(self) -> Optional[torch.device]:
        """The device every tensor of the plan lies on; None if they differ
        (the tensors of a frozen plan do not change, so it is read once)."""
        devs = {t.device for t in (self.rows, self.chunk_ptr, self.chunks, self.counters)}
        return devs.pop() if len(devs) == 1 else None

    @functools.cached_property
    def _counters_ok(self) -> bool:
        return self.counters.dtype == torch.int32 and self.counters.shape == self.rows.shape

    def check(self, indptr: torch.Tensor, num_edges: int, what: str) -> None:
        """Raise ``ValueError`` unless the plan has this CSR's row and edge
        counts and lies on its device (shapes only: no read of the card).

        The rows themselves are not compared, as that would read ``indptr``
        back: a plan of another CSR with the same counts passes, and the
        kernels then write the rows it lists from its chunks and sum every
        other row in their run warps."""
        if self.num_rows != indptr.numel() - 1 or self.num_edges != num_edges:
            raise ValueError(
                f"{what}: the row split is for {self.num_rows} rows and {self.num_edges} edges, "
                f"the CSR has {indptr.numel() - 1} rows and {num_edges} edges"
            )
        if self._device != indptr.device:
            raise ValueError(f"{what}: the row split lies on another device than indptr")
        if not self._counters_ok:
            raise ValueError(f"{what}: the row split's counters are not one int32 a long row")


def row_split(indptr, t: int = SPLIT_T, device=None) -> RowSplit:
    """The plan of the CSR with row offsets ``indptr`` (a numpy array or a
    tensor; a tensor on the card is copied to the host, one sync)."""
    if t < 1:
        raise ValueError(f"row split needs t >= 1, got {t}")
    if isinstance(indptr, torch.Tensor):
        device = indptr.device if device is None else device
        indptr = indptr.cpu().numpy()
    ip = np.asarray(indptr, dtype=np.int64)
    deg = np.diff(ip)
    rows = np.flatnonzero(deg > t)
    n_chunks = (deg[rows] + t - 1) // t
    chunk_ptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(n_chunks, out=chunk_ptr[1:])
    owner = np.repeat(np.arange(len(rows)), n_chunks)
    begin = ip[rows][owner] + (np.arange(int(chunk_ptr[-1])) - chunk_ptr[owner]) * t
    end = np.minimum(begin + t, ip[rows + 1][owner])

    def to(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a if device is None else a.to(device)

    return RowSplit(t=int(t), num_rows=len(ip) - 1, num_edges=int(ip[-1]),
                    rows=to(rows.astype(np.int64)), chunk_ptr=to(chunk_ptr),
                    chunks=to(np.stack([begin, end], axis=1).reshape(-1, 2)),
                    counters=to(np.zeros(len(rows), np.int32)))
