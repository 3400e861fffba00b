"""Spans and launch records inside the port, kept only while ``torch.profiler``
records.

Tracing is on exactly while a ``torch.profiler`` / ``torch.autograd.profiler``
session records: each call reads torch's own state once
(``torch.autograd.profiler._is_profiler_enabled``). There is no other switch.
Off, ``span`` returns one shared no-op context and ``launch`` returns at once:
nothing is timed, allocated or appended, and no ``record_function`` is
entered (a bare one costs microseconds of host time even with no profiler).

On:

* ``span(name)`` enters ``torch.profiler.record_function(name)``, so the span
  shows in the profiler's trace as a ``user_annotation`` event on the
  profiler's clock, and keeps a ``Span``: its name, its host start and end
  (``time.perf_counter_ns``), its thread, and the index in ``spans()`` of its
  parent, the innermost span open on the same thread (autograd runs a CUDA
  backward on a thread of its own, so each thread keeps its own stack). Every
  name starts with ``dgl_tpu_torch.``, which keeps them apart from the names
  of a caller's own spans.
* ``launch(kernel, pass_, ...)`` appends one ``Launch`` for a kernel launch:
  the shapes it ran at, read from its operands, and the host time of the
  wrapper that made it, from the wrapper's entry to its return. That is the
  duration of the innermost span open on the thread (the wrapper's own),
  which the record takes when that span closes.

The byte and operation counts of a launch are not kept here: a reader counts
them from the shapes, with counts of its own.

``spans()`` and ``launches()`` return the lists themselves: what one
profiling session recorded. The lists are kept only under torch's own
profiler, which holds its events until it stops; under ``emit_nvtx`` or
``emit_itt``, which hand each range on at once, a span enters its
``record_function`` and keeps nothing. A session starts, and both lists are
emptied, at the first call of the port that finds the profiler on after a
call found it off: between two sessions the port runs unprofiled steps (or
none: sessions that follow each other with no call of the port between
them, as a schedule's cycles with no wait and no warm-up do, are kept as
one). ``clear()`` empties both at any time; a span opened before it is
nobody's parent after it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional

import torch
from torch._C._autograd import _profiler_type
from torch._C._profiler import ActiveProfilerType
from torch.autograd import profiler as _profiler

__all__ = ["Span", "Launch", "span", "launch", "spans", "launches", "clear"]


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int  # -1 while open
    parent: int  # index in spans() of the enclosing span on this thread, -1 for none
    thread: int  # threading.get_ident()


@dataclasses.dataclass
class Launch:
    kernel: str  # K1, K2, K3, K3N (K3's node passes), P1, P2
    # K1 "spmm", K2 "seg_sum", K3 "fwd" / "b2", K3N "scores" / "score_grad" / "vector_grad",
    # P1 "index" / "source", P2 "smem"
    pass_: str
    rows: int  # rows the launch walks: CSR rows, or output rows of an index-order gather
    src_rows: int  # rows of the operand it gathers from
    edges: int  # edges (gathered rows) it reads
    d: int  # width of a row (a head's, where it has heads)
    heads: int
    value_bytes: int  # one value of the rows' type (K3 b2: v's type, which grad_v takes)
    index_bytes: int  # one offset of indptr (index order: one index)
    weighted: bool  # K1: edge weights read beside the rows
    dropout: bool  # attention dropout on (keep < 1)
    span: int  # index in spans() of the wrapper's span (its parent names the caller), -1 for none
    host_ns: Optional[int] = None  # the wrapper's host time, set when its span closes


_spans: List[Span] = []
_launches: List[Launch] = []
_lock = threading.Lock()
_local = threading.local()
_OFF = contextlib.nullcontext()
_KEEPING = ActiveProfilerType.KINETO  # the profiler that holds its events until it stops
_UNSEEN = ActiveProfilerType.NONE
_session = 0  # the lists' session: a span opened in another is nobody's parent
_keeping = False  # whether the last call found the profiler on and keeping


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep() -> bool:
    """While a profiler records: whether to keep what is recorded (torch's
    own profiler, not nvtx or itt); the first call that keeps after one that
    did not starts a session. A thread the profiler does not follow (its
    type reads none there) keeps where the session's other threads keep."""
    global _keeping
    kind = _profiler_type()
    if kind == _KEEPING:
        if not _keeping:
            clear()
            _keeping = True
        return True
    if kind != _UNSEEN:
        _keeping = False
    return _keeping


def _owner(stack: list):
    """The innermost span open on this thread, if it is of this session."""
    return stack[-1] if stack and stack[-1]._session == _session else None


class _Open:
    """An open span: its ``record_function`` range and, where the profiler
    keeps its events, its ``Span``."""

    __slots__ = ("_name", "_keep", "_rf", "_span", "_index", "_session", "_launch")

    def __init__(self, name: str, keep: bool):
        self._name, self._keep = name, keep
        self._launch = None

    def __enter__(self):
        self._rf = _profiler.record_function(self._name)
        self._rf.__enter__()
        if not self._keep:
            return self
        stack = _stack()
        owner = _owner(stack)
        self._span = Span(self._name, 0, -1, -1 if owner is None else owner._index,
                          threading.get_ident())
        with _lock:
            self._session, self._index = _session, len(_spans)
            _spans.append(self._span)
        stack.append(self)
        self._span.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._keep:
            end = time.perf_counter_ns()
            self._span.end_ns = end
            if self._launch is not None:
                self._launch.host_ns = end - self._span.start_ns
            _stack().pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that, while a profiler records, is a ``record_function``
    range named ``name`` and a ``Span``; otherwise one shared no-op."""
    global _keeping
    if not _profiler._is_profiler_enabled:
        _keeping = False
        return _OFF
    return _Open(name, _keep())


def launch(kernel: str, pass_: str, indptr: Optional[torch.Tensor], edges: torch.Tensor,
           x: torch.Tensor, *, value_dtype: Optional[torch.dtype] = None,
           weighted: bool = False, dropout: bool = False) -> None:
    """Record one launch of ``kernel`` while a profiler records.

    ``indptr``: the offsets the launch walks (one a row, plus one), or None
    for a gather in index order (one row an index of ``edges``). ``edges``:
    the tensor whose first dimension counts the launch's edges (a CSR's
    indices, K2's messages, a gather's indices or output). ``x``: the rows it
    reads, (N, D) or (N, H, D); ``value_dtype`` stands for x's type where the
    pass's bound counts another (K3 b2: v's)."""
    global _keeping
    if not _profiler._is_profiler_enabled:
        _keeping = False
        return
    if not _keep():
        return
    n_edges = edges.shape[0]
    if indptr is None:
        rows, index_bytes = n_edges, edges.element_size()
    else:
        rows, index_bytes = indptr.shape[0] - 1, indptr.element_size()
    owner = _owner(_stack())
    rec = Launch(kernel, pass_, rows, x.shape[0], n_edges, x.shape[-1],
                 x.shape[1] if x.dim() == 3 else 1,
                 (value_dtype or x.dtype).itemsize, index_bytes, weighted, dropout,
                 -1 if owner is None else owner._index)
    if owner is not None:
        owner._launch = rec
    with _lock:
        _launches.append(rec)


def spans() -> List[Span]:
    return _spans


def launches() -> List[Launch]:
    return _launches


def clear() -> None:
    """Empty both lists."""
    global _session
    with _lock:
        _spans.clear()
        _launches.clear()
        _session += 1
