"""The traced run's readings: a profiled stretch of steps, read from the
profiler's trace, and what the per-layer metric readers see.

``profile_steps`` runs steps under ``torch.profiler`` (host and device
activity), exports its trace to a temporary file, reads it and deletes it:

* busy time: the union of the device's kernels, copies and sets;
* device time by kernel name;
* device time by the benchmark's span in which each device operation was
  launched (the launch is matched to its operation by the trace's
  correlation id);
* idle gaps: each gap between device operations, named by what the host was
  doing when it launched the operation that ended the gap (the innermost
  benchmark span and the outermost host operator there).

The profiled stretch's wall time is inflated by the profiler's own host
work, so shares of a step are taken against the step time of the
unprofiled window of the same run (``Traced.step_s``).
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import importlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from gnnbench import counts

__all__ = ["Profile", "profile_steps", "parse_events", "KernelTable", "Traced"]

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Profile:
    steps: int
    wall_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]  # name: (device seconds, calls)
    span_device_s: Dict[str, float]
    gaps: Dict[str, float]  # what the host was doing: idle device seconds


def _covering(intervals: List[Tuple[float, float, str]], starts: List[float], t: float):
    """The shortest interval of ``intervals`` (sorted by start) that covers t."""
    best = None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, -1, -1):
        a, b, name = intervals[j]
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
        if t - a > 60e6:  # spans last seconds at most
            break
    return None if best is None else best[2]


def _outermost(ops: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    out, end = [], -1.0
    for a, b, name in sorted(ops, key=lambda o: (o[0], -o[1])):
        if a >= end:
            out.append((a, b, name))
            end = b
    return out


def parse_events(events: Sequence[dict], steps: int, wall_s: float,
                 spans: Sequence[str]) -> Profile:
    """A ``Profile`` from a chrome trace's events (microsecond times)."""
    dev, launch, span_iv, ops = [], {}, [], []
    span_names = set(spans)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in _DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "?"), corr))
        elif cat in _LAUNCH_CATS and corr is not None:
            launch[corr] = ts
        elif cat == "user_annotation" and e.get("name") in span_names:
            span_iv.append((ts, ts + dur, e["name"]))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, e.get("name", "?")))
    span_iv.sort()
    span_starts = [s[0] for s in span_iv]
    top = _outermost(ops)
    top_starts = [o[0] for o in top]

    def host_at(t: Optional[float]) -> Tuple[str, str]:
        if t is None:
            return "untraced", ""
        span = _covering(span_iv, span_starts, t) or "outside spans"
        i = bisect.bisect_right(top_starts, t) - 1
        op = top[i][2] if i >= 0 and top[i][0] <= t <= top[i][1] else ""
        return span, op

    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    by_span: Dict[str, float] = defaultdict(float)
    for a, b, name, corr in dev:
        kernels[name][0] += (b - a) * 1e-6
        kernels[name][1] += 1
        by_span[host_at(launch.get(corr))[0]] += (b - a) * 1e-6
    dev.sort(key=lambda d: d[0])
    busy, gaps = 0.0, defaultdict(float)
    cur_a = cur_b = None
    for a, b, name, corr in dev:
        if cur_b is None:
            cur_a, cur_b = a, b
        elif a > cur_b:
            busy += cur_b - cur_a
            span, op = host_at(launch.get(corr))
            gaps[f"{span}: {op}" if op else span] += (a - cur_b) * 1e-6
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    return Profile(steps, wall_s, busy * 1e-6, {k: (v[0], int(v[1])) for k, v in kernels.items()},
                   dict(by_span), dict(gaps))


def profile_steps(step: Callable[[], None], steps: int, device: torch.device,
                  spans: Sequence[str]) -> Profile:
    """Run ``step`` ``steps`` times under the profiler and read its trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(prefix="gnnbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return parse_events(events, steps, wall, spans)


class KernelTable:
    """The port's kernels, one JSON file each under ``gnnbench/kernels/``:
    ``{"names": [substrings of the device kernel's name], "counters":
    ["module:attribute.path", ...]}``, found by the file's name (K1, K3, ...)."""

    def __init__(self, directory: str):
        self.entries = {}
        for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
            with open(path) as f:
                self.entries[os.path.splitext(os.path.basename(path))[0]] = json.load(f)

    def owner(self, kernel_name: str) -> Optional[str]:
        for kid, entry in self.entries.items():
            if any(s in kernel_name for s in entry["names"]):
                return kid
        return None

    def counters(self) -> Dict[str, int]:
        """Every listed launch counter's value now (0 where it is missing)."""
        out = {}
        for entry in self.entries.values():
            for ref in entry.get("counters", []):
                module, _, attr = ref.partition(":")
                try:
                    obj = importlib.import_module(module)
                    for part in attr.split("."):
                        obj = getattr(obj, part)
                    out[ref] = int(obj)
                except (ImportError, AttributeError, TypeError, ValueError):
                    out[ref] = 0
        return out


@dataclasses.dataclass
class Traced:
    """What a per-layer metric reader sees (seconds unless named)."""

    cfg: dict
    traffic: dict
    stats: Dict[str, int]  # the loop's shapes: nodes, edges, batch, row_bytes
    step_s: float  # unprofiled window: seconds a step
    profile: Profile
    table: KernelTable
    launches: Dict[str, float]  # counter: launches a step in the profiled stretch
    work: counts.Work  # the step's model work
    host_enqueue_s: Optional[float]
    graph_build_s: float
    gathers: List[Tuple[int, int]]  # ns: (rows, distinct rows) of each profiled step's gather

    @property
    def steps(self) -> int:
        return self.profile.steps

    def device_s(self, kernel_id: str) -> float:
        """Device seconds of one of the port's kernels over the stretch."""
        return sum(s for name, (s, _) in self.profile.kernels.items()
                   if self.table.owner(name) == kernel_id)

    def device_total_s(self) -> float:
        return sum(s for s, _ in self.profile.kernels.values())

    def own_s(self) -> float:
        """Device seconds of every kernel the port wrote itself."""
        return sum(s for name, (s, _) in self.profile.kernels.items()
                   if self.table.owner(name) is not None)
