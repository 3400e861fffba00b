"""Timers with the reference's benchmark conventions.

* epoch wallclock with warmup-skip (3 epochs for full-graph training),
  synchronised with the device after every epoch;
* phase-split wallclock;
* per-call device time of a function, from CUDA events;
* a ``torch.profiler`` window over training steps.

PyTorch returns before the card finishes, so every host-clock interval here
ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

from ..device import DeviceLike, resolve_device

__all__ = ["EpochTimer", "PhaseTimer", "op_time", "time_fn", "event_times_ms", "synchronize",
           "device_profile"]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EpochTimer:
    def __init__(self, warmup: int = 3, device: DeviceLike = None):
        self.warmup = warmup
        self.device = resolve_device(device)
        self.durations: List[float] = []
        self._epoch = 0
        self._t0 = None

    def start(self):
        if self._epoch >= self.warmup:
            self._t0 = time.perf_counter()

    def stop(self):
        synchronize(self.device)
        if self._t0 is not None:
            self.durations.append(time.perf_counter() - self._t0)
            self._t0 = None
        self._epoch += 1

    @property
    def mean(self) -> float:
        return sum(self.durations) / max(len(self.durations), 1)


class PhaseTimer:
    """Accumulate wallclock per named phase within an epoch loop. A phase
    ends in a device synchronise unless ``sync=False``: then it measures
    the host's time in it (for a step, the time to enqueue its kernels),
    and the loop it is in stays free of host syncs."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.totals: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        yield
        if sync:
            synchronize(self.device)
        self.totals[name] += time.perf_counter() - t0

    def summary(self) -> str:
        return ", ".join(f"{k}: {v:.4f}s" for k, v in self.totals.items())


@contextlib.contextmanager
def op_time(out: List[float]):
    """Append the seconds the block takes to ``out``. A block that puts its
    result in the yielded dict's ``"result"`` is timed until the card has
    finished it."""
    t0 = time.perf_counter()
    holder: Dict[str, object] = {}
    yield holder
    if "result" in holder and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    out.append(time.perf_counter() - t0)


def time_fn(fn: Callable, *args, reps: int = 10, warmup: int = 2, device: DeviceLike = None) -> float:
    """Average seconds per call, cold start skipped."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    synchronize(dev)
    return (time.perf_counter() - t0) / reps


def event_times_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> List[float]:
    """Device milliseconds of each of ``reps`` calls of ``fn`` on the current
    CUDA stream, after ``warmup`` calls; one pair of CUDA events per call."""
    for _ in range(warmup):
        fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def device_profile(step: Callable[[], object], epochs: int, device: torch.device,
                   unit: str = "epoch") -> dict:
    """Run ``step`` ``epochs`` more times under ``torch.profiler``: wall
    time, device busy time, the kernels by device time and the host's
    operators by their own CPU time (``host_ops``, the top 12), each per
    call of ``step``, which the keys name ``unit`` (a full-graph epoch is
    one step; a graph-classification driver profiles single train steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(epochs):
            step()
        synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / epochs
    # device-side events only: the CPU ops that launched them carry the
    # same time again; a user annotation's range on the device timeline
    # (the optimiser's step) spans kernels that are counted on their own
    per = f"per_{unit}"
    rows = [
        {"name": ev.key, f"calls_{per}": ev.count / epochs,
         f"device_ms_{per}": ev.self_device_time_total / 1e3 / epochs}
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.count > 0
        and not getattr(ev, "is_user_annotation", False)
    ]
    rows.sort(key=lambda r: -r[f"device_ms_{per}"])
    busy_ms = sum(r[f"device_ms_{per}"] for r in rows)
    host = [
        {"name": ev.key, f"calls_{per}": ev.count / epochs,
         f"self_cpu_ms_{per}": ev.self_cpu_time_total / 1e3 / epochs}
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CPU and ev.count > 0
    ]
    host.sort(key=lambda r: -r[f"self_cpu_ms_{per}"])
    return {f"{unit}s": epochs, f"wall_ms_{per}": wall_ms, f"device_busy_ms_{per}": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "kernels": rows,
            "host_ops": host[:12]}
