"""Spawn k local ranks, run one function in each, and collect the results.

JAX runs ``--shard k`` as one process over k devices; a torch program runs
one process per rank, and this launcher starts them: the drivers'
``--shard``, ``chip_smoke.py`` and the tests share it.

* Processes start with the ``spawn`` method, since the parent may already
  hold a CUDA context. ``spawn`` pickles the function by its module path,
  so it must be a module-level function of an importable module.
* The ranks meet through a ``file://`` store in a new temporary directory
  (no port to pick, so parallel launches never collide).
* Each rank calls ``multihost.initialize`` and then ``fn(device, *args)``;
  its return value comes back to the parent, pickled.
* The wait has a time limit. When one rank fails, its traceback is raised
  in the parent and the other ranks are killed (they may be blocked in a
  collective with it); at the time limit every rank is killed. Nothing is
  left running when ``spawn`` returns or raises.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch.distributed as dist

from . import multihost

__all__ = ["spawn", "RankFailed"]


class RankFailed(RuntimeError):
    """A rank raised; the message holds its traceback."""


def _rank_main(fn, rank, world, init_method, backend, device, args, results):
    try:
        dev = multihost.initialize(init_method, world, rank, backend=backend, device=device)
        out = fn(dev, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        sys.stdout.flush()
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=30)


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), *, backend: str,
          device: str, timeout: float) -> List[Any]:
    """Run ``fn(device, *args)`` on ``nprocs`` ranks of one new process
    group and return their results in rank order.

    ``backend`` and ``device`` go to ``multihost.initialize`` (checked here
    first, before any process starts); ``timeout`` bounds the whole run in
    seconds. Raises ``RankFailed`` with the first failing rank's traceback,
    ``TimeoutError`` at the limit.
    """
    multihost.check_backend(backend, device, nprocs)
    ctx = mp.get_context("spawn")
    store = tempfile.mkdtemp(prefix="dgl_tpu_torch_launch_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, nprocs, f"file://{store}/store", backend,
                                                  device, tuple(args), results))
             for r in range(nprocs)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} ranks did not finish within {timeout} s "
                                   f"(done: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:  # ended without a report (killed, or died in C code)
                    time.sleep(0.5)  # a report sent just before the end is still on its way
                    if results.empty():
                        raise RankFailed(f"rank {dead[0]} exited with code "
                                         f"{procs[dead[0]].exitcode} and no report")
                continue
            if not ok:
                raise RankFailed(f"rank {rank} of {nprocs} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    return [out[r] for r in range(nprocs)]
