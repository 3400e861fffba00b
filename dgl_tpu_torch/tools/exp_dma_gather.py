"""Probe: how fast can the card gather rows, ``out[i] = x[idx[i]]``?

Counterpart of the JAX package's ``tools/exp_dma_gather.py``, with the same
flags, inputs and lines. It times PyTorch's own gather (``index_select``,
the counterpart of XLA's ``x[idx]``), the same gather split in four, P1
(``row_gather_async``: one async copy per row into shared memory, tiles 128
and 256) and P2 (``row_gather_smem``: x wholly in each block's shared
memory, tiles 512 and 2048), each with its rows per second and its largest
difference from ``x[idx]``. P2 takes only an x of at most 227 KB; above that
its wrapper refuses before any launch, and the line says FAILED. Two lines
of the port's own follow: P1 in source order (``row_gather_by_source``,
each row of x read once) with the plan of idx built beforehand, and the
plan's build (``gather_plan``: a sort of idx and its row split), its
maxerr that of a gather through the plan it built.

    python -m dgl_tpu_torch.tools.exp_dma_gather [--n 169343 --d 256 --e 2332486]
                                                 [--dtype float32|bfloat16] [--device cuda]

The defaults are ogbn-arxiv's bidirected scale. Inputs come from seed 0 with
numpy, as in the JAX tool; the indices are padded with 0 to a multiple of
512. Each line is the mean of 6 calls after 2 cold ones: CUDA events on the
card, the host clock on the CPU (``--device cpu``, where every gather is the
plain ``x[idx]``).
"""

from __future__ import annotations

import argparse
import statistics
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.row_gather import (
    gather_plan,
    row_gather_async,
    row_gather_by_source,
    row_gather_plain,
    row_gather_smem,
)
from ..train.timing import event_times_ms, time_fn

__all__ = ["main"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def timed(fn, device: torch.device, reps: int = 6, cold: int = 2) -> float:
    """Seconds per call of ``fn``, the mean of ``reps`` calls after ``cold``."""
    if device.type == "cuda":
        return statistics.mean(event_times_ms(fn, reps=reps, warmup=cold)) / 1e3
    return time_fn(fn, reps=reps, warmup=cold, device=device)


def make_inputs(n: int, d: int, e: int, dtype: torch.dtype, device: torch.device):
    """The JAX tool's x and its indices, padded to a multiple of 512."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    e_pad = -(-e // 512) * 512
    idx = np.concatenate([rng.integers(0, n, e), np.zeros(e_pad - e)]).astype(np.int32)
    return x.to(device), torch.from_numpy(idx).to(device)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run the probe, print its lines and return them as dicts (``name``,
    ``tile``, and ``ms``, ``rows_per_s``, ``maxerr``, or ``failed``). On the
    card P1 in index order launches 18 times (per tile: 1 checked call, 2
    cold, 6 timed), P2 18 or none, P1 in source order 10 (9 for its line,
    1 to check the plan line's plan)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=169343)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--e", type=int, default=2332486)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    dt = DTYPES[args.dtype]
    x, idx = make_inputs(args.n, args.d, args.e, dt, dev)
    e_pad = idx.shape[0]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"n={args.n} d={args.d} e={e_pad} dtype={args.dtype} "
          f"row={args.d * x.element_size()}B device={name}", flush=True)

    ref = row_gather_plain(x, idx)
    results = []

    def report(label, key, tile, fn, out):
        err = (out.float() - ref.float()).abs().max().item()
        t = timed(fn, dev)
        print(f"{label} {t*1e3:8.2f} ms  {e_pad/t/1e6:8.1f} M rows/s  maxerr={err:.1e}", flush=True)
        results.append({"name": key, "tile": tile, "ms": t * 1e3, "rows_per_s": e_pad / t,
                        "maxerr": err})

    gather = lambda: x.index_select(0, idx)  # noqa: E731
    report("index_select gather: ", "index_select", None, gather, gather())

    def split4():
        k = e_pad // 4
        return torch.cat([x.index_select(0, idx[j * k:(j + 1) * k]) for j in range(4)])

    report("index_select split4: ", "split4", None, split4, split4())

    for tile in (128, 256):
        report(f"async gather tile={tile:4d}:", "row_gather_async", tile,
               lambda: row_gather_async(x, idx, tile=tile), row_gather_async(x, idx, tile=tile))

    for tile in (512, 2048):
        try:  # only P2's own refusal, raised before any launch, is reported and passed over
            out = row_gather_smem(x, idx, tile=tile)
        except ValueError as ex:
            print(f"smem gather tile={tile}: FAILED {type(ex).__name__}: {ex}", flush=True)
            results.append({"name": "row_gather_smem", "tile": tile,
                            "failed": f"{type(ex).__name__}: {ex}"})
            continue
        report(f"smem gather tile={tile:4d}: ", "row_gather_smem", tile,
               lambda: row_gather_smem(x, idx, tile=tile), out)

    plan = gather_plan(idx, args.n)
    report("async gather by source:", "row_gather_by_source", None,
           lambda: row_gather_by_source(x, *plan), row_gather_by_source(x, *plan))
    build = lambda: gather_plan(idx, args.n)  # noqa: E731
    report("by-source plan build: ", "gather_plan", None, build, row_gather_by_source(x, *build()))
    return results


if __name__ == "__main__":
    main()
