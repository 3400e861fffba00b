"""The readings the limits of ``limits/<cell>.json`` are set from.

    python3 -m gnnbench.control --workload NAME --seeds 1,2,3 [--out FILE]

For each seed, in one process, at the cell's own size: the program's first
``correct.STEPS`` steps against the reference (in float64, as a run
compares them: the lower readings), and sides in the program's place,
each against the same reference:

* ``f32``: the reference in float32, the configuration's precision (the
  witness of how well each number is conditioned in float32);
* ``tf32``: the reference in float32 with its GEMMs in TF32, the precision
  below the configuration's float32 with TF32 off (the control);
* ``half_batch``: the float32 reference taking its loss over every second
  train node or seed only (the fault of a step that leaves half its batch
  out);
* ``unchanged``: a step that leaves the state as it was reads 1 in
  ``change_gap`` by construction (no run).

One JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from gnnbench import correct
from gnnbench.run import ROOT, capture, make_cell

__all__ = ["readings", "main"]


def readings(root: str, workload: str, seed: int, device: torch.device) -> dict:
    cell, _, limits, _, _ = make_cell(root, workload, seed, device)
    t0 = time.perf_counter()
    prog = cell.loop.Program(cell)
    prog.keep_steps = correct.STEPS
    prog_r = capture(prog, correct.STEPS)
    record = prog.record()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref, extra = cell.loop.reference(cell, record, steps=correct.STEPS)
    t2 = time.perf_counter()
    out = {"workload": workload, "seed": seed, "program_s": t1 - t0, "reference_s": t2 - t1,
           "limits": limits}
    lower, skipped = correct.gaps(prog_r, ref)
    lower.update(extra)
    out["program"], out["skipped"] = lower, skipped
    keys = sorted(ref.grad_norms)
    out["program_leaves"] = {
        "grad": correct.leaf_gaps(prog_r.grad_norms, ref.grad_norms, keys),
        "change": correct.leaf_gaps(prog_r.change_norms, ref.change_norms,
                                    [k for k in keys if k not in skipped]),
        "ref_grad": ref.grad_norms, "ref_change": ref.change_norms}
    f32 = {"dtype": torch.float32}
    for side, kw in (("f32", f32), ("tf32", {**f32, "tf32": True}),
                     ("half_batch", {**f32, "half_batch": True})):
        other, _ = cell.loop.reference(cell, record, steps=correct.STEPS, **kw)
        out[side] = correct.gaps(other, ref)[0]
    out["unchanged"] = {"change_gap": 1.0}
    out["losses"] = {"program": prog_r.losses, "reference": ref.losses}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="readings of the program, the control and the faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--out", default=None, help="append the JSON lines to this file too")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gnnbench.control: no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        line = json.dumps(readings(ROOT, args.workload, int(s), torch.device("cuda", 0)))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
