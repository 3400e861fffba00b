"""Render the kernel sweep's tables from a ``bench_kernels --csv`` file.

Counterpart of ``tools/render_kernel_sweep.py``: one table per (dataset,
kind, op), widths 1–128 across, the kernel route's ms and SOL % down, as
the JAX tool lays them out. The port's CSV also has ``plain_seconds`` and
``library_seconds``; where a row has them, the table gains the plain
version's and the library call's ms. SOL % is against the H100's 3.35 TB/s.

The output's text above the line ``<!-- tables -->`` is kept (the notes
written by hand); without that line a short header is written first.

    python -m dgl_tpu_torch.tools.render_kernel_sweep SWEEP.csv [OUT.md]
"""

from __future__ import annotations

import csv
import os
import sys
from collections import defaultdict
from typing import List, Optional

FEAT_SIZES = [2 ** x for x in range(8)]
MARK = "<!-- tables -->"
HEADER = [
    "# SpMM / SDDMM kernel sweep on the H100",
    "",
    "`python -m dgl_tpu_torch.kernel.bench_kernels --csv PATH`, the reference's "
    "`kernel/dgl-new.py` protocol: hidden 1..128, 2 cold runs, then the mean of 10. "
    "`SOL%` = the least HBM traffic of the op / (time x 3.35 TB/s).",
    "",
]


def _ms(v: str) -> str:
    return f"{float(v) * 1e3:.2f}" if v not in (None, "", "None") else "—"


def _sol(v: str) -> str:
    """One decimal, as the JAX sweep writes it; the port's CSV keeps all."""
    return f"{float(v):.1f}" if v not in (None, "", "None") else "—"


def tables(rows: List[dict]) -> List[str]:
    # (dataset, kind, op) -> {hidden: row}
    table = defaultdict(dict)
    for r in rows:
        table[(r["dataset"], r["kind"], r["op"])][int(r["hidden"])] = r
    lines = []
    for (ds, kind, op), vals in sorted(table.items()):
        lines.append(f"## {ds} — {kind} ({op})")
        lines.append("")
        lines.append("| hidden | " + " | ".join(str(h) for h in FEAT_SIZES) + " |")
        lines.append("|---|" + "---|" * len(FEAT_SIZES))
        body = [("ms", "seconds"), ("SOL%", "sol_pct"), ("plain ms", "plain_seconds"),
                ("library ms", "library_seconds")]
        for label, key in body:
            if key not in ("seconds", "sol_pct") and not any(v.get(key) not in (None, "", "None")
                                                            for v in vals.values()):
                continue
            cells = [label]
            for h in FEAT_SIZES:
                v = vals.get(h)
                if v is None:
                    cells.append("—")
                elif key == "sol_pct":
                    cells.append(_sol(v.get(key)))
                else:
                    cells.append(_ms(v.get(key)))
            lines.append("| " + " | ".join(cells) + " |")
        lines.append("")
    return lines


def main(argv: Optional[list] = None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0]
    out = argv[1] if len(argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kernel", "KERNEL_SWEEP.md")
    with open(path) as f:
        rows = list(csv.DictReader(f))
    head = HEADER
    if os.path.exists(out):
        with open(out) as f:
            kept = f.read()
        if MARK in kept:
            head = kept[:kept.index(MARK)].rstrip("\n").split("\n") + [""]
    body = tables(rows)
    text = "\n".join(head + [MARK, ""] + body) + "\n"
    with open(out, "w") as f:
        f.write(text)
    n = len({(r["dataset"], r["kind"], r["op"]) for r in rows})
    print(f"wrote {out}: {n} sweeps")
    return text


if __name__ == "__main__":
    main()
