"""Render the suite's results table from a ``generate_result`` output.

Counterpart of ``tools/suite_table.py``: the rows of ``results.json`` in the
suite's order, each beside its V100 DGL baseline
(``benchmarks/generate_result.py:BASELINE_EPOCH_S``) and their ratio.
``--merge PREV.json`` keeps the lower epoch time of the two runs for each
workload, and the previous test score where the new run has none, and
carries over the workloads only the previous file has. A carried-over row is
marked ``carried`` in the status column and keeps its date; the JAX table
carries it as it was. A workload of the suite that no run has stands as
``missing``, so the table always has every row. The header names the
card and its power limit (``nvidia-smi``) in place of the TPU pool's health
probe, which is not ported.

    python -m dgl_tpu_torch.tools.suite_table RESULTS_DIR [--merge PREV.json]
        [--card "NAME, LIMIT"] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import List, Optional

from ..benchmarks.generate_result import BASELINE_EPOCH_S, WORKLOADS

ORDER = ["cora_sage", "pubmed_sage", "reddit_sage", "arxiv_sage",
         "products_sage", "cora_gat", "pubmed_gat", "reddit_gat", "arxiv_gat",
         "proteins_rgcn", "enzymes_gcn", "molhiv_gcn", "ppa_gcn",
         "gcmc_ml100k", "ns_sage_reddit", "ns_gat_reddit",
         "cluster_sage_products", "cluster_gat_products", "cluster_lp_arxiv"]


def merge(rows: List[dict], prev: List[dict]) -> List[dict]:
    """The JAX tool's merge; the rows only ``prev`` has come back marked
    ``carried``."""
    prev = {r["workload"]: r for r in prev}
    for r in rows:
        p = prev.get(r["workload"])
        if p and p.get("time_per_epoch") and (
            not r.get("time_per_epoch")
            or p["time_per_epoch"] < r["time_per_epoch"]
        ):
            r["time_per_epoch"] = p["time_per_epoch"]
        if p and p.get("final_test") and not r.get("final_test"):
            r["final_test"] = p["final_test"]
    have = {r["workload"] for r in rows}
    return rows + [dict(p, status="carried") for w, p in prev.items() if w not in have]


def with_missing(rows: List[dict]) -> List[dict]:
    have = {r["workload"] for r in rows}
    return rows + [{"workload": w[0], "status": "missing"} for w in WORKLOADS if w[0] not in have]


def table_lines(rows: List[dict]) -> List[str]:
    lines = [
        "| workload | epoch (s) | V100 DGL baseline (s) | ratio | "
        "final test (synthetic) | status | note |",
        "|---|---|---|---|---|---|---|",
    ]
    order = {w: i for i, w in enumerate(ORDER)}
    for r in sorted(rows, key=lambda r: order.get(r["workload"], 99)):
        t = r.get("time_per_epoch")
        base = BASELINE_EPOCH_S.get(r["workload"])
        ratio = f"{base / t:.2f}x" if (base and t) else "-"
        lines.append(
            "| {} | {} | {} | {} | {} | {} | {} |".format(
                r["workload"],
                f"{t:.4f}" if t else "-",
                base if base else "-",
                ratio,
                r.get("final_test") if r.get("final_test") is not None else "-",
                r.get("status", "?"),
                r.get("note") or "",
            )
        )
    return lines


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return out.strip().splitlines()[0]


def render(rows: List[dict], card_line: str) -> str:
    dates = sorted({r["date"] for r in rows if r.get("date")})
    header = [
        "# Full-protocol suite results on one NVIDIA H100",
        "",
        f"`{card_line}` (`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`); "
        "recorded " + (", ".join(dates) if dates else time.strftime("%Y-%m-%d")) + ".",
        "",
        "`python -m dgl_tpu_torch.benchmarks.generate_result --suite full`: the reference "
        "protocol (each driver's epoch count, `--eval` accuracy, the mean of the last 10 "
        "`Training time/epoch` lines; the rows' caps are in their notes). Where runs were "
        "merged, each row keeps its "
        "lower epoch time; `carried` marks a row only an earlier run has. Accuracies are on "
        "the synthetic data and show that the stack learns, not parity with the published "
        "ones.",
        "",
    ]
    return "\n".join(header + table_lines(rows)) + "\n"


def main(argv: Optional[list] = None) -> str:
    ap = argparse.ArgumentParser(description="suite table (dgl_tpu_torch)")
    ap.add_argument("results_dir")
    ap.add_argument("--out", default=None, help="write markdown here")
    ap.add_argument("--merge", default=None,
                    help="previous results.json; keep per-workload min epoch time")
    ap.add_argument("--card", default=None,
                    help="the card's name and power limit (default: nvidia-smi's)")
    args = ap.parse_args(argv)

    with open(os.path.join(args.results_dir, "results.json")) as f:
        rows = json.load(f)
    if args.merge:
        with open(args.merge) as f:
            rows = merge(rows, json.load(f))
    md = render(with_missing(rows), args.card or card())
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
        print("wrote", args.out)
    else:
        print(md)
    return md


if __name__ == "__main__":
    main()
