"""The port's table tools against the JAX ones (``tools/suite_table.py``,
``tools/render_kernel_sweep.py``, run as scripts): the same table rows on
one results fixture, with and without ``--merge`` (apart from the port's
``carried`` mark), and the same sweep tables on one CSV fixture."""

import json
import os
import subprocess
import sys

import numpy as np

from dgl_tpu_torch.benchmarks.generate_result import WORKLOADS
from dgl_tpu_torch.tools import render_kernel_sweep, suite_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _results(seed, names):
    rng = np.random.default_rng(seed)
    rows = []
    for i, name in enumerate(names):
        status = ["ok", "ok", "ok", "timeout", "exit 3"][i % 5]
        t = None if status == "exit 3" else float(rng.lognormal(-3, 2))
        rows.append({"workload": name, "status": status, "time_per_epoch": t,
                     "vs_dgl_v100": None, "final_train": None,
                     "final_test": None if i % 4 == 3 else round(float(rng.uniform(0, 100)), 2),
                     "wall_s": 1.0, "date": f"2026-10-{10 + seed:02d}",
                     "note": "runs capped 10->1" if i % 3 == 0 else None})
    return rows


def _write(path, rows):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "results.json"), "w") as f:
        json.dump(rows, f)
    return path


def _jax_table(tmp_path, results_dir, *extra):
    out = tmp_path / "jax.md"
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "suite_table.py"),
                    str(results_dir), "--out", str(out), *extra], check=True, cwd=ROOT,
                   capture_output=True, timeout=120)
    return out.read_text()


def _rows(md):
    return [ln for ln in md.splitlines() if ln.startswith("| ")]


def test_table_rows_equal_the_jax_tool(tmp_path):
    names = [w[0] for w in WORKLOADS]
    cur = _write(str(tmp_path / "cur"), _results(1, names))
    port = suite_table.main([cur, "--card", CARD])
    assert _rows(port) == _rows(_jax_table(tmp_path, cur))
    assert len(_rows(port)) == 1 + len(WORKLOADS)
    assert f"`{CARD}`" in port and "2026-10-11" in port


def test_merged_table_equals_the_jax_tool_but_for_the_carried_mark(tmp_path):
    names = [w[0] for w in WORKLOADS]
    cur = _write(str(tmp_path / "cur"), _results(2, names[:18]))  # the last six only before
    prev = _results(3, names[4:])
    prev_path = str(tmp_path / "prev.json")
    with open(prev_path, "w") as f:
        json.dump(prev, f)
    port = _rows(suite_table.main([cur, "--merge", prev_path, "--card", CARD]))
    jax = _rows(_jax_table(tmp_path, cur, "--merge", prev_path))
    carried = {r["workload"]: r["status"] for r in prev if r["workload"] in names[18:]}
    assert len(port) == len(jax) == 1 + len(WORKLOADS)
    for p, j in zip(port, jax):
        name = p.split(" | ")[0][2:]
        if name in carried:  # the JAX tool keeps the earlier status
            assert p == j.replace(f"| {carried[name]} |", "| carried |"), (p, j)
        else:
            assert p == j
    # the merge keeps the lower epoch time and carries the earlier date
    assert any("carried" in ln for ln in port)


def test_a_workload_no_run_has_stands_as_missing(tmp_path):
    cur = _write(str(tmp_path / "cur"), _results(4, ["cora_sage", "reddit_gat"]))
    rows = _rows(suite_table.main([cur, "--card", CARD]))
    assert len(rows) == 1 + len(WORKLOADS)
    assert sum("| missing |" in ln for ln in rows) == len(WORKLOADS) - 2
    assert "| ppa_gcn | - | - | - | - | missing |" in "\n".join(rows)


def _sweep_csv(path, port_columns, seed=5):
    rng = np.random.default_rng(seed)
    head = "dataset,kind,op,hidden,seconds,sol_pct"
    lines = [head + (",plain_seconds,library_seconds" if port_columns else "")]
    for ds in ("reddit", "ogbn-arxiv"):
        for kind, op in (("spmm", "copy_lhs.sum"), ("sddmm", "add")):
            for h in (1, 2, 4, 8, 16, 32, 64) if ds == "reddit" else (1, 4, 128):
                row = f"{ds},{kind},{op},{h},{rng.lognormal(-8, 1)},{rng.uniform(0, 30):.1f}"
                if port_columns:
                    lib = "None" if kind == "sddmm" and h == 1 else rng.lognormal(-7, 1)
                    row += f",{rng.lognormal(-7, 1)},{lib}"
                lines.append(row)
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _tables(md):
    return md[md.index("## "):].rstrip("\n").split("\n")


def test_sweep_tables_equal_the_jax_tool(tmp_path):
    for port_columns in (False, True):
        csv_path = _sweep_csv(tmp_path / f"sweep{port_columns}.csv", port_columns)
        jax_out, port_out = tmp_path / "jax_sweep.md", tmp_path / f"port{port_columns}.md"
        subprocess.run([sys.executable, os.path.join(ROOT, "tools", "render_kernel_sweep.py"),
                        csv_path, str(jax_out)], check=True, cwd=ROOT, capture_output=True,
                       timeout=120)
        render_kernel_sweep.main([csv_path, str(port_out)])
        jax, port = _tables(jax_out.read_text()), _tables(port_out.read_text())
        if not port_columns:
            assert port == jax
            continue
        # the JAX rows, then the plain and library ms the port's CSV adds
        assert [ln for ln in port if not ln.startswith(("| plain ms", "| library ms"))] == jax
        assert sum(ln.startswith("| plain ms") for ln in port) == 4
        assert "| library ms | — | " in "\n".join(port)  # a None library time


def test_sweep_keeps_the_notes_above_the_tables(tmp_path):
    csv_path = _sweep_csv(tmp_path / "sweep.csv", True)
    out = tmp_path / "KERNEL_SWEEP.md"
    out.write_text("# notes\n\nwritten by hand\n\n<!-- tables -->\n\n## stale table\n")
    text = render_kernel_sweep.main([csv_path, str(out)])
    assert text.startswith("# notes\n\nwritten by hand\n\n<!-- tables -->\n\n## ogbn-arxiv")
    assert "stale" not in text and out.read_text() == text
    fresh = render_kernel_sweep.main([csv_path, str(tmp_path / "new.md")])
    assert "3.35 TB/s" in fresh and "819" not in fresh
