"""The result line and the harness's refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gnnbench import run
from gnnbench.tests.conftest import PKG, REPO

CPU = torch.device("cpu")


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(tiny_root, traced):
    result, rows = run.run_cell(tiny_root, "tiny_sage.tiny_ns", 77, 0.3, traced, CPU)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared" and ("breakdown" in keys) == traced
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ({"busy_s", "window_s"} <= set(dev)) == traced
    spec = run.load_spec(tiny_root)
    _, _, _, _, e2e, per_layer = run.resolve(tiny_root, spec, "tiny_sage.tiny_ns")
    wanted = per_layer if traced else e2e
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(result["metrics"]) <= set(units)
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if not traced:
        assert set(result["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    assert [r[0] for r in rows] == list(result["compared"])
    json.dumps(result)


def test_no_card_exits_without_a_result(capsys):
    assert not torch.cuda.is_available()
    rc = run.main(["--workload", "sage_products.full", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA device" in out.err


def test_a_tree_without_the_program_exits_without_a_result(tmp_path):
    shutil.copytree(PKG, tmp_path / "gnnbench", ignore=shutil.ignore_patterns(".cache",
                                                                              "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "gnnbench", "--workload", "sage_products.full",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
