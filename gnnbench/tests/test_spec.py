"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
resolves to its file."""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from gnnbench.tests.conftest import PKG, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["gnnbench"] and spec["command"] == ["python3", "-m", "gnnbench"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_configs_resolve_to_their_files(spec):
    names = [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("gnnbench/") and c["name"] in used
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert cfg["model"]["in_feats"] == cfg["graph"]["feat_dim"]
        assert cfg["model"]["classes"] == cfg["graph"]["num_classes"]
        importlib.import_module(f"gnnbench.models.{cfg['family']}")
        importlib.import_module(f"gnnbench.reference.{cfg['family']}")


@pytest.mark.parametrize("index", range(2))
def test_cells_resolve_to_their_files(spec, index):
    w = spec["workloads"][index]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
    assert w["chips"] == 1
    with open(os.path.join(PKG, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    loop = importlib.import_module(f"gnnbench.loops.{traffic['loop']}")
    assert hasattr(loop, "Program") and hasattr(loop, "reference") and loop.SPANS
    with open(os.path.join(PKG, "limits", f"{w['name']}.json")) as f:
        limits = json.load(f)
    assert {"loss_gap", "loss_gap_first"} & set(limits)
    assert set(limits) <= {"loss_gap", "loss_gap_first", "grad_gap", "grad_gap_median",
                           "change_gap", "change_gap_median", "bad_samples"}
    reported = [m for m in spec["end_to_end"] + spec["per_layer"]
                if "workloads" not in m or w["name"] in m["workloads"]]
    e2e = {m["name"] for m in reported if m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(m in spec["per_layer"] for m in reported)


def test_cell_names_and_pairs_are_unique(spec):
    cells = spec["workloads"]
    assert [c["name"] for c in cells] == ["sage_products.full", "gat_arxiv.full"]
    pairs = [(c["config"], c["traffic"]) for c in cells]
    assert len(set(pairs)) == len(pairs)


def test_metrics_resolve_and_keep_to_the_contract(spec):
    cells = {c["name"] for c in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert set(e2e) == {"epoch_ms", "peak_mem_gib", "setup_s"}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e and m["source"] in SOURCES
        assert os.path.exists(os.path.join(PKG, "metrics", f"{m['name']}.py"))
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in cells and ("workloads" not in moved or cell in moved["workloads"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def test_layers_are_named_alike(spec):
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
