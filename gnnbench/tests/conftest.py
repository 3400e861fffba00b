"""A benchmark tree with tiny cells, for the CPU tests.

``tiny_root`` copies ``BENCHMARK.json`` and the data files under
``gnnbench/`` into a temporary directory and adds, as files and entries
only, two configurations cut to a few hundred nodes (``tiny_sage``,
``tiny_gat``: the real configurations' families, widths and training
settings on a small synthetic graph) and a traffic mix of the ``ns`` loop
(``tiny_ns``), with a cell of each configuration under ``full`` and
``tiny_ns``. The tiny cells take the limits of the real cell of their
family and loop (``limits/sage_products.ns.json`` for the sampled ones),
and the sampled ones the sampled loop's metrics, added where
``BENCHMARK.json`` has no sampled cell. The harness reads data files from
that tree and runs its own code.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = os.path.join(REPO, "gnnbench")

TINY = {"tiny_sage": "sage_products", "tiny_gat": "gat_arxiv"}
REAL_CELL = {("tiny_sage", "full"): "sage_products.full", ("tiny_gat", "full"): "gat_arxiv.full",
             ("tiny_sage", "tiny_ns"): "sage_products.ns", ("tiny_gat", "tiny_ns"): "sage_products.ns"}


# the sampled loop's metrics, whose readers are in gnnbench/metrics/
NS_METRICS = [("step_mfu.ns", "%", "train step"), ("p1_roofline", "%", "feature gather (P1)"),
              ("sample_device_ms", "ms", "sampling"), ("host_enqueue_ms", "ms", "host dispatch"),
              ("device_idle_pct.ns", "%", "device")]


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(base: str) -> str:
    root = os.path.join(base, "root")
    shutil.copytree(PKG, os.path.join(root, "gnnbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for name, real in TINY.items():
        with open(os.path.join(PKG, "configs", f"{real}.json")) as f:
            cfg = json.load(f)
        cfg["name"] = name
        cfg["graph"].update(num_nodes=500, num_edges=3000, bidirected_edges=6000,
                            dataset=f"{name} (tiny)")
        cfg["graph"].pop("community", None)
        cfg["reduced"] = ["graph"]
        _dump(cfg, os.path.join(root, "gnnbench", "configs", f"{name}.json"))
        spec["configs"].append({"name": name, "source": cfg["source"],
                                "file": f"gnnbench/configs/{name}.json", "reduced": ["graph"],
                                "why": "the CPU tests' size"})
    _dump({"loop": "ns", "batch_size": 40, "fanouts": [2, 3, 4], "replace": True},
          os.path.join(root, "gnnbench", "traffic", "tiny_ns.json"))
    for (cfg_name, traffic), real in REAL_CELL.items():
        cell = f"{cfg_name}.{traffic}"
        spec["workloads"].append({"name": cell, "config": cfg_name, "traffic": traffic,
                                  "chips": 1, "why": "the CPU tests' size"})
        shutil.copy(os.path.join(PKG, "limits", f"{real}.json"),
                    os.path.join(root, "gnnbench", "limits", f"{cell}.json"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    ns_cells = [f"{c}.{t}" for c, t in REAL_CELL if t == "tiny_ns"]
    have = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    if "train_samples_per_s" not in have:
        spec["end_to_end"].append({"name": "train_samples_per_s", "unit": "samples/s",
                                   "better": "higher", "bound": 0.25, "source": "host_clock",
                                   "workloads": ns_cells})
    for name, unit, layer in NS_METRICS:
        if name not in have:
            spec["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                      "source": "device_trace", "layer": layer,
                                      "moves": "train_samples_per_s", "workloads": ns_cells})
    _dump(spec, os.path.join(root, "BENCHMARK.json"))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("gnnbench")))
