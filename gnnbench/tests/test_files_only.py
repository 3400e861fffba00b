"""A configuration, a traffic mix of an existing loop and a per-layer
metric, each added as files and BENCHMARK.json entries only, are found and
run."""

from __future__ import annotations

import json
import os

import torch

from gnnbench.run import run_cell
from gnnbench.tests.conftest import make_root


def test_new_config_traffic_and_metric_as_files_only(tmp_path):
    root = make_root(str(tmp_path))
    pkg = os.path.join(root, "gnnbench")
    with open(os.path.join(pkg, "configs", "tiny_sage.json")) as f:
        cfg = json.load(f)
    cfg.update(name="wide_sage")
    cfg["model"].update(hidden=32, layers=2)
    cfg["graph"].update(num_nodes=400, num_edges=2500, data_seed=5)
    with open(os.path.join(pkg, "configs", "wide_sage.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pkg, "traffic", "two_hop.json"), "w") as f:
        json.dump({"loop": "ns", "batch_size": 25, "fanouts": [3, 5], "replace": True}, f)
    with open(os.path.join(pkg, "limits", "wide_sage.two_hop.json"), "w") as f:
        json.dump({"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2, "bad_samples": 0}, f)
    with open(os.path.join(pkg, "metrics", "graph_build_ms.py"), "w") as f:
        f.write('"""graph_build_ms: the graph build, in ms."""\n\n\n'
                "def read(t):\n    return 1e3 * t.graph_build_s\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "wide_sage", "source": cfg["source"],
                            "file": "gnnbench/configs/wide_sage.json", "reduced": ["graph"],
                            "why": "a second width"})
    spec["workloads"].append({"name": "wide_sage.two_hop", "config": "wide_sage",
                              "traffic": "two_hop", "chips": 1, "why": "two hops"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("wide_sage.two_hop")
    spec["per_layer"].append({"name": "graph_build_ms", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "graph build",
                              "moves": "setup_s", "workloads": ["wide_sage.two_hop"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    res, _ = run_cell(root, "wide_sage.two_hop", 8, 0.3, False, torch.device("cpu"))
    assert res["correct"] and set(res["metrics"]) == {"train_samples_per_s", "peak_mem_gib",
                                                      "setup_s"}
    res, _ = run_cell(root, "wide_sage.two_hop", 9, 0.3, True, torch.device("cpu"))
    assert res["correct"] and set(res["metrics"]) == {"graph_build_ms"}
