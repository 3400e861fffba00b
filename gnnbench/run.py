"""One run of one benchmark cell on one card.

    python3 -m gnnbench --workload NAME --seed N --seconds S --trace 0|1

The cell is found by name in ``BENCHMARK.json`` (beside this package); its
configuration file, its traffic mix (``traffic/<mix>.json``, whose ``loop``
names the module ``loops/<loop>.py``), its model family
(``models/<family>.py`` and ``reference/<family>.py``), its limits
(``limits/<cell>.json``) and its per-layer metrics (``metrics/<name>.py``)
are each found by name, so a cell, a configuration, a mix or a metric is
added with files and entries alone.

A run, in order:

1. Set-up, timed from the process's start (``setup_s``): imports, the
   graph (generated once per checkout into ``.cache/``, then read), its
   build by the port, the features, masks and weights from ``--seed`` on
   the card, the first ``correct.STEPS`` training steps through the
   window's own call (their loss, first gradient and change are kept for
   the comparison; the first builds the port's kernels), and two more.
2. The window: steps for ``--seconds``, dispatched ahead, one synchronise
   at the end. ``epoch_ms`` is its wall time over the epochs it completed;
   ``train_samples_per_s`` the seeds it trained over its wall time.
   ``--trace 1`` then times one step's enqueue after a synchronise, and
   profiles a stretch of steps (``trace.py``), and reports the per-layer
   metrics instead of the end-to-end ones.
3. ``peak_mem_gib`` from the card's allocator peak; the program's state is
   freed; the plain reference follows the same first steps from the same
   inputs (``loops/<loop>.py:reference``) and ``correct.py`` compares.
4. The numbers compared, each with its limit, on standard error; the result
   as the last line of standard output.

No JAX: a run whose process holds ``jax``, ``jaxlib``, ``flax``, ``optax``
or ``dgl_tpu`` (whole top-level names) once the window has closed prints
what it found and no result, and exits 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch

from gnnbench import correct, counts, data, trace
from gnnbench.reference import common

__all__ = ["Cell", "load_spec", "make_cell", "capture", "run_cell", "main", "ISOLATED",
           "foreign_modules"]

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)
ISOLATED = ("jax", "jaxlib", "flax", "optax", "dgl_tpu")
WARM_STEPS = 2  # steps after the compared ones, before the window
ENQUEUE_STEPS = 30  # steps whose enqueue the traced run times
PROFILE_SECONDS = 2.0  # the profiled stretch's length, in unprofiled step time
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    graph: data.GraphData
    family: ModuleType
    loop: ModuleType


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(root: str, spec: dict, workload: str):
    """The cell's entry, its configuration, traffic and limits, and the
    end-to-end and per-layer metric entries it reports."""
    entry = _by_name(spec["workloads"], workload, "workload")
    conf = _by_name(spec["configs"], entry["config"], "config")
    cfg = _load_json(os.path.join(root, conf["file"]))
    traffic = _load_json(os.path.join(root, "gnnbench", "traffic", f"{entry['traffic']}.json"))
    limits = _load_json(os.path.join(root, "gnnbench", "limits", f"{workload}.json"))

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or workload in m["workloads"]]

    return entry, cfg, traffic, limits, mine(spec["end_to_end"]), mine(spec["per_layer"])


def metric_reader(root: str, name: str):
    """``gnnbench/metrics/<name>.py``'s ``read`` under ``root``, loaded from
    its path (names hold dots)."""
    path = os.path.join(root, "gnnbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gnnbench_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def foreign_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that a run must not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in ISOLATED)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def capture(prog, steps: int) -> common.Readings:
    """Drive the program's first ``steps`` steps through its own call and
    keep what the comparison reads: each loss, each leaf's first gradient as
    Adam got it (its first moment over ``1 - beta1``), each leaf's change."""
    named = list(prog.model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in named}
    beta1 = prog.opt.param_groups[0]["betas"][0]
    losses, grads = [], {}
    for s in range(steps):
        prog.step()
        losses.append(float(prog.last_loss))
        if s == 0:
            for k, p in named:
                state = prog.opt.state.get(p, {})
                grads[k] = (_norm(state["exp_avg"]) / (1.0 - beta1) if "exp_avg" in state
                            else 0.0)
    change = {k: _norm(p.detach() - p0[k]) for k, p in named}
    return common.Readings(losses, grads, change)


def _top(pairs: Dict[str, float], n: int = 10) -> List[list]:
    return [[k[:160], v] for k, v in sorted(pairs.items(), key=lambda kv: -kv[1])[:n]]


def make_cell(root: str, workload: str, seed: int, device: torch.device):
    """The cell's ``Cell`` (its graph loaded or generated), its entry, its
    limits and the metric entries it reports; sets the configuration's
    precision."""
    spec = load_spec(root)
    entry, cfg, traffic, limits, e2e, per_layer = resolve(root, spec, workload)
    family = importlib.import_module(f"gnnbench.models.{cfg['family']}")
    loop = importlib.import_module(f"gnnbench.loops.{traffic['loop']}")
    tf32 = bool(cfg["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    graph = data.load_graph(cfg["graph"])
    cell = Cell(workload, cfg, traffic, seed, device, graph, family, loop)
    return cell, entry, limits, e2e, per_layer


def run_cell(root: str, workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: Optional[float] = None,
             log=sys.stderr) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """Run the cell once; returns the result line's object and the rows
    ``(name, value, limit)`` compared. ``t_start``: the process's start on
    ``time.perf_counter``'s clock (default: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("start", t_start), ("entered", time.perf_counter())]
    cell, entry, limits, e2e, per_layer = make_cell(root, workload, seed, device)
    cfg, traffic, family, loop, graph = cell.cfg, cell.traffic, cell.family, cell.loop, cell.graph
    marks.append(("graph_loaded", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the context exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("card_ready", time.perf_counter()))
    prog = loop.Program(cell)
    prog.keep_steps = correct.STEPS
    marks.append(("program_built", time.perf_counter()))
    readings = capture(prog, correct.STEPS)
    marks.append(("compared_steps", time.perf_counter()))
    for _ in range(WARM_STEPS):
        prog.step()
    _sync(device)
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    phases = ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
    phases += " [program: " + ", ".join(f"{k} {v:.3f}" for k, v in prog.setup_phases.items()) + "]"

    done0, n = prog.done, 0
    t0 = time.perf_counter()
    while True:
        prog.step()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    wall = time.perf_counter() - t0
    units = prog.done - done0
    last_loss = float(prog.last_loss)
    step_s = wall / n

    profile, enqueue_s, launches, gathers = None, None, {}, []
    table = trace.KernelTable(os.path.join(root, "gnnbench", "kernels"))
    if traced:
        times = []
        for _ in range(ENQUEUE_STEPS):
            _sync(device)
            a = time.perf_counter()
            prog.step()
            times.append(time.perf_counter() - a)
        _sync(device)
        enqueue_s = sum(times) / len(times)
        n_prof = max(3, min(400, int(round(PROFILE_SECONDS / step_s))))
        kept = []

        def profiled_step():
            prog.step()
            mb = getattr(prog, "last_mb", None)
            if mb is not None:
                kept.append(mb.input_nodes)

        before = table.counters()
        profile = trace.profile_steps(profiled_step, n_prof, device, loop.SPANS)
        after = table.counters()
        launches = {k: (after[k] - before[k]) / n_prof for k in after}
        gathers = [(int(t.numel()), int(torch.unique(t).numel())) for t in kept]
        del kept
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    stats, record, graph_build_s = prog.stats(), prog.record(), prog.graph_build_s

    metrics: Dict[str, dict] = {}
    if not traced:
        values = {"setup_s": setup_s, "peak_mem_gib": peak / GIB,
                  "epoch_ms": step_s * 1e3 if prog.unit == "epoch" else None,
                  "train_samples_per_s": units / wall if prog.unit == "seed" else None}
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        if traffic["loop"] == "full":
            work = family.work_full(cfg, stats["nodes"], stats["edges"])
        else:
            b, fanouts = traffic["batch_size"], traffic["fanouts"]
            sizes = list(zip(common.block_sizes(b, fanouts), fanouts))
            sample_work, _ = counts.sampling(b, fanouts)
            rows = common.block_sizes(b, fanouts)[0] * (1 + fanouts[0])
            work = (family.work_blocks(cfg, sizes, stats["row_bytes"]) + sample_work
                    + counts.gather_rows(rows, stats["row_bytes"]))
        seen = trace.Traced(cfg, traffic, stats, step_s, profile, table, launches, work,
                            enqueue_s, graph_build_s, gathers)
        for m in per_layer:
            value = metric_reader(root, m["name"])(seen)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        print(json.dumps({"launches_per_step": launches, "profiled_steps": n_prof,
                          "work": dataclasses.asdict(work)}), flush=True)
    print(f"gnnbench: {workload} seed {seed}: setup {setup_s:.3f} s ({phases}; graph generated "
          f"{graph.generated_s:.3f} s, built {graph_build_s:.3f} s), window {n} steps in "
          f"{wall:.3f} s", file=log, flush=True)

    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref, extra = loop.reference(cell, record, steps=correct.STEPS)
    numbers, skipped = correct.gaps(readings, ref)
    numbers.update(extra)
    ok, rows = correct.judge(numbers, limits)
    ok = ok and math.isfinite(last_loss)
    if skipped:
        print(f"gnnbench: leaves left out of change_gap: {skipped}", file=log)

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": n, "failed": 0 if math.isfinite(last_loss) else 1,
              "metrics": metrics, "device": dev_info}
    if traced:
        dev_info["busy_s"] = profile.busy_s
        dev_info["window_s"] = profile.wall_s
        result["breakdown"] = {"device_ops": _top({k: v[0] for k, v in profile.kernels.items()}),
                               "idle_gaps": _top(profile.gaps)}
    result["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return result, rows


def main(argv=None, t_start: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gnnbench: no CUDA device: the benchmark runs on a card only", file=sys.stderr)
        return 2
    spec = load_spec(ROOT)
    chips = _by_name(spec["workloads"], args.workload, "workload")["chips"]
    if torch.cuda.device_count() < chips:
        print(f"gnnbench: {args.workload} needs {chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    result, rows = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), t_start=t_start)
    found = foreign_modules()
    if found:
        print(f"gnnbench: the run loaded {found}; nothing it loads may be JAX or dgl_tpu",
              file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
