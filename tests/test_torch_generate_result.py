"""The port's suite harness against the JAX one
(``benchmarks/generate_result.py``, loaded by path: it imports no JAX at
module level): the same rows in the same order, baselines, regexes and
smoke arguments, ``parse_output`` equal on seeded texts in the port
drivers' line formats, the full arguments the JAX ones without the TPU
flags and the caps the rows' notes name, every row's arguments parsed by
its driver's ``parser()``; two smoke rows end to end on the CPU; a child's
failure and time limit."""

import importlib
import importlib.util
import json
import os
import textwrap

import numpy as np
import pytest

from dgl_tpu_torch.benchmarks import generate_result as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_result", os.path.join(ROOT, "benchmarks", "generate_result.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = _load_jax_harness()
JAX_ROWS = {w[0]: w for w in JAX.WORKLOADS}
# the flags of the JAX rows that the port's full rows drop, each with the
# number of values it takes: the TPU's lane plans, dispatches, fetch interval
# and frozen cluster cache, and bf16 messages (main_sage takes them; its
# products row runs float32, the precision of its V100 baseline)
TPU_FLAGS = {"--lane-kernel": 0, "--lane-force": 0, "--bf16-messages": 0, "--scan-epochs": 1,
             "--scan-steps": 0, "--scan-iters": 0, "--fetch-every": 1, "--freeze-clusters": 0}


def _strip(args, flags):
    """``args`` without each flag of ``flags`` and its values."""
    out, i = [], 0
    while i < len(args):
        if args[i] in flags:
            i += 1 + flags[args[i]]
        else:
            out.append(args[i])
            i += 1
    return out


def test_rows_baselines_regexes_and_smoke_arguments_are_the_jax_harness():
    assert [w[0] for w in port.WORKLOADS] == [w[0] for w in JAX.WORKLOADS]
    assert len(port.WORKLOADS) == 24
    assert port.BASELINE_EPOCH_S == JAX.BASELINE_EPOCH_S
    for name in ("TIME_RE", "FINAL_TEST_RE", "FINAL_TRAIN_RE", "SPEED_RE"):
        assert getattr(port, name).pattern == getattr(JAX, name).pattern, name
    for name, module, suites, opts in port.WORKLOADS:
        jax_row = JAX_ROWS[name]
        jax_opts = jax_row[3] if len(jax_row) > 3 else {}
        assert suites["smoke"] == jax_row[2]["smoke"], name
        assert bool(opts.get("no_eval")) == bool(jax_opts.get("no_eval")), name
        # the same driver: the JAX script's path, as the port's module
        assert module.endswith(jax_row[1][:-3].replace("/", ".")), (name, module)


def test_full_arguments_are_the_jax_ones_without_tpu_flags_and_the_noted_caps():
    for name, _, suites, opts in port.WORKLOADS:
        dropped = opts.get("dropped_caps", [])
        want = _strip(JAX_ROWS[name][2]["full"], {**TPU_FLAGS, **{f: 1 for f in dropped}})
        assert suites["full"] == want, name
        for flag in dropped:  # each dropped cap stands in the row's note
            assert flag in opts["note"], (name, flag)


def test_no_row_carries_a_tpu_flag():
    for name, _, suites, _ in port.WORKLOADS:
        for suite, args in suites.items():
            assert not set(args) & set(TPU_FLAGS), (name, suite)


@pytest.mark.parametrize("suite", ["smoke", "full"])
def test_every_row_parses_under_its_drivers_parser(suite):
    for name, module, suites, opts in port.WORKLOADS:
        driver = importlib.import_module(module)
        cmd = port.command(module, suites[suite], not opts.get("no_eval"), "cpu", 2)
        assert cmd[1:3] == ["-m", module]
        args = driver.parser().parse_args(cmd[3:])
        assert args.device == "cpu" and args.profile == 2, name
        if not opts.get("no_eval"):
            assert args.eval, name
        if name in ("reddit_sage", "products_sage") and suite == "full":
            assert args.no_precompute, name  # the reference never hoists


def _texts(seed):
    """Seeded stdout in each driver family's formats (``common.py``'s
    Logger, ``main_gcn``, ``gcmc``, ``pipeline.py``, ``cluster_gcn_lp``)."""
    rng = np.random.default_rng(seed)
    times = [str(np.float64(v)) for v in rng.lognormal(-4, 2, rng.integers(1, 25))]
    acc = lambda: f"{rng.uniform(0, 100):.2f}"  # noqa: E731
    full_graph = [f"Training time/epoch {t}" for t in times]
    full_graph += [f"Run {r:02d} | Epoch {e:05d} | Loss 0.5 | Train 0.9 | Val 0.8 | Test 0.7"
                   for r in range(2) for e in range(3)]
    full_graph += ["Run 01:", f"Highest Train: {acc()}", f"Highest Valid: {acc()}",
                   f"  Final Train: {acc()}", f"   Final Test: {acc()}", "All runs:",
                   f"Highest Train: {acc()} ± 1.00", f"  Final Train: {acc()} ± 0.50",
                   f"   Final Test: {acc()} ± 0.25"]
    gcmc = [f"Iter={i}, loss=1.0, valid_rmse=0.9, best_valid=0.9, best_test=0.95"
            for i in range(3)]
    rmse = rng.uniform(0.7, 1.2, 2)
    gcmc += [f"Training time/iter {times[-1]}",
             f"Best valid RMSE: {rmse[0]:.4f}  Test RMSE: {rmse[1]:.4f}"]
    ns = [f"Epoch {e:05d} | Step {s:05d} | Loss 1.2 | Train Acc 0.5 | Speed (samples/sec) "
          f"{rng.uniform(1e3, 1e6):.4f} | GPU 123.4 MiB" for e in range(3) for s in (0, 20)]
    ns += [f"Epoch Time(s): {t}" for t in times[:3]]
    ns += ["Eval Acc 0.9000", "Test Acc: 0.8900", f"Avg epoch time: {times[0]}"]
    lp = [f"Training time/epoch {t}" for t in times]
    lp += ["Run: 01, Epoch: 01, Loss: 0.6931, Train: 0.1000, Valid: 0.1100, Test MRR: 0.1200"]
    return ["\n".join(full_graph), "\n".join(gcmc), "\n".join(ns), "\n".join(lp),
            "\n".join(full_graph[:3]), "no lines here"]


@pytest.mark.parametrize("seed", range(6))
def test_parse_output_equals_the_jax_harness(seed):
    for text in _texts(seed):
        assert port.parse_output(text) == JAX.parse_output(text), text


def test_two_smoke_rows_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    """cora_sage (--eval injected) and gcmc_ml100k (no_eval)."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "out"
    rows = port.main(["--suite", "smoke", "--only", "gcmc_ml100k,cora_sage", "--device", "cpu",
                      "--out", str(out), "--retries", "0"])
    assert [r["workload"] for r in rows] == ["cora_sage", "gcmc_ml100k"]  # the suite's order
    for r in rows:
        assert r["status"] == "ok", r
        assert r["time_per_epoch"] > 0 and r["final_test"] is not None
    assert rows[0]["vs_dgl_v100"] == round(0.0039 / rows[0]["time_per_epoch"], 2)
    assert rows[0]["final_train"] is not None and rows[1]["vs_dgl_v100"] is None
    with open(out / "results.json") as f:
        records = json.load(f)
    assert [list(r) for r in records] == [port.COLUMNS] * 2
    assert records[0]["final_test"] == rows[0]["final_test"]
    with open(out / "results.csv") as f:
        assert f.readline().strip() == ",".join(port.COLUMNS)
    md = (out / "results.md").read_text()
    assert md.startswith("| workload | status |") and "| gcmc_ml100k | ok |" in md
    assert md in capsys.readouterr().out


FAKE = textwrap.dedent("""
    import sys, time
    print("Training time/epoch 0.25")
    print("Training time/epoch 0.75")
    print("# profile=" + '{"kernels": [{"name": "csr_spmm_kernel"}]}', file=sys.stderr)
    if "--fail" in sys.argv:
        print("Traceback (most recent call last):", file=sys.stderr)
        print("RuntimeError: boom", file=sys.stderr)
        sys.exit(3)
    if "--hang" in sys.argv:
        time.sleep(60)
""")


@pytest.fixture
def fake_driver(tmp_path, monkeypatch):
    (tmp_path / "fake_suite_driver.py").write_text(FAKE)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.delenv("PYTHONUNBUFFERED", raising=False)  # the harness sets it
    return "fake_suite_driver"


def test_a_failed_child_is_reported_with_its_stderr_tail(fake_driver):
    res = port.run_one(fake_driver, ["--fail"], timeout=60, device="cpu")
    assert res["status"] == "exit 3"
    assert res["stderr_tail"].endswith("RuntimeError: boom")
    assert res["time_per_epoch"] == 0.5
    ok = port.run_one(fake_driver, [], timeout=60, device="cpu")
    assert ok["status"] == "ok" and "stderr_tail" not in ok
    assert ok["profile"] == {"kernels": [{"name": "csr_spmm_kernel"}]}


def test_a_child_past_its_time_limit_keeps_its_printed_times(fake_driver):
    """The child's stdout is unbuffered, so the lines printed before the
    limit reach the harness."""
    res = port.run_one(fake_driver, ["--hang"], timeout=3, device="cpu")
    assert res["status"] == "timeout"
    assert res["time_per_epoch"] == 0.5
    assert res["stderr_tail"] == ("timeout; last stdout: Training time/epoch 0.25 | "
                                  "Training time/epoch 0.75")


def test_an_unknown_workload_is_refused():
    with pytest.raises(SystemExit, match="unknown workloads"):
        port.main(["--only", "citeseer_sage", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown workloads"):
        port.main(["--only", "", "--device", "cpu"])  # not every row
