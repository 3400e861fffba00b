"""The port stands alone: no JAX, nothing of the JAX package and nothing of
its ``tools/``; and no pandas, which the card's machine does not have."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dgl_tpu", "tools", "pandas"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "dgl_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_covers_the_gat_slice():
    """The walk reaches the driver and probe subpackages and every kernel's
    wrapper."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("dgl_tpu_torch/benchmarks/common.py",
                "dgl_tpu_torch/benchmarks/node_classification/main_gat.py",
                "dgl_tpu_torch/graph/transforms.py", "dgl_tpu_torch/ops/gather.py",
                "dgl_tpu_torch/ops/softmax.py", "dgl_tpu_torch/models/gat.py",
                "dgl_tpu_torch/tools/exp_dma_gather.py"):
        assert rel in scanned, rel
    csrc = os.path.join(ROOT, "dgl_tpu_torch", "kernels", "csrc")
    kernels = sorted(n[:-3] for n in os.listdir(csrc) if n.endswith(".cu"))
    assert kernels == ["csr_spmm", "gat_attention", "row_gather", "seg_sum"]
    for name in kernels:  # each CUDA source has its Python wrapper in the scan
        assert f"dgl_tpu_torch/kernels/{name}.py" in scanned, name


def test_importing_every_module_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib, dgl_tpu_torch\n"
        "for m in pkgutil.walk_packages(dgl_tpu_torch.__path__, 'dgl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(len([m for m in sys.modules if m.startswith('dgl_tpu_torch')]), bad)\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 30, r.stdout


def test_scan_covers_the_sage_driver_and_graph_classification():
    """The walk reaches the SAGE driver and every module of graph
    classification, the new ``sampling`` subpackage included."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("dgl_tpu_torch/benchmarks/node_classification/main_sage.py",
                "dgl_tpu_torch/benchmarks/graph_classification/main_gcn.py",
                "dgl_tpu_torch/graph/batch.py", "dgl_tpu_torch/sampling/dataloader.py",
                "dgl_tpu_torch/nn/pooling.py", "dgl_tpu_torch/nn/encoders.py",
                "dgl_tpu_torch/models/gcn_graph.py", "dgl_tpu_torch/ops/sddmm.py",
                "dgl_tpu_torch/ops/segment.py"):
        assert rel in scanned, rel


def test_scan_covers_the_rgcn_slice_and_the_kernel_sweep():
    """The walk reaches the relation ops, RGCN's layer, model and driver,
    and the kernel sweep's subpackage; the drivers' copies of the JAX
    drivers' numpy helpers (masked_bce, mean_multilabel_auc) live in the
    scanned benchmarks/common.py."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("dgl_tpu_torch/ops/rel.py", "dgl_tpu_torch/models/rgcn.py",
                "dgl_tpu_torch/benchmarks/node_classification/main_rgcn.py",
                "dgl_tpu_torch/kernel/__init__.py", "dgl_tpu_torch/kernel/bench_kernels.py",
                "dgl_tpu_torch/benchmarks/common.py", "dgl_tpu_torch/convert.py"):
        assert rel in scanned, rel


def test_scan_covers_the_sampling_slice():
    """The walk reaches the samplers, the native bindings and the NS
    drivers; the samplers' C++ source sits beside its bindings."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("dgl_tpu_torch/sampling/neighbor.py", "dgl_tpu_torch/sampling/device.py",
                "dgl_tpu_torch/csrc/native.py",
                "dgl_tpu_torch/benchmarks/sampling/pipeline.py",
                "dgl_tpu_torch/benchmarks/sampling/ns_sage.py",
                "dgl_tpu_torch/benchmarks/sampling/ns_gat.py"):
        assert rel in scanned, rel
    assert os.path.exists(os.path.join(ROOT, "dgl_tpu_torch", "csrc", "graph_ops.cpp"))


def test_scan_covers_the_cluster_slice():
    """The walk reaches the partitioner, the cluster iterator, the link
    predictors and both cluster drivers; the partitioner's and the
    extractor's C++ sits beside its bindings."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("dgl_tpu_torch/graph/partition.py", "dgl_tpu_torch/graph/transforms.py",
                "dgl_tpu_torch/sampling/cluster.py", "dgl_tpu_torch/nn/predictors.py",
                "dgl_tpu_torch/benchmarks/sampling/cluster_sage.py",
                "dgl_tpu_torch/benchmarks/link_prediction/__init__.py",
                "dgl_tpu_torch/benchmarks/link_prediction/cluster_gcn_lp.py"):
        assert rel in scanned, rel
    with open(os.path.join(ROOT, "dgl_tpu_torch", "csrc", "graph_ops.cpp")) as f:
        src = f.read()
    for fn in ("node_subgraph", "partition_lp", "partition_multilevel", "build_csr"):
        assert f" {fn}(" in src, fn


def test_scan_covers_the_distribution_slice():
    """The walk reaches every module of ``parallel`` (the halo exchange,
    the edge-sharded SpMM, data parallelism, start-up and the launcher),
    the checkpoint manager and the drivers' sharded path."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in ("__init__", "comm", "multihost", "launch", "spmd", "halo", "halo_train", "dp",
                 "checks"):
        assert f"dgl_tpu_torch/parallel/{name}.py" in scanned, name
    for rel in ("dgl_tpu_torch/train/checkpoint.py",
                "dgl_tpu_torch/benchmarks/node_classification/sharded.py"):
        assert rel in scanned, rel


def test_scan_covers_the_suite_harness():
    """The walk reaches the harness and its two table tools, which import
    the harness's tables from the port, not from ``tools/``."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("dgl_tpu_torch/benchmarks/generate_result.py",
                "dgl_tpu_torch/tools/suite_table.py",
                "dgl_tpu_torch/tools/render_kernel_sweep.py"):
        assert rel in scanned, rel
    with open(os.path.join(ROOT, "dgl_tpu_torch", "tools", "suite_table.py")) as f:
        assert "from ..benchmarks.generate_result import" in f.read()
