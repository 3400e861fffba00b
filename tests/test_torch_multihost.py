"""Process start-up from the ``DGL_TPU_*`` variables, as
``tests/test_multihost.py`` runs it for the JAX package: four real
processes (gloo on the CPU) join through ``parallel.multihost.initialize``
with no arguments, lay the ranks out as a (2, 2) ``global_mesh``, shard a
graph's edges over its ``graph`` axis and hold the all-reduced ``gspmm``
mean to the one-process result. Also the start-up's refusals."""

import os
import socket
import subprocess
import sys

import pytest
import torch

from dgl_tpu_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "from dgl_tpu_torch.parallel.checks import multihost_main; multihost_main()"


def test_four_processes_form_a_two_by_two_mesh_and_reproduce_the_spmm():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(4):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   DGL_TPU_COORDINATOR=f"127.0.0.1:{port}", DGL_TPU_NUM_PROCESSES="4",
                   DGL_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    coords = set()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
        assert "multihost spmm OK" in out
        coords.add(out.split(" at ")[1].split(" of ")[0])
    assert coords == {"(0, 0)", "(0, 1)", "(1, 0)", "(1, 1)"}


def test_initialize_needs_the_address_count_and_id(monkeypatch):
    for var in ("DGL_TPU_COORDINATOR", "DGL_TPU_NUM_PROCESSES", "DGL_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize(backend="gloo", device="cpu")
    with pytest.raises(TypeError):
        multihost.initialize("127.0.0.1:1", 1, 0)  # the backend is never picked here


def test_nccl_refuses_ranks_that_would_share_a_card():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
        multihost.check_backend("nccl", "cuda", cards + 1)
    with pytest.raises(ValueError, match="runs on CUDA devices"):
        multihost.check_backend("nccl", "cpu", 1)
    multihost.check_backend("gloo", "cpu", 8)  # the CPU takes any number of gloo ranks
