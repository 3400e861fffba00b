"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program. Names are compared whole: ``dgl_tpu_torch`` is not
``dgl_tpu``."""

from __future__ import annotations

import json
import subprocess
import sys
import types

from gnnbench import run
from gnnbench.tests.conftest import REPO


def _tops_after(code: str) -> list:
    script = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops_after("import gnnbench.reference.common, gnnbench.reference.sage, "
                       "gnnbench.reference.gat, gnnbench.counts, gnnbench.correct, gnnbench.data")
    assert "dgl_tpu_torch" not in tops and not set(tops) & set(run.ISOLATED)


def test_a_run_loads_no_jax(tiny_root):
    tops = _tops_after("import torch\nfrom gnnbench import run\n"
                       f"run.run_cell({tiny_root!r}, 'tiny_gat.full', 3, 0.2, True, "
                       "torch.device('cpu'))\nassert run.foreign_modules() == []")
    assert "dgl_tpu_torch" in tops and not set(tops) & set(run.ISOLATED)


def test_names_are_compared_whole(monkeypatch):
    for name in ("dgl_tpu_torch_like", "jaxfoo", "flaxen", "optax_x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "dgl_tpu.graph", types.ModuleType("dgl_tpu.graph"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.foreign_modules() == ["dgl_tpu", "jax"]
