"""Build the JAX package's native graph library once, before any test runs.

``dgl_tpu/csrc/native.py`` compiles ``graph_ops.cpp`` at first use straight
into ``dgl_tpu/csrc/_build/libgraph_ops.so`` and trusts any file it finds
there. When several test workers start on a checkout without that library,
one compiles while another opens the half-written file: ``dlopen`` fails
with "file too short", and that worker falls back to the NumPy versions
for the rest of its session, so tests that need the native partitioner or
CSR builder fail in it. Every worker imports this module while it collects
tests, before any test runs, so building here, one worker at a time under
a file lock, leaves a whole library for all of them.
"""

import fcntl
import os

from dgl_tpu.csrc import native


def _build_under_lock() -> None:
    os.makedirs(os.path.dirname(native._SO_PATH), exist_ok=True)
    with open(native._SO_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        native._compile()


_build_under_lock()


def test_native_graph_library_loads():
    assert native.get_lib() is not None
