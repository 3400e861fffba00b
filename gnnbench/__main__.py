"""``python3 -m gnnbench --workload NAME --seed N --seconds S --trace 0|1``."""

import os
import sys
import time

_T = time.perf_counter()
_HERE = os.path.dirname(os.path.abspath(__file__))


def _process_age_s() -> float:
    """Seconds since this process started (Linux's /proc), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    # the caches any library of the run compiles into live at fixed paths in
    # the checkout (the port's own nvcc builds are in dgl_tpu_torch/kernels/_build)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = os.path.join(_HERE, ".cache", sub)
    # one host thread for the CPU's parallel regions: the run's host work is
    # dispatch, and idle worker threads spinning beside it make it uneven
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if sys.dont_write_bytecode:
        # without it every run compiles each module it imports from source,
        # torch's too (about 16 s of set-up): its bytecode is written once
        # per checkout into a fixed directory of it, and read by later runs
        sys.pycache_prefix = os.path.join(_HERE, ".cache", "pyc")
        sys.dont_write_bytecode = False
    _START = _T - _process_age_s()
    from gnnbench.run import main

    raise SystemExit(main(t_start=_START))
