"""The suite's kernel tier: the SpMM / SDDMM sweep (``bench_kernels``)."""
