"""The port's benchmark drivers, counterparts of the root ``benchmarks/``."""
