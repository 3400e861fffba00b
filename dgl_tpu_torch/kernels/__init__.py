from .csr_spmm import csr_spmm, csr_spmm_plain

__all__ = ["csr_spmm", "csr_spmm_plain"]
