"""The port's hand-written CUDA kernels, one module per kernel:
``csr_spmm`` (K1), ``seg_sum`` (K2), ``gat_attention`` (K3) and
``row_gather`` (P1 in index and in source order, P2), each with its plain
PyTorch version and launch counter; ``build`` compiles them.
Import from the modules (``from dgl_tpu_torch.kernels.seg_sum import
seg_sum``)."""
