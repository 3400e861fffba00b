"""Probes of the card, run as modules (``python -m dgl_tpu_torch.tools.<name>``):
``exp_dma_gather``, the row-gather probe of P1 and P2."""
