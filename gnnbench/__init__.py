"""The benchmark of ``dgl_tpu_torch`` on one NVIDIA H100 (see ``run.py``).

Importing the package loads nothing heavy; ``python3 -m gnnbench`` runs one
cell once.
"""
