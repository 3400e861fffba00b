"""Node-classification dataset loading: canonical npz, then synthetic.

Search order: ``<root>/<name>.npz`` (keys src, dst, x, y, train, val,
test, optional ef) → the structurally matched synthetic generator
(``synthetic.py``), which caches its arrays under ``root``. The data root is
``$DGL_TPU_DATA_DIR`` or ``<repo>/.data_cache``, shared with the JAX
package so both read the same files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .synthetic import NodeClassificationData, synthetic_node_classification

__all__ = ["data_root", "load_node_dataset"]


def data_root() -> str:
    return os.environ.get(
        "DGL_TPU_DATA_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), ".data_cache"),
    )


def _load_canonical_npz(path: str, name: str) -> NodeClassificationData:
    z = np.load(path)
    return NodeClassificationData(
        name=name,
        src=z["src"],
        dst=z["dst"],
        num_nodes=int(z["x"].shape[0]),
        features=z["x"],
        labels=z["y"],
        train_mask=z["train"],
        val_mask=z["val"],
        test_mask=z["test"],
        num_classes=int(z["y"].max()) + 1 if z["y"].ndim == 1 else z["y"].shape[1],
        edge_feat=z["ef"] if "ef" in z.files else None,
        synthetic=False,
    )


def load_node_dataset(
    name: str, root: Optional[str] = None, seed: int = 0, scale: float = 1.0
) -> NodeClassificationData:
    """Load by search order: canonical npz → synthetic.

    ``scale`` (< 1) is honoured only by the synthetic fallback: real data is
    never subsampled silently. ``DGL_TPU_SYNTH_STRUCTURAL=1`` switches the
    fallback to the structure-required construction.
    """
    root = root or data_root()
    npz = os.path.join(root, f"{name}.npz")
    if os.path.exists(npz):
        return _load_canonical_npz(npz, name)
    return synthetic_node_classification(
        name, seed=seed, cache_dir=root, scale=scale,
        structure_required=bool(os.environ.get("DGL_TPU_SYNTH_STRUCTURAL")),
    )
