"""Port parity: synthetic datasets are bit-identical to the JAX package's."""

import dataclasses

import numpy as np
import pytest

from dgl_tpu.data import synthetic as jax_synthetic
from dgl_tpu_torch.data import load_node_dataset, synthetic as torch_synthetic


@pytest.mark.parametrize(
    "name,scale,structure_required",
    [("cora", 1.0, False), ("reddit", 0.002, False), ("cora", 1.0, True)],
)
def test_synthetic_node_classification_bitwise(name, scale, structure_required):
    kw = dict(seed=3, scale=scale, structure_required=structure_required)
    ref = jax_synthetic.synthetic_node_classification(name, **kw)
    got = torch_synthetic.synthetic_node_classification(name, **kw)
    for field in dataclasses.fields(ref):
        a, b = getattr(ref, field.name), getattr(got, field.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


def test_load_node_dataset_canonical_npz_then_synthetic(tmp_path):
    rng = np.random.default_rng(0)
    n = 30
    np.savez(
        tmp_path / "toy.npz", src=rng.integers(0, n, 90), dst=rng.integers(0, n, 90),
        x=rng.standard_normal((n, 4)).astype(np.float32), y=rng.integers(0, 3, n),
        train=np.ones(n, bool), val=np.zeros(n, bool), test=np.zeros(n, bool),
    )
    toy = load_node_dataset("toy", root=str(tmp_path))
    assert not toy.synthetic and toy.num_nodes == n and toy.num_classes == 3
    syn = load_node_dataset("cora", root=str(tmp_path), scale=0.1)
    ref = jax_synthetic.synthetic_node_classification("cora", scale=0.1)
    assert syn.synthetic
    np.testing.assert_array_equal(syn.src, ref.src)
    np.testing.assert_array_equal(syn.features, ref.features)
