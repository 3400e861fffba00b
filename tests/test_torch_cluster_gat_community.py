"""Cluster GAT on a graph with ogbn-products' fine communities: after a few
steps on cluster batches, the port's whole-graph logits equal the JAX
package's.

On the full synthetic products graph, cluster GAT's whole-graph score
falls far below its score inside its own batches in both packages (the
JAX driver at full size on the CPU, the port on the card; ``PERF.md`` §6
and ``ROADMAP.md``'s "Semantics the port inherits"). This holds the two packages to the same whole-graph function on
the same kind of graph at a small size: each package's
``_community_edges`` draws the edges (64-node communities holding 55 % of
the edges, 15 % more within the class, the rest uniform, as
``synthetic_node_classification`` builds products at scale 1), numpy
groups the communities into batches (``ClusterIter``'s batches are held to
the JAX iterator's in ``test_torch_cluster.py``), the driver's GAT (3
layers, 4 heads, the last one head; the fused form, K3's plain version on
the CPU) takes three Adam steps at the driver's lr there, dropout off, and
its weights go to the JAX model for the whole-graph forward. (The steps
themselves are held to optax's in ``test_torch_gat.py``.) Tolerance: 1e-4
relative and absolute on the logits (float32; the JAX forward shifts the
softmax by a bound, K3 by the exact row maximum).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.data import synthetic as jax_synthetic
from dgl_tpu.models import GAT as FlaxGAT

import dgl_tpu_torch
from dgl_tpu_torch.benchmarks.common import masked_softmax_ce
from dgl_tpu_torch.data import synthetic as port_synthetic
from dgl_tpu_torch.models import GAT

# imported with the module, not inside the test: the JAX GATConv imports
# the Pallas modules on its first call, a first optimiser imports
# torch._dynamo and a first skip_init sympy's shape machinery (~4 s
# together, once a process)
import dgl_tpu.kernels  # noqa: F401,E402
import torch._dynamo  # noqa: F401,E402
import torch.fx.experimental.symbolic_shapes  # noqa: F401,E402

N, DEGREE, FEATS, CLASSES = 1500, 25, 100, 47  # products' mean in-degree, widths, classes
COMM_SIZE, P_COMM, HOMOPHILY = 64, 0.55, 0.7  # _COMMUNITY_STRUCTURE["ogbn-products"]
HIDDEN, HEADS, LR, STEPS, COMMS_PER_BATCH = 8, (4, 4, 1), 0.01, 3, 6


def _community_graph(module):
    """``synthetic_node_classification``'s scale-1 products draws at N nodes."""
    rng = np.random.default_rng(0)
    comm = rng.integers(0, max(CLASSES, N // COMM_SIZE), size=N).astype(np.int64)
    labels = (comm % CLASSES).astype(np.int64)
    src, dst = module._community_edges(rng, comm, labels, N * DEGREE, P_COMM, HOMOPHILY)
    means = rng.standard_normal((CLASSES, FEATS)).astype(np.float32)
    x = means[labels] + rng.standard_normal((N, FEATS)).astype(np.float32)
    train = rng.random(N) < 0.66
    return comm, labels, src, dst, x, train


def _batches(comm, src, dst):
    """The node sets of COMMS_PER_BATCH communities each and the edges with
    both ends inside, relabelled (what a cluster batch holds)."""
    order = np.random.default_rng(1).permutation(comm.max() + 1)
    out = []
    for i in range(STEPS):
        nodes = np.flatnonzero(np.isin(comm, order[i * COMMS_PER_BATCH:(i + 1) * COMMS_PER_BATCH]))
        local = np.full(N, -1)
        local[nodes] = np.arange(len(nodes))
        keep = (local[src] >= 0) & (local[dst] >= 0)
        out.append((nodes, local[src[keep]], local[dst[keep]]))
    return out


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_params(model):
    """``gat_state_dict_from_flax`` read backwards: the port's GAT weights as
    the JAX model's parameter tree."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return {f"gat_{i}": {"fc": {"kernel": jnp.asarray(sd[f"convs.{i}.fc.weight"].T)},
                         "attn_l": jnp.asarray(sd[f"convs.{i}.attn_l"]),
                         "attn_r": jnp.asarray(sd[f"convs.{i}.attn_r"])}
            for i in range(len(model.convs))}


def test_whole_graph_logits_after_cluster_steps_match_the_jax_package():
    jax_data, data = _community_graph(jax_synthetic), _community_graph(port_synthetic)
    for a, b in zip(jax_data, data):
        np.testing.assert_array_equal(a, b)
    comm, labels, src, dst, x, train = data

    tm = GAT(FEATS, HIDDEN, CLASSES, HEADS, fused=True, device="cpu",
             generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(tm.parameters(), lr=LR)
    for nodes, s, d in _batches(comm, src, dst):
        opt.zero_grad()
        gt = dgl_tpu_torch.from_edges(s, d, len(nodes), device="cpu")
        masked_softmax_ce(tm(gt, torch.from_numpy(x[nodes])), torch.from_numpy(labels[nodes]),
                          torch.from_numpy(train[nodes])).backward()
        opt.step()

    fm = FlaxGAT(hidden_feats=HIDDEN, out_feats=CLASSES, heads=HEADS, remat=False)
    gj = dgl_tpu.from_edges(src, dst, N)
    want = jax.jit(lambda p, xx: fm.apply({"params": p}, gj, xx))(_flax_params(tm), jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(dgl_tpu_torch.from_edges(src, dst, N, device="cpu"), torch.from_numpy(x))
    assert got.shape == (N, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
