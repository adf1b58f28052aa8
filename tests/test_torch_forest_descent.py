"""Port parity: the descent tables that both forest kernels walk.

``ops/forest_kernels.py::to_kernel_tables`` derives, from the dense GEMM
tables alone, a node table per tree (feature, threshold bits, two
children; a leaf loops to itself and carries its value) and each tree's
depth. The CUDA kernels (``csrc/forest_walk.cuh``) run only on a card, so
:func:`descent_leaf_sum` walks the tables in numpy as the kernels do:
``TREES_IN_FLIGHT`` trees at a time, each for the largest depth among
them, then the trees' values added one after another in tree order. It is
held against

- the port's ``gemm_leaf_sum`` on the padded tables (the kernels' plain
  version): bit for bit;
- the JAX package's ``pallas_leaf_sum`` in interpret mode: bit for bit on
  forests of at most ten trees, where the Pallas kernel's one block of
  ten trees adds them in the same order; within ``atol=1e-5`` beyond (it
  adds each block's sum to the total, another order of float32 adds).

Forests: sklearn fits of irregular depth (carried across with
``weights.from_numpy``), the port's seeded ``ragged_ensemble`` (leaves at
depths 1..8, trees of different depths side by side) and a depth-12 tree.
Tables that are not trees raise ``ValueError``; padding stays inert.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.ops.pallas_forest import (
    pallas_leaf_sum,
    to_pallas,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.models import forest as tforest
from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels as fk

# Tiny shapes: one intra-op thread each keeps the parallel test workers'
# cores free for the timing-sensitive tests beside them.
torch.set_num_threads(1)

N_FEAT = 15
ATOL_SUM_ORDER = 1e-5
Z_MODES = ("f32", "bf16", "int8")


def descent_leaf_sum(tables, x: np.ndarray,
                     k: int = fk.TREES_IN_FLIGHT) -> np.ndarray:
    """The kernels' walk in numpy: [B, F ≤ Fp] float32 → Σ_t leaf value
    over all the tables' trees (the padded ones add +0), ``k`` at a
    time."""
    nodes, depth = tables.nodes.numpy(), tables.depth.numpy()
    x = np.pad(x, ((0, 0), (0, tables.gemm.sel.shape[1] - x.shape[1])))
    b = x.shape[0]
    rows = np.arange(b)
    acc = np.zeros(b, np.float32)
    for t0 in range(0, nodes.shape[0], k):
        node = np.zeros((k, b), np.int64)
        for _ in range(int(depth[t0:t0 + k].max())):
            for j in range(k):
                rec = nodes[t0 + j][node[j]]
                v = x[rows, rec[:, 0]]
                node[j] = np.where(v <= rec[:, 1].view(np.float32),
                                   rec[:, 2], rec[:, 3])
        for j in range(k):
            acc = acc + nodes[t0 + j][node[j]][:, 1].view(np.float32)
    return acc


def _port(tree):
    return weights.from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _jax_gemm(tg):
    return jforest.GemmEnsemble(*(jnp.asarray(a.numpy()) for a in tg))


def _sklearn_gemm(rng, n_trees, max_depth, min_leaf):
    from sklearn.ensemble import RandomForestClassifier

    x = rng.normal(size=(600, N_FEAT)).astype(np.float32)
    y = x[:, 0] + 0.5 * x[:, 3] + rng.normal(scale=0.6, size=600) > 0.4
    clf = RandomForestClassifier(n_estimators=n_trees, max_depth=max_depth,
                                 min_samples_leaf=min_leaf, random_state=0,
                                 n_jobs=1)
    clf.fit(x, y.astype(np.int32))
    return _port(jforest.to_gemm(jforest.ensemble_from_sklearn(clf, N_FEAT),
                                 N_FEAT))


def _rows(rng, g, b=300):
    """Normal rows, the first 32 placed exactly on thresholds."""
    x = rng.normal(size=(b, N_FEAT)).astype(np.float32)
    th = g.thresh[torch.isfinite(g.thresh)].numpy()
    x[:32] = th[rng.integers(0, len(th), 32)][:, None]
    return x


def _leaf_depths(tables):
    """Depth of every real leaf, from the dense path table."""
    g = tables.gemm
    real = g.target < 1e9 / 2
    return set((g.path != 0).sum(dim=1)[real].tolist())


def _check_against_dense(g, x, pallas_exact):
    sums = {}
    for z_mode in Z_MODES:
        tables = fk.to_kernel_tables(g, z_mode)
        got = descent_leaf_sum(tables, x)
        np.testing.assert_array_equal(
            got, fk.leaf_sum_plain(tables, torch.as_tensor(x)).numpy())
        want = np.asarray(pallas_leaf_sum(to_pallas(_jax_gemm(g), z_mode),
                                          jnp.asarray(x), block_rows=128))
        if pallas_exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0.0,
                                       atol=ATOL_SUM_ORDER)
            n = g.sel.shape[0]
            assert np.array_equal(got / n >= 0.5, want / n >= 0.5)
        sums[z_mode] = got
    np.testing.assert_array_equal(sums["bf16"], sums["f32"])
    np.testing.assert_array_equal(sums["int8"], sums["f32"])
    return tables


@pytest.mark.parametrize("n_trees,max_depth,min_leaf", [
    (7, None, 3), (10, 8, 1), (4, 12, 2)])
def test_descent_matches_dense_and_pallas_on_sklearn_forests(
        n_trees, max_depth, min_leaf):
    rng = np.random.default_rng(31)
    g = _sklearn_gemm(rng, n_trees, max_depth, min_leaf)
    tables = _check_against_dense(g, _rows(rng, g), pallas_exact=True)
    assert len(_leaf_depths(tables)) > 2  # the trees are irregular


@pytest.mark.parametrize("n_trees,seed", [(10, 0), (10, 1), (37, 2)])
def test_descent_matches_dense_on_ragged_synthetic_trees(n_trees, seed):
    ens = tforest.ragged_ensemble(n_trees, 8, N_FEAT, seed=seed,
                                  device="cpu")
    g = tforest.to_gemm(ens, N_FEAT)
    rng = np.random.default_rng(seed)
    tables = _check_against_dense(g, _rows(rng, g),
                                  pallas_exact=n_trees <= fk.TREE_BLOCK)
    assert tables.depth[0] == 8 and len(set(tables.depth.tolist())) > 2
    if n_trees > fk.TREE_BLOCK:
        assert _leaf_depths(tables) == set(range(1, 9))
    # the descent form agrees with the node tables it came from
    x = _rows(rng, g, b=64)
    per_tree = tforest.ensemble_leaf_values(ens, torch.as_tensor(x))
    acc = torch.zeros(64)
    for t in range(n_trees):
        acc = acc + per_tree[:, t]
    np.testing.assert_array_equal(descent_leaf_sum(tables, x), acc.numpy())


def test_descent_matches_dense_on_a_depth_12_tree():
    ens = tforest.ragged_ensemble(1, 12, N_FEAT, seed=5, max_leaves=300,
                                  device="cpu")
    g = tforest.to_gemm(ens, N_FEAT)
    tables = _check_against_dense(g, _rows(np.random.default_rng(5), g),
                                  pallas_exact=True)
    assert int(tables.depth[0]) == 12
    assert max(_leaf_depths(tables)) == 12 and min(_leaf_depths(tables)) < 6


# A tree as root→leaf chains of (node, +1 left / -1 right), one per leaf:
# n0 → (A, n1), n1 → (B, C).
_TREE = {"A": [(0, 1)], "B": [(0, -1), (1, 1)], "C": [(0, -1), (1, -1)]}


def _dense(chains, n_nodes, targets=None):
    """A one-tree GemmEnsemble from chains; targets default to each
    leaf's count of left turns."""
    leaves = sorted(chains)
    path = torch.zeros(1, n_nodes, len(leaves))
    target = torch.zeros(1, len(leaves))
    for li, leaf in enumerate(leaves):
        for node, side in chains[leaf]:
            path[0, node, li] = side
        target[0, li] = sum(side > 0 for _, side in chains[leaf])
    for li, value in (targets or {}).items():
        target[0, leaves.index(li)] = value
    sel = torch.zeros(1, N_FEAT, n_nodes)
    sel[0, torch.arange(n_nodes) % N_FEAT, torch.arange(n_nodes)] = 1.0
    return tforest.GemmEnsemble(
        sel=sel, thresh=torch.zeros(1, n_nodes), path=path, target=target,
        leaf_val=torch.arange(1.0, len(leaves) + 1)[None])


_NOT_TREES = {
    # A turns right at n0, where n1 already is
    "two children on one side": (
        {**_TREE, "A": [(0, -1)]}, 2, None),
    # C is gone: n1 has no right child
    "lacks a child": (
        {"A": [(0, 1)], "B": [(0, -1), (1, 1)]}, 2, None),
    # n3 hangs below n1 (left) and below n2 (left)
    "two parents": ({
        "D": [(0, 1), (1, 1), (3, 1)], "E": [(0, -1), (2, 1), (3, -1)],
        "L1": [(0, 1), (1, -1), (4, 1)], "L2": [(0, 1), (1, -1), (4, -1)],
        "F1": [(0, -1), (2, -1), (5, 1)], "F2": [(0, -1), (2, -1), (5, -1)],
    }, 6, None),
    "no common root": (
        {"A": [(0, 1)], "B": [(0, -1)], "C": [(1, 1)], "D": [(1, -1)]},
        2, None),
    "do not nest": (
        {"A": [(0, 1), (1, 1)], "B": [(0, -1), (1, -1)]}, 2, None),
    "count of left turns": (_TREE, 2, {"A": 0.0}),
    "without conditions beside others": (
        {"A": [], "B": [(0, 1)], "C": [(0, -1)]}, 1, None),
    "lone leaf has conditions": ({"A": [(0, 1)]}, 1, None),
    "more than one leaf has no conditions": ({"A": [], "B": []}, 1, None),
}


@pytest.mark.parametrize("what", sorted(_NOT_TREES))
def test_tables_that_are_not_trees_raise(what):
    chains, n_nodes, targets = _NOT_TREES[what]
    with pytest.raises(ValueError, match=what):
        fk.to_kernel_tables(_dense(chains, n_nodes, targets), "f32")


def test_the_tree_the_raising_cases_start_from_is_accepted():
    g = _dense(_TREE, 2)
    tables = fk.to_kernel_tables(g, "f32")
    assert int(tables.depth[0]) == 2 and tables.nodes.shape[1] == 5
    # breadth-first: n0, A, n1, B, C; the leaves carry 1, 2, 3
    rec = tables.nodes[0]
    assert rec[0, 2:].tolist() == [1, 2] and rec[2, 2:].tolist() == [3, 4]
    for n, value in ((1, 1.0), (3, 2.0), (4, 3.0)):
        assert rec[n, 2:].tolist() == [n, n]
        assert rec[n, 1:2].view(torch.float32).item() == value
    x = np.array([[-1.0, 0.0], [1.0, -1.0], [1.0, 1.0]], np.float32)
    x = np.pad(x, ((0, 0), (0, N_FEAT - 2)))
    np.testing.assert_array_equal(descent_leaf_sum(tables, x), [1, 2, 3])


def test_node_without_a_feature_decides_alike_for_every_row():
    """An all-zero ``sel`` column projects every row to 0: the node goes
    left when 0 <= threshold, and the table links both sides there."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, N_FEAT)).astype(np.float32)
    for th, reached in ((0.5, {1.0}), (-0.5, {2.0, 3.0})):
        g = _dense(_TREE, 2)
        g.sel[0, :, 0] = 0.0
        g.thresh[0, 0] = th
        tables = fk.to_kernel_tables(g, "f32")
        assert tables.nodes[0, 0, 2] == tables.nodes[0, 0, 3]
        got = descent_leaf_sum(tables, x)
        np.testing.assert_array_equal(
            got, fk.leaf_sum_plain(tables, torch.as_tensor(x)).numpy())
        assert set(got.tolist()) == reached


@pytest.mark.parametrize("depth", [8, 9, 10])
def test_complete_trees_take_every_node_and_any_depth_is_admitted(depth):
    """A complete tree of depth d has 2**(d+1) - 1 node records and a trip
    count of d; a block of either kernel holds only the feature tile in
    shared memory, so the admission does not depend on the depth."""
    g = tforest.to_gemm(tforest.synthetic_ensemble(1, depth, N_FEAT,
                                                   seed=0, device="cpu"),
                        N_FEAT)
    tables = fk.to_kernel_tables(g, "int8")
    assert tables.nodes.shape[1:] == (2 ** (depth + 1) - 1, 4)
    assert int(tables.depth[0]) == depth
    adm = fk.admit_tables(g)
    assert adm.fits and adm.smem_bytes == fk.smem_bytes(16) == 128 * 16 * 4


def test_descent_padding_is_inert():
    """Padded trees are a single leaf of value 0 with depth 0; a tree's
    padded node rows are self-loops of value 0 that no node links to; a
    forest of no real leaf adds 0."""
    rng = np.random.default_rng(7)
    g = _sklearn_gemm(rng, 3, 4, 1)
    tables = fk.to_kernel_tables(g, "int8")
    tp, n = tables.nodes.shape[:2]
    assert tp == fk.TREE_BLOCK and tables.n_trees == 3
    assert (tables.depth[3:] == 0).all()
    idx = torch.arange(n)
    assert (tables.nodes[3:, :, :2] == 0).all()
    assert (tables.nodes[3:, :, 2] == idx).all()
    assert (tables.nodes[3:, :, 3] == idx).all()
    for t in range(3):
        rec = tables.nodes[t]
        internal = rec[:, 2] != idx
        used = int(internal.sum()) * 2 + 1  # the tree's own rows
        assert (rec[used:, 2] == idx[used:]).all()
        assert (rec[used:, :2] == 0).all()
        assert int(rec[:used, 2:].max()) < used
    x = _rows(rng, g, b=40)
    real = tables._replace(nodes=tables.nodes[:3], depth=tables.depth[:3])
    np.testing.assert_array_equal(descent_leaf_sum(tables, x),
                                  descent_leaf_sum(real, x, k=1))
    dead = g._replace(target=torch.full_like(g.target, 1e9))
    np.testing.assert_array_equal(
        descent_leaf_sum(fk.to_kernel_tables(dead, "f32"), x),
        np.zeros(40, np.float32))
