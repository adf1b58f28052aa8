"""Port parity: the classify-only forest step (``leaf_sum``).

The port's plain ``leaf_sum`` (what the CUDA kernel of ``csrc/leaf_sum.cu``
is held against on the card) runs against the JAX ``pallas_leaf_sum`` —
its Pallas kernel in interpret mode — and against the JAX
``gemm_leaf_sum``, mirroring ``tests/test_pallas_forest.py``. Ensembles are
fitted with sklearn in the JAX package and carried across with
``weights.from_numpy``; the kernel itself runs only on a card
(``tests/test_torch_gpu.py``), and its descent over the node tables is
held against the dense form in ``tests/test_torch_forest_descent.py``.

Tolerances: leaf sums within ``atol=1e-5`` of the JAX package (float32
sums over trees in another order: the Pallas kernel adds blocks of ten);
probabilities within ``atol=1e-6`` of sklearn; decisions identical; the
port's z modes bit-identical (z is an exact integer in each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models import gbt as jgbt
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
ATOL_LEAF = 1e-5
ATOL_PROB = 1e-6


def _fit(rng, n_trees=7, max_depth=5, n=600):
    from sklearn.ensemble import RandomForestClassifier

    x = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 3] + rng.normal(scale=0.3, size=n) > 0.4)
    clf = RandomForestClassifier(n_estimators=n_trees, max_depth=max_depth,
                                 random_state=0, n_jobs=1)
    clf.fit(x, y.astype(np.int32))
    return clf, jforest.ensemble_from_sklearn(clf, N_FEAT), x


def _port(tree):
    return weights.from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _tables(jg, z_mode="f32"):
    return fk.to_kernel_tables(_port(jg), z_mode)


@pytest.mark.parametrize("n_trees,max_depth",
                         [(7, 5), (fk.TREE_BLOCK, 3), (13, 6)])
def test_leaf_sum_matches_jax_pallas(n_trees, max_depth):
    """Mirror of test_pallas_matches_gemm: 300 rows (no ×block tile)."""
    rng = np.random.default_rng(3)
    clf, ens, _ = _fit(rng, n_trees=n_trees, max_depth=max_depth)
    jg = jforest.to_gemm(ens, N_FEAT)
    tables = _tables(jg)
    xq = rng.normal(size=(300, N_FEAT)).astype(np.float32)
    got = fk.leaf_sum(tables, torch.as_tensor(xq)).numpy()
    want_pallas = np.asarray(pallas_leaf_sum(to_pallas(jg), jnp.asarray(xq),
                                             block_rows=128))
    want_gemm = np.asarray(jforest.gemm_leaf_sum(jg, jnp.asarray(xq),
                                                 z_mode="f32"))
    np.testing.assert_allclose(got, want_pallas, rtol=0.0, atol=ATOL_LEAF)
    np.testing.assert_allclose(got, want_gemm, rtol=0.0, atol=ATOL_LEAF)
    p = (fk.leaf_sum(tables, torch.as_tensor(xq)) / n_trees).numpy()
    np.testing.assert_allclose(p, clf.predict_proba(xq)[:, 1],
                               rtol=0.0, atol=ATOL_PROB)


@pytest.mark.parametrize("z_mode", ["f32", "bf16", "int8"])
def test_threshold_edge_inputs(z_mode):
    """Rows placed EXACTLY on thresholds (the ftz_safe_thresholds edges):
    decisions must equal sklearn's and the JAX kernel's."""
    rng = np.random.default_rng(5)
    clf, ens, _ = _fit(rng, n_trees=5, max_depth=4)
    jg = jforest.to_gemm(ens, N_FEAT)
    th = np.asarray(ens.thresh).ravel()
    th = th[np.isfinite(th) & (th != 0)]
    k = min(len(th), 64)
    xq = np.tile(th[:k, None], (1, N_FEAT)).astype(np.float32)
    p = (fk.leaf_sum(_tables(jg, z_mode), torch.as_tensor(xq)) / 5).numpy()
    p_skl = clf.predict_proba(xq)[:, 1]
    np.testing.assert_allclose(p, p_skl, rtol=0.0, atol=ATOL_PROB)
    p_jax = np.asarray(pallas_leaf_sum(to_pallas(jg, z_mode),
                                       jnp.asarray(xq), block_rows=64)) / 5
    assert np.array_equal(p >= 0.5, p_skl >= 0.5)
    assert np.array_equal(p >= 0.5, p_jax >= 0.5)


def test_gbt_leaf_sum_path():
    """The leaf SUM also serves boosting: sigmoid(base + leaf_sum) against
    the JAX gbt predict and the JAX kernel's sum."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(500, N_FEAT)).astype(np.float32)
    y = (x[:, 2] > 0.1).astype(np.int32)
    model = jgbt.gbt_for_device(jgbt.train_gbt(x, y, n_trees=6, max_depth=4),
                                N_FEAT)
    tables = _tables(model.trees)
    xq = x[:200]
    leaf = fk.leaf_sum(tables, torch.as_tensor(xq))
    want = np.asarray(pallas_leaf_sum(to_pallas(model.trees),
                                      jnp.asarray(xq)))
    np.testing.assert_allclose(leaf.numpy(), want, rtol=0.0, atol=ATOL_LEAF)
    p = torch.sigmoid(torch.tensor(float(model.base_score)) + leaf)
    p_jax = np.asarray(jgbt.gbt_predict_proba(model, jnp.asarray(xq), "f32"))
    np.testing.assert_allclose(p.numpy(), p_jax, rtol=1e-5, atol=ATOL_PROB)
    assert p.numpy().std() > 0


def test_padding_is_inert():
    """Padded trees, nodes and feature columns contribute exactly zero."""
    rng = np.random.default_rng(7)
    _, ens, _ = _fit(rng, n_trees=3, max_depth=3)
    jg = jforest.to_gemm(ens, N_FEAT)
    tables = _tables(jg)
    assert tables.gemm.sel.shape[0] == fk.TREE_BLOCK and tables.n_trees == 3
    xq = rng.normal(size=(9, N_FEAT)).astype(np.float32)
    got = (fk.leaf_sum(tables, torch.as_tensor(xq)) / 3).numpy()
    want = np.asarray(jforest.gemm_predict_proba(jg, jnp.asarray(xq),
                                                 z_mode="f32"))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=ATOL_PROB)
    # a row already padded to Fp scores what the [B, 15] row scores
    xp = torch.nn.functional.pad(torch.as_tensor(xq), (0, 1))
    np.testing.assert_array_equal(fk.leaf_sum(tables, xp).numpy(),
                                  fk.leaf_sum(tables,
                                              torch.as_tensor(xq)).numpy())


@pytest.mark.parametrize("z_mode", ["f32", "int8", "bf16"])
def test_classify_kernel_z_modes_match(z_mode):
    """Every z mode agrees with the JAX kernel in the same mode and, bit
    for bit, with the port's f32 sums."""
    rng = np.random.default_rng(13)
    clf, ens, _ = _fit(rng, n_trees=7, max_depth=5)
    jg = jforest.to_gemm(ens, N_FEAT)
    xq = torch.as_tensor(rng.normal(size=(200, N_FEAT)).astype(np.float32))
    got = fk.leaf_sum(_tables(jg, z_mode), xq).numpy()
    np.testing.assert_array_equal(got,
                                  fk.leaf_sum(_tables(jg, "f32"), xq).numpy())
    want = np.asarray(pallas_leaf_sum(to_pallas(jg, z_mode),
                                      jnp.asarray(xq.numpy()), block_rows=64))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=ATOL_LEAF)
    p_skl = clf.predict_proba(xq.numpy())[:, 1]
    assert np.array_equal(got / 7 >= 0.5, p_skl >= 0.5)


def _meta_gemm(n_trees, n_internal, n_leaves):
    """A GemmEnsemble of shapes only: tensors on the meta device hold no
    data, so a predicate that reads any value fails on it."""
    z = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    return tforest.GemmEnsemble(
        sel=z(n_trees, N_FEAT, n_internal), thresh=z(n_trees, n_internal),
        path=z(n_trees, n_internal, n_leaves), target=z(n_trees, n_leaves),
        leaf_val=z(n_trees, n_leaves))


@pytest.mark.parametrize("depth", [8, 10, 11, 12, 13])
def test_leaf_sum_admission_is_static_and_sized_in_shared_memory(depth):
    """The leaf-sum kernel has the fused kernel's block layout and one
    admission predicate with it: both read the node tables from device
    memory and hold only the feature tile in shared memory, so every depth
    is admitted."""
    g = _meta_gemm(100, 2 ** depth - 1, 2 ** depth)
    adm = fk.admit_tables(g)
    side = 2 ** depth if depth > 7 else 128
    assert adm.padded == (100, 16, side, side)
    assert adm.smem_bytes == fk.smem_bytes(16) == 8192
    assert adm.budget == fk.SMEM_BUDGET == 227 * 1024
    assert adm.fits
    assert not fk.admit_tables(g, budget=8191).fits


def test_cpu_leaf_sum_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(4)
    _, ens, _ = _fit(rng, n_trees=4, max_depth=3)
    tables = _tables(jforest.to_gemm(ens, N_FEAT))
    x = torch.as_tensor(rng.normal(size=(33, N_FEAT)).astype(np.float32))
    before = fk.leaf_sum.launches
    got = fk.leaf_sum(tables, x)
    assert fk.leaf_sum.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  fk.leaf_sum_plain(tables, x).numpy())
    with pytest.raises(ValueError, match="no leaf-sum kernel"):
        fk.leaf_sum(tables, x.to("meta"))
