"""Port parity: the forest scorers against the JAX package.

Ensembles are fitted with sklearn or built by ``synthetic_ensemble`` in the
JAX package and carried to the port with ``weights.from_numpy``. Tolerances:

- GEMM tables and descent leaf values are bit-identical (same tables,
  same comparisons);
- leaf sums within ``atol=1e-5``: float32 sums over trees taken in
  another order;
- decisions (``p >= 0.5``) identical, and every z mode of the port gives
  bit-identical leaf sums (z is an exact integer in each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.models import forest as tforest

# Tiny shapes: one intra-op thread each keeps the parallel test workers'
# cores free for the timing-sensitive tests beside them.
torch.set_num_threads(1)

N_FEAT = 15
ATOL_SUM_ORDER = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fit(rng, n_trees, max_depth, n=600):
    from sklearn.ensemble import RandomForestClassifier

    x = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 3] + rng.normal(scale=0.3, size=n) > 0.4)
    clf = RandomForestClassifier(n_estimators=n_trees, max_depth=max_depth,
                                 random_state=0, n_jobs=1)
    clf.fit(x, y.astype(np.int32))
    return clf, jforest.ensemble_from_sklearn(clf, N_FEAT)


def _ensemble(source, n_trees, max_depth):
    rng = np.random.default_rng(3)
    if source == "sklearn":
        clf, ens = _fit(rng, n_trees, max_depth)
    else:
        clf, ens = None, jforest.synthetic_ensemble(n_trees, max_depth,
                                                    N_FEAT, seed=4)
    x = rng.normal(size=(300, N_FEAT)).astype(np.float32)
    return clf, ens, x


SHAPES = [(7, 5), (10, 3), (13, 6)]


@pytest.mark.parametrize("source", ["sklearn", "synthetic"])
@pytest.mark.parametrize("n_trees,max_depth", SHAPES)
def test_gemm_leaf_sum_every_z_mode_matches(source, n_trees, max_depth):
    clf, ens, x = _ensemble(source, n_trees, max_depth)
    jg = jforest.to_gemm(ens, N_FEAT)
    tens = weights.from_numpy(_np(ens), device="cpu")
    tg = tforest.to_gemm(tens, N_FEAT)
    for a, b in zip(tg, _np(jg)):
        np.testing.assert_array_equal(a.numpy(), b)
    want = np.asarray(jforest.gemm_leaf_sum(jg, jnp.asarray(x), "f32"))
    sums = {}
    for z_mode in ("f32", "bf16", "int8"):
        sums[z_mode] = tforest.gemm_leaf_sum(tg, torch.as_tensor(x),
                                             z_mode).numpy()
        np.testing.assert_allclose(sums[z_mode], want, atol=ATOL_SUM_ORDER)
        jz = np.asarray(jforest.gemm_leaf_sum(jg, jnp.asarray(x), z_mode))
        np.testing.assert_allclose(sums[z_mode], jz, atol=ATOL_SUM_ORDER)
    np.testing.assert_array_equal(sums["bf16"], sums["f32"])
    np.testing.assert_array_equal(sums["int8"], sums["f32"])
    p_t = tforest.predict_proba(tg, torch.as_tensor(x), "int8").numpy()
    p_j = np.asarray(jforest.predict_proba(jg, jnp.asarray(x), "f32"))
    assert np.array_equal(p_t >= 0.5, p_j >= 0.5)
    if clf is not None:
        p_skl = clf.predict_proba(x)[:, 1]
        np.testing.assert_allclose(p_t, p_skl, atol=1e-6)


@pytest.mark.parametrize("source", ["sklearn", "synthetic"])
@pytest.mark.parametrize("n_trees,max_depth", SHAPES)
def test_descent_form_matches(source, n_trees, max_depth):
    _, ens, x = _ensemble(source, n_trees, max_depth)
    tens = weights.from_numpy(_np(ens), device="cpu")
    np.testing.assert_array_equal(
        tforest.ensemble_leaf_values(tens, torch.as_tensor(x)).numpy(),
        np.asarray(jforest.ensemble_leaf_values(ens, jnp.asarray(x))))
    np.testing.assert_allclose(
        tforest.predict_proba(tens, torch.as_tensor(x)).numpy(),
        np.asarray(jforest.predict_proba(ens, jnp.asarray(x))),
        atol=1e-6)  # mean over trees in another order


def test_threshold_edge_inputs():
    """Inputs placed EXACTLY on thresholds: decisions must not flip, in
    any z mode."""
    rng = np.random.default_rng(5)
    clf, ens = _fit(rng, n_trees=5, max_depth=4)
    th = np.asarray(ens.thresh).ravel()
    th = th[np.isfinite(th) & (th != 0)]
    k = min(len(th), 64)
    x = np.tile(th[:k, None], (1, N_FEAT)).astype(np.float32)
    tg = tforest.for_device(weights.from_numpy(_np(ens), device="cpu"),
                            N_FEAT)
    assert isinstance(tg, tforest.GemmEnsemble)
    p_skl = clf.predict_proba(x)[:, 1]
    for z_mode in ("f32", "bf16", "int8"):
        p = tforest.predict_proba(tg, torch.as_tensor(x), z_mode).numpy()
        np.testing.assert_allclose(p, p_skl, atol=1e-6)


def test_synthetic_ensemble_and_ftz_match_jax():
    want = _np(jforest.synthetic_ensemble(6, 4, N_FEAT, seed=9))
    got = tforest.synthetic_ensemble(6, 4, N_FEAT, seed=9, device="cpu")
    for name in ("feat", "thresh", "left", "right", "prob"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    assert got.max_depth == int(want.max_depth)
    t = np.asarray([1e-45, -1e-45, 0.0, -0.0, 1.5, -2e-39], np.float32)
    np.testing.assert_array_equal(tforest.ftz_safe_thresholds(t),
                                  jforest.ftz_safe_thresholds(t))


def test_resolve_z_mode():
    assert tforest.resolve_z_mode("auto", "cpu") == "f32"
    assert tforest.resolve_z_mode(None, "cuda") == "int8"
    assert tforest.resolve_z_mode("bf16", "cpu") == "bf16"
    with pytest.raises(ValueError):
        tforest.resolve_z_mode("fp8", "cpu")


def test_from_numpy_refuses_unknown_records():
    with pytest.raises(ValueError, match="fields"):
        weights.from_numpy({"w": np.zeros(3), "b": np.zeros(())},
                           device="cpu")
