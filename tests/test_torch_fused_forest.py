"""Port parity: the fused featurize→forest step.

The port's plain ``fused_forest_leaf_sum`` (what the CUDA kernel is held
against) is run against the JAX ``update_and_score_pallas_forest``, whose
Pallas kernel runs in interpret mode here, and, on feature-state tables
and slots, against the JAX kernel on the rows the JAX ``gather_state_rows``
takes from the same tables. The CUDA kernel itself runs only on a card
(``tests/test_torch_gpu.py``); its algorithm — the descent over the node
tables, walked in numpy by ``tests/test_torch_forest_descent.py`` — is
held against the dense form here too.

Tolerances: counts, flags, risks and ``TX_AMOUNT`` bit-identical; amount
averages within ``rtol=1e-6`` (the JAX kernel sums the NB buckets in
another order than the port's ring order); leaf sums within ``atol=1e-5``
(float32 sums over trees in another order) with identical decisions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.core import batch as jbatch
from real_time_fraud_detection_system_tpu.features import online as jonline
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.ops.pallas_forest import (
    fused_forest_leaf_sum as jfused_forest_leaf_sum,
)
from real_time_fraud_detection_system_tpu.ops.pallas_forest import to_pallas
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import FeatureConfig
from real_time_fraud_detection_system_tpu_torch.core import batch as tbatch
from real_time_fraud_detection_system_tpu_torch.features import (
    online as tonline,
)
from real_time_fraud_detection_system_tpu_torch.models import forest as tforest
from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels as fk
from test_torch_forest_descent import descent_leaf_sum  # pytest adds tests/
from test_torch_score_kernel import (
    jax_gathered_rows,
    port_feature_args,
    state_inputs,
)

# Tiny shapes: one intra-op thread each keeps the parallel test workers'
# cores free for the timing-sensitive tests beside them.
torch.set_num_threads(1)

N_FEAT = 15
ATOL_SUM_ORDER = 1e-5
RTOL_SUM_ORDER = 1e-6
EXACT_COLS = [0, 1, 2, 3, 5, 7, 9, 10, 11, 12, 13, 14]  # all but amount avgs


def _fit(rng, n_trees=7, max_depth=5, n=600):
    from sklearn.ensemble import RandomForestClassifier

    x = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 3] + rng.normal(scale=0.3, size=n) > 0.4)
    clf = RandomForestClassifier(n_estimators=n_trees, max_depth=max_depth,
                                 random_state=0, n_jobs=1)
    clf.fit(x, y.astype(np.int32))
    return jforest.ensemble_from_sklearn(clf, N_FEAT)


def _port_gemm(jg):
    return weights.from_numpy(jax.tree.map(np.asarray, jg), device="cpu")


def _cols(rng, n):
    return {
        "customer_id": rng.integers(0, 100, n).astype(np.int64),
        "terminal_id": rng.integers(0, 200, n).astype(np.int64),
        "tx_datetime_us": (
            (20200 * 86400 + rng.integers(0, 86400, n)).astype(np.int64)
            * 1_000_000),
        "amount_cents": rng.integers(100, 50000, n).astype(np.int64),
    }


@pytest.mark.parametrize("z_mode", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("rows", [64, 256, 300])  # 300: ragged tail rows
def test_fused_step_matches_jax_pallas(z_mode, rows):
    rng = np.random.default_rng(17)
    jg = jforest.to_gemm(_fit(rng), N_FEAT)
    mean = rng.normal(size=N_FEAT).astype(np.float32)
    scale = (1.0 + rng.random(N_FEAT)).astype(np.float32)
    cols = _cols(rng, rows)

    jcfg = JFeatureConfig(customer_capacity=128, terminal_capacity=256)

    def fused(fstate, batch):
        return jonline.update_and_score_pallas_forest(
            fstate, batch, jcfg, jnp.asarray(mean), jnp.asarray(scale),
            to_pallas(jg, z_mode))

    jfn = jax.jit(fused, donate_argnums=(0,))
    jb = jax.tree.map(jnp.asarray, jbatch.make_batch(**cols))
    js = jonline.init_feature_state(jcfg)

    tcfg = FeatureConfig(customer_capacity=128, terminal_capacity=256)
    tables = fk.to_kernel_tables(_port_gemm(jg), z_mode)
    tb = tbatch.unpack_batch(torch.from_numpy(
        tbatch.pack_batch(tbatch.make_batch(**cols))))
    ts = tonline.init_feature_state(tcfg, torch.device("cpu"))
    # two chained batches: the second reads state the first scattered
    for _ in range(2):
        js, jleaf, jfeats = jfn(js, jb)
        ts, tleaf, tfeats = tonline.update_and_score_fused_forest(
            ts, tb, tcfg, torch.as_tensor(mean), torch.as_tensor(scale),
            tables)
    jleaf, jfeats = np.asarray(jleaf), np.asarray(jfeats)
    tleaf, tfeats = tleaf.numpy(), tfeats.numpy()
    np.testing.assert_array_equal(tfeats[:, EXACT_COLS], jfeats[:, EXACT_COLS])
    np.testing.assert_allclose(tfeats, jfeats, rtol=RTOL_SUM_ORDER)
    np.testing.assert_allclose(tleaf, jleaf, atol=ATOL_SUM_ORDER)
    n_trees = jg.sel.shape[0]
    assert np.array_equal(tleaf / n_trees >= 0.5, jleaf / n_trees >= 0.5)
    for name in ("bucket_day", "count"):
        np.testing.assert_array_equal(
            getattr(ts.terminal, name).numpy(),
            np.asarray(getattr(js.terminal, name)))


def test_table_prep_padding_is_inert():
    rng = np.random.default_rng(7)
    jg = jforest.to_gemm(_fit(rng, n_trees=3, max_depth=3), N_FEAT)
    g = _port_gemm(jg)
    tables = fk.to_kernel_tables(g, "int8")
    tp, fp, ip, lp = fk.padded_shape(g)
    assert (tp, fp) == (fk.TREE_BLOCK, 16) and tables.n_trees == 3
    assert tables.gemm.sel.shape == (tp, fp, ip)
    assert tables.gemm.path.dtype == torch.int8
    # padded trees: +inf thresholds and zero leaves in the dense form; a
    # single leaf of value 0 and depth 0 in the descent form
    assert torch.isinf(tables.gemm.thresh[3:]).all()
    assert (tables.gemm.target[3:] == 1_000_000_000).all()
    assert (tables.gemm.leaf_val[3:] == 0).all()
    assert (tables.depth[3:] == 0).all()
    assert (tables.nodes[3:, :, :2] == 0).all()
    # padded nodes and leaves of the real trees are inert too
    i, l = g.sel.shape[2], g.path.shape[2]
    assert torch.isinf(tables.gemm.thresh[:3, i:]).all()
    assert (tables.gemm.target[:3, l:] == 1_000_000_000).all()
    x = torch.as_tensor(rng.normal(size=(9, N_FEAT)).astype(np.float32))
    want = tforest.gemm_leaf_sum(g, x, "f32")
    xp = torch.nn.functional.pad(x, (0, fp - N_FEAT))
    np.testing.assert_allclose(
        tforest.gemm_leaf_sum(tables.gemm, xp, "int8").numpy(),
        want.numpy(), atol=ATOL_SUM_ORDER)
    np.testing.assert_allclose(descent_leaf_sum(tables, xp.numpy()),
                               want.numpy(), atol=ATOL_SUM_ORDER)


def test_table_prep_refuses_non_tree_tables():
    rng = np.random.default_rng(2)
    g = _port_gemm(jforest.to_gemm(_fit(rng, n_trees=2, max_depth=3),
                                   N_FEAT))
    two_hot = g.sel.clone()
    two_hot[0, :2, 0] = 1.0
    with pytest.raises(ValueError, match="one-hot"):
        fk.to_kernel_tables(g._replace(sel=two_hot), "f32")
    bad_path = g.path.clone()
    bad_path[0, 0, 0] = 2.0
    with pytest.raises(ValueError, match="path"):
        fk.to_kernel_tables(g._replace(path=bad_path), "f32")
    bad_target = g.target.clone()
    bad_target[0, 0] = 0.5
    with pytest.raises(ValueError, match="integers"):
        fk.to_kernel_tables(g._replace(target=bad_target), "f32")


def test_admission_is_static_and_sized_in_shared_memory():
    flagship = tforest.to_gemm(
        tforest.synthetic_ensemble(100, 8, N_FEAT, seed=0, device="cpu"),
        N_FEAT)
    adm = fk.admit_tables(flagship)
    assert adm.fits and adm.padded == (100, 16, 256, 256)
    assert adm.smem_bytes == fk.smem_bytes(16) == 8192
    # the node tables stay in device memory: depth does not enter it
    deep = tforest.GemmEnsemble(
        sel=torch.zeros(1, N_FEAT, 4095), thresh=torch.zeros(1, 4095),
        path=torch.zeros(1, 4095, 4096), target=torch.zeros(1, 4096),
        leaf_val=torch.zeros(1, 4096))
    assert fk.admit_tables(deep).fits
    assert fk.admit_tables(deep).smem_bytes == adm.smem_bytes
    # the feature tile does: 500 features (504 padded) need 252 KB
    wide = deep._replace(sel=torch.zeros(1, 500, 4095))
    assert not fk.admit_tables(wide).fits
    assert fk.admit_tables(wide).smem_bytes == 128 * 504 * 4


def _rows_and_tables(rng, z_mode="f32", b=40, nb=40):
    jg = jforest.to_gemm(_fit(rng, n_trees=4, max_depth=3), N_FEAT)
    tables = fk.to_kernel_tables(_port_gemm(jg), z_mode)
    return tables, dict(port_feature_args(state_inputs(rng, b, nb)),
                        scaler_mean=torch.zeros(N_FEAT),
                        scaler_scale=torch.ones(N_FEAT))


@pytest.mark.parametrize("nb", [38, 40])  # 38: 7-day delay + 30-day window + 1
@pytest.mark.parametrize("b", [1, 37, 64])  # 37: ragged tail rows
def test_plain_on_tables_matches_jax_kernel_on_gathered_rows(b, nb):
    """The port's plain version and its CPU wrapper take the tables and
    the slots; the JAX kernel (interpret mode) takes the rows that the JAX
    ``gather_state_rows`` gathers from the same tables by the same slots."""
    rng = np.random.default_rng(1000 * nb + b)
    jg = jforest.to_gemm(_fit(rng), N_FEAT)
    mean = rng.normal(size=N_FEAT).astype(np.float32)
    scale = (1.0 + rng.random(N_FEAT)).astype(np.float32)
    inp = state_inputs(rng, b, nb)
    c_rows, t_rows = jax_gathered_rows(inp)
    jleaf, jfeats = jfused_forest_leaf_sum(
        to_pallas(jg, "int8"), c_rows, t_rows, jnp.asarray(inp["day"]),
        jnp.asarray(inp["tod_s"]), jnp.asarray(inp["amount"]),
        jnp.asarray(mean), jnp.asarray(scale))
    tables = fk.to_kernel_tables(_port_gemm(jg), "int8")
    args = dict(port_feature_args(inp), scaler_mean=torch.from_numpy(mean),
                scaler_scale=torch.from_numpy(scale))
    pleaf, pfeats = fk.fused_forest_leaf_sum_plain(tables, **args)
    leaf, feats = fk.fused_forest_leaf_sum(tables, **args)
    np.testing.assert_array_equal(feats.numpy(), pfeats.numpy())
    np.testing.assert_array_equal(leaf.numpy(), pleaf.numpy())
    jleaf, jfeats = np.asarray(jleaf), np.asarray(jfeats)
    # counts, flags, risks and amount bit-identical; the amount averages
    # to rtol 1e-6, as the JAX kernel sums the buckets in another order
    np.testing.assert_array_equal(pfeats.numpy()[:, EXACT_COLS],
                                  jfeats[:, EXACT_COLS])
    np.testing.assert_allclose(pfeats.numpy(), jfeats, rtol=RTOL_SUM_ORDER)
    np.testing.assert_allclose(pleaf.numpy(), jleaf, atol=ATOL_SUM_ORDER)
    n_trees = jg.sel.shape[0]
    assert np.array_equal(pleaf.numpy() / n_trees >= 0.5,
                          jleaf / n_trees >= 0.5)


def test_cpu_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(4)
    tables, args = _rows_and_tables(rng)
    before = fk.fused_forest_leaf_sum.launches
    leaf, feats = fk.fused_forest_leaf_sum(tables, **args)
    assert fk.fused_forest_leaf_sum.launches == before
    pleaf, pfeats = fk.fused_forest_leaf_sum_plain(tables, **args)
    np.testing.assert_array_equal(leaf.numpy(), pleaf.numpy())
    np.testing.assert_array_equal(feats.numpy(), pfeats.numpy())
    meta = {k: (type(v)(*(t.to("meta") for t in v)) if isinstance(v, tuple)
                else v.to("meta")) for k, v in args.items()}
    with pytest.raises(ValueError, match="no fused forest kernel"):
        fk.fused_forest_leaf_sum(tables, **meta)
    slot = args["cust_slot"].clone()
    slot[0] = args["customer"].capacity
    with pytest.raises(IndexError, match="cust_slot"):
        fk.fused_forest_leaf_sum(tables, **{**args, "cust_slot": slot})


@pytest.mark.parametrize("n_trees,max_depth", [(7, 5), (10, 3), (13, 6)])
def test_compact_form_matches_dense_form(n_trees, max_depth):
    rng = np.random.default_rng(21)
    g = _port_gemm(jforest.to_gemm(_fit(rng, n_trees, max_depth), N_FEAT))
    x = rng.normal(size=(64, N_FEAT)).astype(np.float32)
    th = g.thresh[torch.isfinite(g.thresh)].numpy()
    x[:32, :] = th[:32, None]  # rows exactly on thresholds
    x = torch.nn.functional.pad(torch.as_tensor(x), (0, 1))
    sums = []
    for z_mode in ("f32", "bf16", "int8"):
        tables = fk.to_kernel_tables(g, z_mode)
        dense = tforest.gemm_leaf_sum(tables.gemm, x, z_mode)
        compact = descent_leaf_sum(tables, x.numpy())
        np.testing.assert_array_equal(compact, dense.numpy())
        sums.append(compact)
    np.testing.assert_array_equal(sums[0], sums[1])
    np.testing.assert_array_equal(sums[0], sums[2])

