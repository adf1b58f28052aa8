"""Port parity: the fused featurize→forest step.

The port's plain ``fused_forest_leaf_sum`` (what the CUDA kernel is held
against) is run against the JAX ``update_and_score_pallas_forest``, whose
Pallas kernel runs in interpret mode here. The CUDA kernel itself runs only
on a card (``tests/test_torch_gpu.py``); its algorithm — the compact
tables — is written out in torch below and held against the dense form
here.

Tolerances: counts, flags and ``TX_AMOUNT`` bit-identical; averages within
``rtol=1e-6`` (float32 window sums in another order); leaf sums within
``atol=1e-5`` (float32 sums over trees in another order) with identical
decisions.
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
from real_time_fraud_detection_system_tpu.ops.pallas_forest import to_pallas
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import FeatureConfig
from real_time_fraud_detection_system_tpu_torch.core import batch as tbatch
from real_time_fraud_detection_system_tpu_torch.features import (
    online as tonline,
)
from real_time_fraud_detection_system_tpu_torch.models import forest as tforest
from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels as fk

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
    # padded trees: no feature, +inf thresholds, no entries, never matched
    assert (tables.node_feat[3:] == -1).all()
    assert torch.isinf(tables.gemm.thresh[3:]).all()
    assert (tables.leaf_entries[3:] == -1).all()
    assert (tables.leaf_target[3:] == 1_000_000_000).all()
    assert (tables.gemm.leaf_val[3:] == 0).all()
    # padded nodes and leaves of the real trees are inert too
    i, l = g.sel.shape[2], g.path.shape[2]
    assert (tables.node_feat[:3, i:] == -1).all()
    assert (tables.leaf_target[:3, l:] == 1_000_000_000).all()
    x = torch.as_tensor(rng.normal(size=(9, N_FEAT)).astype(np.float32))
    want = tforest.gemm_leaf_sum(g, x, "f32")
    xp = torch.nn.functional.pad(x, (0, fp - N_FEAT))
    np.testing.assert_allclose(
        tforest.gemm_leaf_sum(tables.gemm, xp, "int8").numpy(),
        want.numpy(), atol=ATOL_SUM_ORDER)
    np.testing.assert_allclose(_compact_leaf_sum(tables, xp).numpy(),
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
    assert adm.smem_bytes == fk.smem_bytes(16, 256, 256) == 16384
    deep = tforest.GemmEnsemble(
        sel=torch.zeros(1, N_FEAT, 4095), thresh=torch.zeros(1, 4095),
        path=torch.zeros(1, 4095, 4096), target=torch.zeros(1, 4096),
        leaf_val=torch.zeros(1, 4096))
    assert not fk.admit_tables(deep).fits


def _rows_and_tables(rng, z_mode="f32", b=40):
    jg = jforest.to_gemm(_fit(rng, n_trees=4, max_depth=3), N_FEAT)
    tables = fk.to_kernel_tables(_port_gemm(jg), z_mode)
    nb = 40
    day = torch.full((b,), 20200, dtype=torch.int32)
    bd = 20200 - torch.as_tensor(rng.integers(-1, 45, (b, nb)),
                                 dtype=torch.int32)
    vals = [torch.as_tensor(rng.integers(0, 5, (b, nb)).astype(np.float32))
            for _ in range(4)]
    return tables, dict(
        c_rows=(bd, vals[0], vals[1]), t_rows=(bd.clone(), vals[2], vals[3]),
        day=day, tod_s=torch.as_tensor(rng.integers(0, 86400, b),
                                       dtype=torch.int32),
        amount=torch.as_tensor(rng.uniform(1, 300, b).astype(np.float32)),
        scaler_mean=torch.zeros(N_FEAT), scaler_scale=torch.ones(N_FEAT))


def test_cpu_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(4)
    tables, args = _rows_and_tables(rng)
    before = fk.fused_forest_leaf_sum.launches
    leaf, feats = fk.fused_forest_leaf_sum(tables, **args)
    assert fk.fused_forest_leaf_sum.launches == before
    pleaf, pfeats = fk.fused_forest_leaf_sum_plain(tables, **args)
    np.testing.assert_array_equal(leaf.numpy(), pleaf.numpy())
    np.testing.assert_array_equal(feats.numpy(), pfeats.numpy())
    meta = {k: (tuple(t.to("meta") for t in v) if isinstance(v, tuple)
                else v.to("meta")) for k, v in args.items()}
    with pytest.raises(ValueError, match="no fused forest kernel"):
        fk.fused_forest_leaf_sum(tables, **meta)


def _compact_leaf_sum(tables, x):
    """The kernel's algorithm in torch: one feature per node, the leaf's
    (node, ±1) entries, an integer target; trees summed in order."""
    b = x.shape[0]
    feat = tables.node_feat.long()  # [T, Ip]
    xv = torch.where(feat >= 0, x[:, feat.clamp(min=0)],
                     torch.zeros((), dtype=x.dtype))  # [B, T, Ip]
    d = (xv <= tables.gemm.thresh).to(torch.int32)
    ent = tables.leaf_entries.long()  # [T, Lp, D]
    node = (ent.clamp(min=0) >> 1)
    sign = torch.where(ent < 0, 0, torch.where(ent % 2 == 1, 1, -1))
    t_idx = torch.arange(feat.shape[0])[:, None, None]
    z = (d[:, t_idx, node] * sign).sum(dim=3)  # [B, T, Lp]
    hit = z == tables.leaf_target
    acc = torch.zeros(b)
    for t in range(feat.shape[0]):
        for l in range(hit.shape[2]):
            acc = acc + torch.where(hit[:, t, l], tables.gemm.leaf_val[t, l],
                                    torch.zeros(()))
    return acc


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
        compact = _compact_leaf_sum(tables, x)
        np.testing.assert_allclose(compact.numpy(), dense.numpy(),
                                   atol=ATOL_SUM_ORDER)
        assert np.array_equal(compact.numpy() / n_trees >= 0.5,
                              dense.numpy() / n_trees >= 0.5)
        sums.append(compact.numpy())
    np.testing.assert_array_equal(sums[0], sums[1])
    np.testing.assert_array_equal(sums[0], sums[2])

