"""Port parity: hash keys (``ops/hashing.py``), the count-min sketch
(``ops/cms.py``) and the two feature configurations they serve —
``key_mode="hash"`` and ``customer_source="cms"`` — against the JAX
package on the same seeded inputs.

Tolerances: hashes, slots, sketch slice days and counts, window counts,
flags, terminal risk and decisions bit-identical. Amount sums (sketch
cells, window sums, averages) within ``rtol=1e-6``: float32 sums of the
same amounts in another order (``index_add_`` against XLA's scatter-add;
the port's query adds the days in order where the JAX package multiplies
by a 0/1 matrix). Probabilities within ``atol=1e-6`` (logreg, forest:
the dot and the tree sum in another order) and ``rtol=1e-5, atol=1e-6``
(gbt: a sigmoid of such a sum).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import (
    Config as JConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.core import batch as jbatch
from real_time_fraud_detection_system_tpu.features import online as jonline
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models import gbt as jgbt
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.ops import cms as jcms
from real_time_fraud_detection_system_tpu.ops import hashing as jhashing
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.core import batch as tbatch
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.features import (
    online as tonline,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    fit_scaler,
)
from real_time_fraud_detection_system_tpu_torch.ops import cms as tcms
from real_time_fraud_detection_system_tpu_torch.ops import (
    forest_kernels,
    score_kernels,
)
from real_time_fraud_detection_system_tpu_torch.ops import hashing as thashing
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
START = 1_743_465_600
RTOL_SUM_ORDER = 1e-6
TOL_PROB = {"logreg": dict(rtol=0.0, atol=1e-6),
            "forest": dict(rtol=0.0, atol=1e-6),
            "gbt": dict(rtol=1e-5, atol=1e-6)}
# Keys at the edges of uint32 (0, 2^31 - 1, 2^31, 2^32 - 1: the int32
# view flips sign there), with the pad rows' key 0 among them.
EDGE_KEYS = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                      2 ** 32 - 2, 2 ** 32 - 1, 0, 0], dtype=np.uint32)


def _keys(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE_KEYS, rng.integers(
        0, 2 ** 32, 2000, dtype=np.uint64).astype(np.uint32)])


def _as_packed_view(keys: np.ndarray) -> torch.Tensor:
    """Keys as the engine sees them: a uint32 view of an int32 row."""
    return torch.from_numpy(keys.view(np.int32).copy()).view(torch.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hash_slot_and_multi_hash_match_jax_bit_for_bit(seed):
    keys = _keys(seed)
    tk = _as_packed_view(keys)
    jk = jnp.asarray(keys)
    np.testing.assert_array_equal(
        thashing.hash_u32(tk, seed).numpy(),
        np.asarray(jhashing.hash_u32(jk, seed)).astype(np.int64))
    for cap in (1, 1 << 10, 1 << 13, 1 << 20):
        np.testing.assert_array_equal(
            thashing.slot_of(tk, cap).numpy(),
            np.asarray(jhashing.slot_of(jk, cap)).astype(np.int64))
    np.testing.assert_array_equal(
        thashing.multi_hash(tk, 4, 1 << 12).numpy(),
        np.asarray(jhashing.multi_hash(jk, 4, 1 << 12)).astype(np.int64))


def test_hashing_ranges_and_dispersion():
    keys = torch.arange(10000, dtype=torch.int32).view(torch.uint32)
    s = thashing.slot_of(keys, 1 << 10).numpy()
    assert s.min() >= 0 and s.max() < (1 << 10)
    assert np.bincount(s, minlength=1 << 10).max() < 40  # ~9.8 expected
    h = thashing.multi_hash(keys, 4, 1 << 12).numpy()
    assert h.shape == (4, 10000)
    assert (h[0] == h[1]).mean() < 0.01  # rows (near-)independent
    assert torch.equal(thashing.hash_u32(keys), thashing.hash_u32(keys))
    with pytest.raises(ValueError, match="power of 2"):
        thashing.slot_of(keys, 1000)


def _sketch_stream(rng, n=400, n_keys=50, day0=100, n_days=3):
    keys = rng.integers(0, n_keys, n).astype(np.uint32)
    days = rng.integers(day0, day0 + n_days, n).astype(np.int32)
    amts = (rng.integers(100, 50000, n) / 100.0).astype(np.float32)
    valid = rng.random(n) < 0.9
    return keys, days, amts, valid


def _jax_sketch(depth, width, nd, batches):
    sk = jcms.cms_init(depth, width, nd)
    for keys, days, amts, valid in batches:
        sk = jcms.cms_update(sk, jnp.asarray(keys), jnp.asarray(amts),
                             jnp.asarray(days), jnp.asarray(valid))
    return sk


def _port_sketch(depth, width, nd, batches):
    sk = tcms.cms_init(depth, width, nd, CPU)
    for keys, days, amts, valid in batches:
        tcms.cms_update(sk, _as_packed_view(keys), torch.from_numpy(amts),
                        torch.from_numpy(days), torch.from_numpy(valid))
    return sk


def _assert_sketch(tsk, jsk):
    np.testing.assert_array_equal(tsk.slice_day.numpy(),
                                  np.asarray(jsk.slice_day))
    np.testing.assert_array_equal(tsk.count.numpy(), np.asarray(jsk.count))
    np.testing.assert_allclose(tsk.amount.numpy(), np.asarray(jsk.amount),
                               rtol=RTOL_SUM_ORDER)


@pytest.mark.parametrize("depth,width,nd", [(4, 1 << 10, 8), (2, 8, 5)])
def test_cms_update_and_query_match_jax(depth, width, nd):
    """Several batches over more days than the ring holds (slices reset
    as newer days claim them; rows older than a slice's day drop), with
    invalid rows and, at width 8, heavy collisions."""
    rng = np.random.default_rng(depth * width)
    batches = [_sketch_stream(rng, day0=100 + 3 * i) for i in range(4)]
    batches.append(_sketch_stream(rng, day0=100))  # late rows
    jsk = _jax_sketch(depth, width, nd, batches)
    tsk = _port_sketch(depth, width, nd, batches)
    _assert_sketch(tsk, jsk)
    keys, days, _, _ = _sketch_stream(rng, day0=108)
    for delay in (0, 2):
        tc, ta = tcms.cms_query(tsk, _as_packed_view(keys),
                                torch.from_numpy(days), (1, 3, 7), delay)
        jc, ja = jcms.cms_query(jsk, jnp.asarray(keys), jnp.asarray(days),
                                (1, 3, 7), delay)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                   rtol=RTOL_SUM_ORDER)


def test_cms_overestimates_and_windows():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, 400).astype(np.uint32)
    days = rng.integers(100, 103, 400).astype(np.int32)
    amts = np.ones(400, np.float32)
    sk = _port_sketch(4, 1 << 10, 8, [(keys, days, amts,
                                       np.ones(400, bool))])
    qc, qa = tcms.cms_query(sk, _as_packed_view(keys),
                            torch.from_numpy(days), (1, 7))
    for i in range(0, 400, 37):
        true_1d = np.sum((keys == keys[i]) & (days == days[i]))
        true_7d = np.sum((keys == keys[i]) & (days <= days[i])
                         & (days > days[i] - 7))
        assert qc[i, 0] >= true_1d  # a sketch never underestimates
        assert qc[i, 1] >= true_7d
        assert qc[i, 0] <= true_1d + 40  # loose collision bound
    np.testing.assert_allclose(qc.numpy(), qa.numpy(), atol=1e-3)


def test_cms_delay_zero_query_bit_identical():
    rng = np.random.default_rng(5)
    keys, days, amts, valid = _sketch_stream(rng, day0=20200)
    sk = _port_sketch(4, 1 << 10, 40, [(keys, days, amts, valid)])
    k, d = _as_packed_view(keys), torch.from_numpy(days)
    c0, a0 = tcms.cms_query(sk, k, d, (1, 7, 30))
    c1, a1 = tcms.cms_query(sk, k, d, (1, 7, 30), delay=0)
    assert torch.equal(c0, c1) and torch.equal(a0, a1)
    c2, a2 = tcms.cms_query(sk, k, d + 7, (1, 7, 30), delay=7)
    assert torch.equal(c0, c2) and torch.equal(a0, a2)


def _batch(rng, n=256, n_cust=40, day0=20200):
    """The same host batch for both packages (the JAX test's stream)."""
    cols = dict(
        customer_id=rng.integers(0, n_cust, n).astype(np.int64),
        terminal_id=rng.integers(0, 80, n).astype(np.int64),
        tx_datetime_us=((day0 + rng.integers(0, 3, n)) * 86400
                        + rng.integers(0, 86400, n)).astype(np.int64)
        * 1_000_000,
        amount_cents=rng.integers(100, 50000, n).astype(np.int64),
        label=rng.integers(-1, 2, n),
    )
    packed = tbatch.pack_batch(tbatch.make_batch(**cols, pad_to=n + 44))
    return (tbatch.unpack_batch(torch.from_numpy(packed)),
            jbatch.unpack_batch(jnp.asarray(packed)))


def _feature_cfgs(**kw):
    fields = dict(customer_capacity=256, terminal_capacity=512,
                  cms_width=1 << 12)
    fields.update(kw)
    return FeatureConfig(**fields), JFeatureConfig(**fields)


def _assert_features(tf, jf):
    """Columns 0-2 (amount, flags) and the counts and risks exact; the
    customer averages (4, 6, 8) within the sum-order tolerance."""
    tf, jf = tf.numpy(), np.asarray(jf)
    avg = [4, 6, 8]
    exact = [i for i in range(15) if i not in avg]
    np.testing.assert_array_equal(tf[:, exact], jf[:, exact])
    np.testing.assert_allclose(tf[:, avg], jf[:, avg], rtol=RTOL_SUM_ORDER)


@pytest.mark.parametrize("mode", [
    dict(key_mode="hash"), dict(customer_source="cms"),
    dict(key_mode="hash", customer_source="cms"),
    dict(customer_source="cms", cms_width=8, cms_depth=2)],
    ids=["hash", "cms", "hash-cms", "cms-colliding"])
def test_featurize_and_state_match_jax(mode):
    """Two batches through ``update_and_featurize`` in both packages:
    slots, features and the state they leave (tables and sketch)."""
    tcfg, jcfg = _feature_cfgs(**mode)
    rng = np.random.default_rng(11)
    tst = tonline.init_feature_state(tcfg, CPU)
    jst = jonline.init_feature_state(jcfg)
    for day0 in (20200, 20203):
        tb, jb = _batch(rng, day0=day0)
        for key, cap in (("customer_key", tcfg.customer_capacity),
                         ("terminal_key", tcfg.terminal_capacity)):
            np.testing.assert_array_equal(
                tonline._slot(getattr(tb, key), cap, tcfg.key_mode).numpy(),
                np.asarray(jonline._slot(getattr(jb, key), cap,
                                         jcfg.key_mode)).astype(np.int64))
        tst, tf = tonline.update_and_featurize(tst, tb, tcfg)
        jst, jf = jonline.update_and_featurize(jst, jb, jcfg)
        _assert_features(tf, jf)
    tables = ["terminal"] if tcfg.customer_source == "cms" \
        else ["customer", "terminal"]
    for table in tables:
        tws, jws = getattr(tst, table), getattr(jst, table)
        for name in ("bucket_day", "count", "fraud"):
            np.testing.assert_array_equal(getattr(tws, name).numpy(),
                                          np.asarray(getattr(jws, name)))
        np.testing.assert_allclose(tws.amount.numpy(), np.asarray(jws.amount),
                                   rtol=RTOL_SUM_ORDER)
    if tcfg.customer_source == "cms":
        _assert_sketch(tst.cms, jst.cms)
        # the customer table stays untouched under the sketch
        assert bool((tst.customer.bucket_day == -1).all())


def test_cms_features_match_exact_when_collision_free():
    tcfg, _ = _feature_cfgs()
    ccfg = dataclasses.replace(tcfg, customer_source="cms")
    tb, _ = _batch(np.random.default_rng(0))
    st_t = tonline.init_feature_state(tcfg, CPU)
    st_c = tonline.init_feature_state(ccfg, CPU)
    assert st_c.cms is not None and st_t.cms is None
    _, f_t = tonline.update_and_featurize(st_t, tb, tcfg)
    _, f_c = tonline.update_and_featurize(st_c, tb, ccfg)
    np.testing.assert_allclose(f_c.numpy(), f_t.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_cms_features_overestimate_only_under_collisions():
    tcfg, _ = _feature_cfgs()
    ccfg = dataclasses.replace(tcfg, customer_source="cms", cms_width=8,
                               cms_depth=2)
    tb, _ = _batch(np.random.default_rng(1))
    _, f_t = tonline.update_and_featurize(
        tonline.init_feature_state(tcfg, CPU), tb, tcfg)
    _, f_c = tonline.update_and_featurize(
        tonline.init_feature_state(ccfg, CPU), tb, ccfg)
    for col in (3, 5, 7):  # customer counts
        assert (f_c[:, col] >= f_t[:, col] - 1e-5).all()


def test_cms_mode_requires_sketch():
    tcfg, _ = _feature_cfgs()
    ccfg = dataclasses.replace(tcfg, customer_source="cms")
    st = tonline.init_feature_state(tcfg, CPU)  # built without a sketch
    tb, _ = _batch(np.random.default_rng(2))
    with pytest.raises(ValueError, match="cms"):
        tonline.update_and_featurize(st, tb, ccfg)
    with pytest.raises(ValueError, match="customer table"):
        tonline.update_and_score_fused_logreg(
            tonline.init_feature_state(ccfg, CPU), tb, ccfg,
            torch.zeros(15), torch.ones(15), torch.zeros(15),
            torch.tensor(0.0))


def test_state_bytes_matches_jax_for_each_mode():
    for mode in (dict(key_mode="hash"), dict(customer_source="cms"),
                 dict(customer_source="cms", cms_width=1 << 10,
                      cms_depth=3)):
        tcfg, jcfg = _feature_cfgs(**mode)
        assert tonline.state_bytes(tcfg) == jonline.state_bytes(jcfg)


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def test_engine_runs_cms_mode(small_dataset):
    txs = _port_txs(small_dataset[3])
    cfg = Config(features=FeatureConfig(customer_capacity=256,
                                        terminal_capacity=512,
                                        cms_width=1 << 12,
                                        customer_source="cms"))
    eng = ScoringEngine(cfg, "logreg",
                        LogRegParams(torch.zeros(15), torch.tensor(0.0)),
                        fit_scaler(np.ones((2, 15)), device="cpu"),
                        device="cpu")
    stats = eng.run(ReplaySource(txs.slice(slice(0, 1024)), START,
                                 batch_rows=512))
    assert stats["rows"] == 1024


def _jax_params(kind):
    if kind == "logreg":
        rng = np.random.default_rng(9)
        return JLogRegParams(
            w=jnp.asarray(rng.normal(0, 0.8, 15).astype(np.float32)),
            b=jnp.float32(-1.0))
    if kind == "gbt":
        return jgbt.synthetic_gbt(8, 4, 15, seed=3)
    return jforest.synthetic_ensemble(10, 5, 15, seed=3)


# (features, kind, the JAX engine's use_pallas, the port kernel that must
# serve the step): hash keys take each kind's fused kernel; the sketch
# serves the tree kinds through the leaf sum and logreg through its
# plain predict.
ENGINE_CASES = [
    (dict(key_mode="hash"), "logreg", False, "fused_featurize_score"),
    (dict(key_mode="hash"), "forest", True, "fused_forest_leaf_sum"),
    (dict(key_mode="hash"), "gbt", False, "leaf_sum"),
    (dict(customer_source="cms"), "logreg", False, None),
    (dict(customer_source="cms"), "forest", True, "leaf_sum"),
    (dict(customer_source="cms"), "gbt", False, "leaf_sum"),
]


@pytest.mark.parametrize(
    "features,kind,use_pallas,kernel", ENGINE_CASES,
    ids=[f"{'hash' if 'key_mode' in f else 'cms'}-{k}"
         for f, k, _, _ in ENGINE_CASES])
def test_engine_matches_jax_engine(small_dataset, monkeypatch, features,
                                   kind, use_pallas, kernel):
    """Both engines serve the same 600-row slice in 64/256-row buckets;
    the sink outputs and the final state agree, and the port's step went
    through the kernel wrapper the JAX engine's gate names."""
    jtxs = small_dataset[3].slice(slice(0, 600))
    fields = dict(customer_capacity=64, terminal_capacity=128,
                  cms_width=1 << 8, **features)
    jcfg = JConfig(features=JFeatureConfig(**fields),
                   runtime=JRuntimeConfig(batch_buckets=(64, 256),
                                          max_batch_rows=256,
                                          use_pallas=use_pallas))
    tcfg = Config(features=FeatureConfig(**fields),
                  runtime=RuntimeConfig(batch_buckets=(64, 256)))
    rng = np.random.default_rng(3)
    mean = rng.normal(3, 1, 15).astype(np.float32)
    scale = rng.uniform(0.5, 3, 15).astype(np.float32)
    jparams = _jax_params(kind)
    tparams = weights.from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    calls = {}
    for mod, name in ((forest_kernels, "fused_forest_leaf_sum_plain"),
                      (forest_kernels, "leaf_sum_plain"),
                      (score_kernels, "fused_featurize_score_plain")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    jeng = JScoringEngine(jcfg, kind=kind, params=jparams,
                          scaler=JScaler(jnp.asarray(mean),
                                         jnp.asarray(scale)))
    jsink = JMemorySink()
    jeng.run(JReplaySource(jtxs, START, batch_rows=256), sink=jsink)
    teng = ScoringEngine(tcfg, kind, tparams,
                         fit_scaler(np.zeros((2, 15)), device="cpu")
                         ._replace(mean=torch.from_numpy(mean),
                                   scale=torch.from_numpy(scale)),
                         device="cpu")
    tsink = MemorySink()
    stats = teng.run(ReplaySource(_port_txs(jtxs), START, batch_rows=256),
                     tsink)
    assert stats["rows"] == 600 and stats["batches"] == 3
    # the fused forest plain version calls the leaf sum's plain version
    want = {"fused_forest_leaf_sum": {"fused_forest_leaf_sum_plain": 3,
                                      "leaf_sum_plain": 3},
            "leaf_sum": {"leaf_sum_plain": 3},
            "fused_featurize_score": {"fused_featurize_score_plain": 3},
            None: {}}[kernel]
    assert calls == want

    jout, tout = jsink.concat(), tsink.concat()
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col],
                                       **TOL_PROB[kind])
            assert np.array_equal(tout[col] >= 0.5, jout[col] >= 0.5)
        elif "avg_amount" in col:
            np.testing.assert_allclose(tout[col], jout[col],
                                       rtol=RTOL_SUM_ORDER)
        else:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)
    assert tout["prediction"].std() > 0
    jst, tst = jeng.state.feature_state, teng.state.feature_state
    np.testing.assert_array_equal(tst.terminal.count.numpy(),
                                  np.asarray(jst.terminal.count))
    if tcfg.features.customer_source == "cms":
        _assert_sketch(tst.cms, jst.cms)
