"""Port parity: the tiered feature store (``key_mode="exact"``) against the
JAX package — the update and featurize, the sketch's fraud column, the
recency compaction with and without the cold tier's demotion, promotion,
the state accounting, and the engine (``tests/test_exact_store.py``'s
cases, held against the JAX functions on the same seeded inputs).

Tolerances (those of ``test_torch_windows_features.py`` and
``test_torch_hash_cms.py``): slots, admitted masks, every directory leaf,
bucket days, counts, fraud sums, sketch counts, compaction and promotion
payloads, tier counts and features other than the customer averages bit
for bit; amount sums and the averages built on them within
``rtol=1e-6`` (float32 sums of the same amounts in another order; exact
on whole-dollar streams); forest probabilities within ``atol=1e-6`` (the
tree sum in another order), logreg's and gbt's within ``rtol=1e-5,
atol=1e-6`` (a sigmoid of a sum taken in another order; the logreg dot's
terms reach ~100 on these streams' unscaled amounts and sketch counts, so
its rounding is relative to them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import Config as JConfig
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
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu.utils.metrics import (
    MetricsRegistry as JMetricsRegistry,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.core import batch as tbatch
from real_time_fraud_detection_system_tpu_torch.features import (
    online as tonline,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.ops import cms as tcms
from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels
from real_time_fraud_detection_system_tpu_torch.ops import keydir as tkeydir
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
DAY0 = 20200
RTOL_SUM_ORDER = 1e-6
TOL_PROB = {"logreg": dict(rtol=1e-5, atol=1e-6),
            "forest": dict(rtol=0.0, atol=1e-6),
            "gbt": dict(rtol=1e-5, atol=1e-6)}
EXACT_LEAVES = ("bucket_day", "count", "fraud", "slice_day", "keys",
                "slots", "free", "free_top")


def _cfgs(**kw):
    fields = dict(customer_capacity=32, terminal_capacity=32,
                  cms_width=1 << 10, key_mode="exact")
    fields.update(kw)
    return FeatureConfig(**fields), JFeatureConfig(**fields)


def _batch(rng, n=200, n_cust=60, n_term=60, day0=DAY0, spread=3,
           whole_dollar=False, pad=256):
    """The same packed batch for both packages."""
    cents = (rng.integers(1, 500, n) * 100 if whole_dollar
             else rng.integers(100, 50000, n))
    cols = dict(
        customer_id=rng.integers(0, n_cust, n).astype(np.int64),
        terminal_id=rng.integers(0, n_term, n).astype(np.int64),
        tx_datetime_us=((day0 + rng.integers(0, spread, n)) * 86400
                        + rng.integers(0, 86400, n)).astype(np.int64)
        * 1_000_000,
        amount_cents=cents.astype(np.int64),
        label=rng.integers(-1, 2, n),
    )
    packed = tbatch.pack_batch(tbatch.make_batch(**cols, pad_to=pad))
    return (tbatch.unpack_batch(torch.from_numpy(packed)),
            jbatch.unpack_batch(jnp.asarray(packed)))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_state(tstate, jstate, exact_amount=False):
    """Every leaf of the port's state against the JAX package's, in the
    JAX flatten order (the checkpoint's leaf order)."""
    jleaves = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tleaves = jax.tree_util.tree_flatten_with_path(
        tstate, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [jax.tree_util.keystr(p) for p, _ in tleaves] == \
        [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        name = jax.tree_util.keystr(path).rsplit(".", 1)[-1]
        t, j = _np(t), np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape, path
        if name in EXACT_LEAVES or exact_amount:
            np.testing.assert_array_equal(t, j, err_msg=str(path))
        else:
            np.testing.assert_allclose(t, j, rtol=RTOL_SUM_ORDER,
                                       err_msg=str(path))


def _assert_features(tf, jf, exact_amount=False):
    tf, jf = _np(tf), np.asarray(jf)
    avg = [4, 6, 8]
    exact = [i for i in range(15) if i not in avg]
    np.testing.assert_array_equal(tf[:, exact], jf[:, exact])
    if exact_amount:
        np.testing.assert_array_equal(tf[:, avg], jf[:, avg])
    else:
        np.testing.assert_allclose(tf[:, avg], jf[:, avg],
                                   rtol=RTOL_SUM_ORDER)


# ---------------------------------------------------------------------------
# update and featurize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [
    dict(), dict(customer_source="cms"), dict(customer_capacity=512,
                                              terminal_capacity=512),
    dict(keydir_probes=1)],
    ids=["overflow", "cms-customers", "all-admitted", "one-probe"])
@pytest.mark.parametrize("whole_dollar", [True, False])
def test_update_and_featurize_exact_matches_jax(mode, whole_dollar):
    """Three batches over more keys than the hot tier holds (rows that
    miss admission read the sketch tier): slots, admitted masks,
    features, tier counts and the whole state after each batch."""
    tcfg, jcfg = _cfgs(**mode)
    rng = np.random.default_rng(7)
    tst = tonline.init_feature_state(tcfg, CPU)
    jst = jonline.init_feature_state(jcfg)
    for step in range(3):
        tb, jb = _batch(rng, day0=DAY0 + 2 * step,
                        whole_dollar=whole_dollar)
        out = tonline.update_and_featurize_exact(tst, tb, tcfg)
        assert out[0] is tst  # updated in place
        jst, jf, jtier = jonline.update_and_featurize_exact(jst, jb, jcfg)
        _assert_features(out[1], jf, whole_dollar)
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(jtier))
        _assert_state(tst, jst, whole_dollar)
    dense, cms = out[2].numpy()
    valid = int(tb.valid.sum())
    keyspaces = 1 if tcfg.customer_source == "cms" else 2
    assert dense + cms == keyspaces * valid
    if "customer_capacity" in mode:
        assert cms == 0  # the hot tier holds every key
    elif tcfg.customer_source == "table":
        assert cms > 0


def test_admitted_slots_match_jax():
    """The slots the update scatters into and its admitted masks, per
    keyspace, equal the JAX package's over a stream that overflows."""
    tcfg, jcfg = _cfgs()
    rng = np.random.default_rng(3)
    tst = tonline.init_feature_state(tcfg, CPU)
    jst = jonline.init_feature_state(jcfg)
    for step in range(3):
        tb, jb = _batch(rng, day0=DAY0 + step)
        _, tcs, tca, tts, tta = tonline._update_state_exact(tst, tb, tcfg)
        jst, jcs, jca, jts, jta = jonline._update_state_exact(jst, jb, jcfg)
        for t, j in ((tcs, jcs), (tca, jca), (tts, jts), (tta, jta)):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(j).astype(t.numpy().dtype))
        _assert_state(tst, jst)


def test_exact_features_equal_direct_when_the_hot_tier_holds_every_key():
    tcfg, _ = _cfgs(customer_capacity=128, terminal_capacity=128)
    dcfg = dataclasses.replace(tcfg, key_mode="direct")
    rng = np.random.default_rng(1)
    est = tonline.init_feature_state(tcfg, CPU)
    dst = tonline.init_feature_state(dcfg, CPU)
    for step in range(3):
        tb, _ = _batch(rng, day0=DAY0 + step)
        _, fe, tier = tonline.update_and_featurize_exact(est, tb, tcfg)
        _, fd = tonline.update_and_featurize(dst, tb, dcfg)
        np.testing.assert_array_equal(fe.numpy(), fd.numpy())
        assert float(tier[1]) == 0.0


# ---------------------------------------------------------------------------
# the sketch's fraud column
# ---------------------------------------------------------------------------


def _sketch_rows(rng, n=300, day0=100):
    keys = rng.integers(0, 80, n).astype(np.uint32)
    days = rng.integers(day0, day0 + 4, n).astype(np.int32)
    amts = rng.integers(1, 300, n).astype(np.float32)
    fraud = rng.integers(0, 2, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    return keys, days, amts, fraud, valid


def test_fraud_column_update_add_and_query_match_jax():
    """``cms_init(track_fraud=True)``, ``cms_update(fraud=)``,
    ``cms_add_fraud`` (labels for wrapped days drop) and
    ``cms_query_fraud`` against the JAX package: every cell and every
    windowed estimate (whole-dollar amounts: exact in any order)."""
    rng = np.random.default_rng(5)
    tsk = tcms.cms_init(3, 1 << 6, 5, CPU, track_fraud=True)
    jsk = jcms.cms_init(3, 1 << 6, 5, track_fraud=True)
    for day0 in (100, 103, 107):
        keys, days, amts, fraud, valid = _sketch_rows(rng, day0=day0)
        tk = torch.from_numpy(keys)
        assert tcms.cms_update(tsk, tk, torch.from_numpy(amts),
                               torch.from_numpy(days),
                               torch.from_numpy(valid),
                               fraud=torch.from_numpy(fraud)) is tsk
        jsk = jcms.cms_update(jsk, jnp.asarray(keys), jnp.asarray(amts),
                              jnp.asarray(days), jnp.asarray(valid),
                              fraud=jnp.asarray(fraud))
        late = (days - rng.integers(0, 8, days.shape[0])).astype(np.int32)
        labels = rng.integers(0, 2, days.shape[0]).astype(np.int32)
        tcms.cms_add_fraud(tsk, tk, torch.from_numpy(late),
                           torch.from_numpy(labels), torch.from_numpy(valid))
        jsk = jcms.cms_add_fraud(jsk, jnp.asarray(keys), jnp.asarray(late),
                                 jnp.asarray(labels), jnp.asarray(valid))
        for name in ("slice_day", "count", "amount", "fraud"):
            np.testing.assert_array_equal(getattr(tsk, name).numpy(),
                                          np.asarray(getattr(jsk, name)))
        for delay in (0, 2):
            tq = tcms.cms_query_fraud(tsk, tk, torch.from_numpy(days),
                                      (1, 3), delay)
            jq = jcms.cms_query_fraud(jsk, jnp.asarray(keys),
                                      jnp.asarray(days), (1, 3), delay)
            for t, j in zip(tq, jq):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_fraud_column_absent_keeps_the_two_column_sketch():
    """Without the column every result is the two-column sketch's, bit
    for bit; the fraud query refuses and the label add is a no-op."""
    rng = np.random.default_rng(2)
    keys, days, amts, fraud, valid = _sketch_rows(rng)
    args = (torch.from_numpy(keys), torch.from_numpy(amts),
            torch.from_numpy(days), torch.from_numpy(valid))
    two = tcms.cms_update(tcms.cms_init(2, 32, 5, CPU), *args)
    three = tcms.cms_update(tcms.cms_init(2, 32, 5, CPU, track_fraud=True),
                            *args, fraud=torch.from_numpy(fraud))
    assert two.fraud is None
    for name in ("slice_day", "count", "amount"):
        np.testing.assert_array_equal(getattr(two, name).numpy(),
                                      getattr(three, name).numpy())
    assert tcms.cms_add_fraud(two, args[0], args[2], args[2],
                              args[3]) is two
    with pytest.raises(ValueError, match="fraud-tracking"):
        tcms.cms_query_fraud(two, args[0], args[2], (1,))


# ---------------------------------------------------------------------------
# compaction, demotion, promotion
# ---------------------------------------------------------------------------


def _aged_states(tcfg, jcfg, n_days=4, per_day=10):
    """Both packages' states after ``n_days`` batches of ``per_day``
    fresh customers (and terminals) each, one batch per day: entries of
    ``n_days`` distinct ages, ``per_day`` tied entries at each age."""
    tst = tonline.init_feature_state(tcfg, CPU)
    jst = jonline.init_feature_state(jcfg)
    for d in range(n_days):
        ids = np.arange(d * per_day, (d + 1) * per_day, dtype=np.int64)
        cols = dict(customer_id=ids, terminal_id=ids + 1000,
                    tx_datetime_us=np.full(per_day, (DAY0 + d) * 86400,
                                           np.int64) * 1_000_000,
                    amount_cents=np.full(per_day, 1234, np.int64),
                    label=np.zeros(per_day, np.int64))
        packed = tbatch.pack_batch(tbatch.make_batch(**cols, pad_to=16))
        tonline.update_and_featurize_exact(
            tst, tbatch.unpack_batch(torch.from_numpy(packed)), tcfg)
        jst, _, _ = jonline.update_and_featurize_exact(
            jst, jbatch.unpack_batch(jnp.asarray(packed)), jcfg)
    _assert_state(tst, jst, exact_amount=True)
    return tst, jst


def test_compaction_reclaims_dead_slots_and_matches_jax():
    tcfg, jcfg = _cfgs(customer_capacity=64, terminal_capacity=64)
    tst, jst = _aged_states(tcfg, jcfg)
    horizon = tcfg.delay_days + max(tcfg.windows)
    # not past the horizon: nothing reclaims; then the oldest day dies;
    # then everything does
    for now, want in ((DAY0 + horizon, 0), (DAY0 + horizon + 1, 20),
                      (DAY0 + horizon + 9, 60)):
        out = tonline.compact_feature_state(tst, now, tcfg)
        assert out[0] is tst
        jst, jrec = jonline.compact_feature_state(jst, jnp.int32(now), jcfg)
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(jrec))
        assert int(out[1].sum()) == want
        _assert_state(tst, jst, exact_amount=True)
    assert int(tst.customer_dir.free_top) == tcfg.customer_capacity
    assert bool((tst.customer.bucket_day == -1).all())


@pytest.mark.parametrize("demote,highwater", [(25, 0.1), (7, 0.1),
                                              (64, 0.5), (8, 1.0)],
                         ids=["tie-at-threshold", "within-oldest-age",
                              "capped-by-highwater", "below-highwater"])
def test_demote_oldest_selection_matches_jax(demote, highwater):
    """``_demote_oldest`` picks the set ``lax.top_k`` would — oldest
    first, ties at the threshold age to the lowest directory index — and
    gathers the same payload: both packages' payloads and every state
    leaf bit for bit, ties included."""
    tcfg, jcfg = _cfgs(customer_capacity=64, terminal_capacity=64,
                       cold_highwater=highwater)
    tst, jst = _aged_states(tcfg, jcfg)
    now = DAY0 + 4  # every entry is older than today: all eligible
    _, trec, tpay = tonline.compact_feature_state(tst, now, tcfg,
                                                  demote_slots=demote)
    jst, jrec, jpay = jonline.compact_feature_state(
        jst, jnp.int32(now), jcfg, demote_slots=demote)
    np.testing.assert_array_equal(trec.numpy(), np.asarray(jrec))
    for table in ("customer", "terminal"):
        for t, j in zip(tpay[table], jpay[table]):
            np.testing.assert_array_equal(_np(t), np.asarray(j))
    _assert_state(tst, jst, exact_amount=True)
    target = int(highwater * 64)
    want = min(max(40 - target, 0), demote)
    assert int(trec[0]) == want
    kept = tpay["customer"][0].numpy()
    assert int((kept != np.uint32(0xFFFFFFFF)).sum()) == want


def test_promote_rows_matches_jax_and_restores_the_demoted_rows():
    """Demote, then promote the payload back: both packages admit the
    same slots and merge the same rows (day dominance), the stats agree,
    and a second promotion of the same rows changes nothing."""
    tcfg, jcfg = _cfgs(customer_capacity=64, terminal_capacity=64,
                       cold_highwater=0.1)
    tst, jst = _aged_states(tcfg, jcfg)
    _, _, tpay = tonline.compact_feature_state(tst, DAY0 + 4, tcfg,
                                               demote_slots=16)
    jst, _, jpay = jonline.compact_feature_state(
        jst, jnp.int32(DAY0 + 4), jcfg, demote_slots=16)
    for _ in range(2):  # the second promotion is a no-op
        _, tstats = tonline.promote_rows(tst, tpay, tcfg)
        jst, jstats = jonline.promote_rows(jst, jpay, jcfg)
        np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
        _assert_state(tst, jst, exact_amount=True)
    assert int(tstats[0, 0]) == 16 and int(tstats[0, 1]) == 0
    # the promoted keys read their old rows again
    ids = np.arange(16, dtype=np.int64)
    slot, hit = tkeydir.admit_slots(
        tst.customer_dir, torch.from_numpy(tbatch.fold_key(ids)),
        torch.ones(16, dtype=torch.bool))[1:]
    assert bool(hit.all())
    assert bool((tst.customer.bucket_day[slot].amax(dim=1)
                 <= DAY0 + 1).all())


def test_state_bytes_matches_jax_and_the_live_state():
    for mode in (dict(), dict(customer_source="cms"),
                 dict(cms_width=1 << 8, cms_depth=3)):
        tcfg, jcfg = _cfgs(**mode)
        sb = tonline.state_bytes(tcfg)
        assert sb == jonline.state_bytes(jcfg)
        live = sum(leaf.numel() * leaf.element_size() for leaf in
                   jax.tree_util.tree_leaves(
                       tonline.init_feature_state(tcfg, CPU),
                       is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert sb["total"] == live
        assert sb["dense"] + sb["directory"] + sb["cms"] == sb["total"]


def test_exact_config_validation():
    ok = dict(key_mode="exact", compact_every=4)
    FeatureConfig(cold_store="/tmp/x", **ok)
    for bad, match in ((dict(keydir_probes=0), "keydir_probes"),
                       (dict(compact_every=-1), "compact_every"),
                       (dict(state_hbm_budget_mb=-1.0),
                        "state_hbm_budget_mb"),
                       (dict(cold_promote_queue=0), "cold_promote_queue"),
                       (dict(cold_segment_mb=0), "cold_segment_mb"),
                       (dict(cold_demote_slots=0), "cold_demote_slots"),
                       (dict(cold_highwater=1.5), "cold_highwater")):
        with pytest.raises(ValueError, match=match):
            FeatureConfig(**{**ok, **bad})
    with pytest.raises(ValueError, match="key_mode"):
        FeatureConfig(cold_store="/tmp/x", compact_every=4)
    with pytest.raises(ValueError, match="compact_every"):
        FeatureConfig(cold_store="/tmp/x", key_mode="exact")
    # the same defaults as the JAX package's
    j = JFeatureConfig()
    for name in ("keydir_probes", "compact_every", "state_hbm_budget_mb",
                 "cold_store", "cold_promote_queue", "cold_segment_mb",
                 "cold_demote_slots", "cold_highwater"):
        assert getattr(FeatureConfig(), name) == getattr(j, name)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class _ListSource:
    """Pre-made column batches for either package's engine."""

    def __init__(self, batches):
        self._batches = batches
        self._i = 0

    def poll_batch(self):
        if self._i >= len(self._batches):
            return None
        self._i += 1
        return {k: v.copy() for k, v in self._batches[self._i - 1].items()}

    @property
    def offsets(self):
        return [self._i]

    def seek(self, offsets):
        self._i = int(offsets[0])


def _stream(seed, n_batches=8, n=200, n_keys=500, day_step=6):
    """Column batches whose day advances ``day_step`` per batch, so a
    stream of eight passes the 37-day horizon and compaction reclaims."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        us = (((DAY0 + day_step * b) * 86400
               + rng.integers(0, 86400, n)).astype(np.int64) * 1_000_000)
        out.append({
            "tx_id": np.arange(b * n, (b + 1) * n, dtype=np.int64),
            "tx_datetime_us": us,
            "customer_id": rng.integers(0, n_keys, n).astype(np.int64),
            "terminal_id": rng.integers(0, n_keys, n).astype(np.int64),
            "tx_amount_cents": rng.integers(100, 50000, n).astype(np.int64),
            "kafka_ts_ms": us // 1000,
            "label": rng.integers(-1, 2, n).astype(np.int64),
        })
    return out


def _jax_params(kind):
    if kind == "logreg":
        rng = np.random.default_rng(9)
        return JLogRegParams(
            w=jnp.asarray(rng.normal(0, 0.8, 15).astype(np.float32)),
            b=jnp.float32(-1.0))
    if kind == "gbt":
        return jgbt.synthetic_gbt(8, 4, 15, seed=3)
    return jforest.synthetic_ensemble(10, 5, 15, seed=3)


def _scaler():
    rng = np.random.default_rng(3)
    return (rng.normal(3, 1, 15).astype(np.float32),
            rng.uniform(0.5, 3, 15).astype(np.float32))


def _engines(kind, fields, depth, treg=None, jreg=None):
    mean, scale = _scaler()
    jparams = _jax_params(kind)
    jeng = JScoringEngine(
        JConfig(features=JFeatureConfig(**fields),
                runtime=JRuntimeConfig(batch_buckets=(256,),
                                       max_batch_rows=256,
                                       pipeline_depth=depth)),
        kind=kind, params=jparams,
        scaler=JScaler(jnp.asarray(mean), jnp.asarray(scale)),
        metrics=jreg or JMetricsRegistry())
    teng = ScoringEngine(
        Config(features=FeatureConfig(**fields),
               runtime=RuntimeConfig(batch_buckets=(256,),
                                     pipeline_depth=depth)),
        kind, weights.from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu"),
        Scaler(torch.from_numpy(mean), torch.from_numpy(scale)),
        device="cpu", metrics=treg or MetricsRegistry())
    return jeng, teng


ENGINE_CASES = [("logreg", 1), ("logreg", 2), ("forest", 1), ("forest", 2),
                ("gbt", 2)]


@pytest.mark.parametrize("kind,depth", ENGINE_CASES,
                         ids=[f"{k}-depth{d}" for k, d in ENGINE_CASES])
def test_engine_matches_jax_exact_engine(monkeypatch, kind, depth):
    """Both engines serve a stream that overflows the hot tier and passes
    the compaction horizon, at pipeline depth 1 and 2: the sink outputs,
    the tier and reclaim counters and the final state (every directory
    leaf bit for bit) agree, and the tree kinds went through the leaf-sum
    kernel's wrapper once per batch, the fused kernels never."""
    fields = dict(customer_capacity=64, terminal_capacity=64,
                  cms_width=1 << 10, key_mode="exact", compact_every=2)
    calls = {}
    for name in ("leaf_sum_plain", "fused_forest_leaf_sum_plain"):
        orig = getattr(forest_kernels, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(forest_kernels, name, counted)
    treg, jreg = MetricsRegistry(), JMetricsRegistry()
    jeng, teng = _engines(kind, fields, depth, treg, jreg)
    batches = _stream(11)
    jsink, tsink = JMemorySink(), MemorySink()
    jeng.run(_ListSource(batches), sink=jsink)
    stats = teng.run(_ListSource(batches), tsink)
    assert stats["batches"] == 8 and stats["pipeline_depth"] == depth
    assert calls == ({} if kind == "logreg" else {"leaf_sum_plain": 8})
    jout, tout = jsink.concat(), tsink.concat()
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col],
                                       **TOL_PROB[kind])
        elif "avg_amount" in col:
            np.testing.assert_allclose(tout[col], jout[col],
                                       rtol=RTOL_SUM_ORDER)
        else:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)
    for name, labels in (("rtfds_feature_tier_rows_total", ("tier", "dense")),
                         ("rtfds_feature_tier_rows_total", ("tier", "cms")),
                         ("rtfds_feature_slots_reclaimed_total",
                          ("table", "customer")),
                         ("rtfds_feature_slots_reclaimed_total",
                          ("table", "terminal")),
                         ("rtfds_feature_slots_occupied",
                          ("table", "terminal"))):
        t = treg.get(name, **dict([labels])).value
        assert t == jreg.get(name, **dict([labels])).value, (name, labels)
    assert treg.get("rtfds_feature_tier_rows_total", tier="cms").value > 0
    assert treg.family_total("rtfds_feature_slots_reclaimed_total") > 0
    _assert_state(teng.state.feature_state, jeng.state.feature_state)


def test_exact_engine_bit_identical_to_direct():
    """With the hot tier sized to hold every key, the exact engine's
    probabilities and features equal the direct engine's bit for bit
    (direct serves the fused forest kernel's plain version, exact the
    composition and the leaf sum), and every read is a dense one."""
    base = dict(customer_capacity=512, terminal_capacity=512,
                cms_width=1 << 10)
    treg = MetricsRegistry()
    _, ed = _engines("forest", base, 2)
    _, ee = _engines("forest", dict(base, key_mode="exact",
                                    compact_every=3), 2, treg)
    assert ed.tables is not None and ee.tables is None
    assert ee.leaf_tables is not None
    batches = _stream(4, n_keys=400, day_step=1)
    sd, se = MemorySink(), MemorySink()
    ed.run(_ListSource(batches), sd)
    ee.run(_ListSource(batches), se)
    od, oe = sd.concat(), se.concat()
    for col in od:
        if col != "processed_at_us":
            np.testing.assert_array_equal(oe[col], od[col], err_msg=col)
    assert treg.get("rtfds_feature_tier_rows_total",
                    tier="dense").value == 8 * 200 * 2
    assert treg.get("rtfds_feature_tier_rows_total", tier="cms").value == 0


def test_state_budget_validated_at_engine_build():
    fields = dict(customer_capacity=128, terminal_capacity=256,
                  cms_width=1 << 12, key_mode="exact")
    with pytest.raises(ValueError, match="state_hbm_budget_mb"):
        _engines("logreg", dict(fields, state_hbm_budget_mb=0.5), 1)
    sb = tonline.state_bytes(FeatureConfig(**fields))
    reg = MetricsRegistry()
    _engines("logreg", dict(fields, state_hbm_budget_mb=sb["total"] / 2 ** 20
                            + 1.0), 1, reg)
    assert reg.get("rtfds_feature_state_bytes",
                   tier="total").value == sb["total"]


def test_compaction_meters_the_registry_and_the_flight_record(tmp_path):
    """Each compaction reaches the metrics (reclaimed and occupied slots,
    per table) and the flight record's ``feature_state`` event, with the
    tier reads so far, as the JAX engine records them."""
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        FlightRecorder,
        set_active_recorder,
    )

    fields = dict(customer_capacity=64, terminal_capacity=64,
                  cms_width=1 << 10, key_mode="exact", compact_every=2)
    reg = MetricsRegistry()
    _, eng = _engines("logreg", fields, 1, treg=reg)
    rec = FlightRecorder(str(tmp_path / "flight.jsonl"))
    set_active_recorder(rec)
    try:
        eng.run(_ListSource(_stream(2)))
    finally:
        set_active_recorder(None)
        rec.close()
    _, records = FlightRecorder.read(str(tmp_path / "flight.jsonl"))
    events = [r for r in records if r.get("event") == "feature_state"]
    assert [e["batch"] for e in events] == [2, 4, 6, 8]
    fs = eng.state.feature_state
    occ = {t: 64 - int(getattr(fs, f"{t}_dir").free_top)
           for t in ("customer", "terminal")}
    assert events[-1]["occupied"] == sum(occ.values())
    assert events[-1]["capacity"] == 128
    assert sum(e["reclaimed"] for e in events) == reg.family_total(
        "rtfds_feature_slots_reclaimed_total") > 0
    assert events[-1]["dense_rows"] + events[-1]["cms_rows"] == 8 * 200 * 2
    for t, o in occ.items():
        assert reg.get("rtfds_feature_slots_occupied", table=t).value == o
