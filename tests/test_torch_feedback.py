"""Port parity: the labeled-feedback plane against the JAX package.

- the feedback envelopes, byte for byte both ways;
- ``FeatureCache`` (the cases of ``tests/test_feedback.py::TestFeatureCache``
  and a random put/mark/get script, each answer equal to the JAX cache's);
- ``features/online.py::apply_feedback`` in direct, hash and exact mode on
  a state both packages built from the same stream: every leaf bit for bit
  (the labels are 0/1 adds, exact in any order); in exact mode the hits
  land in the dense rows, the misses in the terminal sketch's fraud
  column, and the directory is never written; a label whose bucket the
  ring has wrapped past never lands;
- ``FeedbackLoop`` end to end, in ``engine.run(feedback=)``, against the
  JAX loop on the same stream at depths 1 and 2: labels 3 batches late,
  in-band labels on the first batch (never landed again), a replay of
  earlier labels (idempotent) and conflicting duplicates in one poll (the
  newest ``ts_ms`` wins). The stats and the feature state equal the JAX
  engine's (counts, days and fraud sums bit for bit, amounts within
  ``rtol=1e-6``), the params within ``atol=2e-6`` (the feedback SGD's
  gradient differs by ulps, as in ``tests/test_torch_online_sgd.py``);
- ``apply_feedback``'s chunking and backtracking against the JAX engine:
  the same accept/halve sequence, params within ``1e-6 × max|w|`` (steps
  large enough to overshoot move the params by about their own size, and
  the gradient's ulps scale with it);
- a tree kind updates the state only, and the SGD refuses it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.core import batch as jbatch
from real_time_fraud_detection_system_tpu.features import online as jonline
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.runtime import (
    FEEDBACK_TOPIC as JFEEDBACK_TOPIC,
)
from real_time_fraud_detection_system_tpu.runtime import (
    FeatureCache as JFeatureCache,
)
from real_time_fraud_detection_system_tpu.runtime import (
    FeedbackLoop as JFeedbackLoop,
)
from real_time_fraud_detection_system_tpu.runtime import (
    InProcBroker as JInProcBroker,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu.runtime import (
    decode_feedback_envelopes as jdecode,
)
from real_time_fraud_detection_system_tpu.runtime import (
    encode_feedback_envelopes as jencode,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.core.batch import fold_key
from real_time_fraud_detection_system_tpu_torch.features import (
    online as tonline,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    synthetic_ensemble,
)
from real_time_fraud_detection_system_tpu_torch.runtime import (
    engine as tengine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.feedback import (
    FEEDBACK_TOPIC,
    FeatureCache,
    FeedbackLoop,
    KafkaFeedbackSource,
    decode_feedback_envelopes,
    encode_feedback_envelopes,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    InProcBroker,
    ReplaySource,
)
from test_torch_online_sgd import (  # pytest adds tests/
    FEATURE_SCALE,
    configs,
    logreg_pair,
    params_np,
    port_txs,
)

torch.set_num_threads(1)

START = 1_743_465_600
ATOL_PARAMS = 2e-6


# -- envelopes and the cache ----------------------------------------------

def test_envelopes_are_byte_equal_both_ways():
    ids, ys = [5, 9, 123456789012], [1, 0, 1]
    assert FEEDBACK_TOPIC == JFEEDBACK_TOPIC
    mine = encode_feedback_envelopes(ids, ys, ts_ms=42)
    assert mine == jencode(ids, ys, ts_ms=42)
    bad = [b"garbage", b"{}", b'{"tx_id": 7}', b'{"label": 1}',
           b'{"tx_id": 3, "label": 1, "ts_ms": "x"}']
    stream = mine[:1] + bad + mine[1:]
    for got, want in zip(decode_feedback_envelopes(stream), jdecode(stream)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(decode_feedback_envelopes(stream)[0],
                                  [5, 3, 9, 123456789012])


def test_feature_cache_cases_of_the_jax_suite():
    c = FeatureCache(capacity=16, n_features=3)
    ids = np.array([1, 2, 3], dtype=np.int64)
    feats = np.arange(9, dtype=np.float32).reshape(3, 3)
    c.put_batch(ids, feats)
    assert len(c) == 3
    got, hit = c.get_batch(np.array([2, 7, 1]))
    np.testing.assert_array_equal(hit, [True, False, True])
    np.testing.assert_array_equal(got, feats[[1, 0]])
    c = FeatureCache(capacity=8, n_features=2)
    c.put_batch(np.array([1]), np.ones((1, 2), np.float32))
    c.put_batch(np.array([9]), 2 * np.ones((1, 2), np.float32))  # 9%8==1
    assert not c.get_batch(np.array([1]))[1][0]  # evicted
    got, hit = c.get_batch(np.array([9]))
    assert hit[0] and (got == 2).all()
    c = FeatureCache(capacity=8, n_features=1)
    c.put_batch(np.array([3, 3]), np.array([[1.0], [2.0]], np.float32))
    got, hit = c.get_batch(np.array([3]))
    assert hit[0] and got[0, 0] == 2.0


def test_feature_cache_answers_as_the_jax_cache():
    rng = np.random.default_rng(0)
    mine, ref = FeatureCache(capacity=64), JFeatureCache(capacity=64)
    for step in range(12):
        n = int(rng.integers(1, 40))
        ids = rng.integers(-3, 200, n).astype(np.int64)
        feats = rng.normal(size=(n, 15)).astype(np.float32)
        term = rng.integers(0, 50, n).astype(np.int64)
        days = rng.integers(0, 90, n).astype(np.int32)
        lab = rng.random(n) < 0.3
        marks = rng.integers(0, 200, 5).astype(np.int64)
        for c in (mine, ref):
            c.put_batch(ids, feats, terminal_ids=term, days=days,
                        labeled=lab)
            c.mark_labeled(marks)
        probe = rng.integers(-2, 220, 30).astype(np.int64)
        for got, want in zip(mine.get_batch_full(probe),
                             ref.get_batch_full(probe)):
            np.testing.assert_array_equal(got, want, err_msg=str(step))
        assert len(mine) == len(ref)
        assert mine._occupancy == ref._occupancy


def test_kafka_feedback_source_names_its_missing_client():
    with pytest.raises(ModuleNotFoundError, match="confluent_kafka"):
        KafkaFeedbackSource("localhost:9092")


# -- apply_feedback on the feature state ----------------------------------

def _built_states(small_dataset, **features):
    """Both packages' feature states after the same 1,024-row stream
    (the JAX one served, the port's carried across from it)."""
    jtxs = small_dataset[3].slice(slice(0, 1024))
    jcfg, tcfg = configs(1, **features)
    jp, js, _, _ = logreg_pair(1, scale=FEATURE_SCALE)
    jeng = JScoringEngine(jcfg, kind="logreg", params=jp, scaler=js)
    jeng.run(JReplaySource(jtxs, START, batch_rows=256))
    import jax

    tfs = weights.from_numpy(
        jax.tree.map(np.asarray, jeng.state.feature_state), device="cpu")
    return jeng.state.feature_state, tfs, jcfg, tcfg, jtxs


def _feedback_rows(jtxs, rng, n=300, wrapped=40):
    """Labels for scored rows (their terminal and day), a few for days the
    ring has wrapped past, and invalid padding."""
    idx = rng.integers(0, len(jtxs.tx_id), n)
    term = np.asarray(jtxs.terminal_id)[idx]
    day = np.asarray(jtxs.tx_time_days)[idx].astype(np.int32) + 20181
    day[:wrapped] -= 45  # a day older than the 40-bucket ring holds
    label = (rng.random(n) < 0.5).astype(np.int32)
    valid = rng.random(n) < 0.95
    return fold_key(term), day, label, valid


def _leaves(fs):
    out = {}
    for name in fs._fields:
        rec = getattr(fs, name)
        if rec is None:
            continue
        for f in rec._fields:
            leaf = getattr(rec, f)
            out[f"{name}.{f}"] = np.array(  # a copy: the scatter is in place
                leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf)
    return out


@pytest.mark.parametrize("mode", ["direct", "hash", "exact"])
def test_apply_feedback_is_bit_for_bit_the_jax_one(small_dataset, mode):
    features = {"key_mode": mode}
    if mode == "exact":
        # a hot tier smaller than the terminal universe: hits and misses
        features.update(terminal_capacity=64, customer_capacity=128)
    jfs, tfs, jcfg, tcfg, jtxs = _built_states(small_dataset, **features)
    rng = np.random.default_rng(4)
    key, day, label, valid = _feedback_rows(jtxs, rng)
    before = _leaves(tfs)
    want = jonline.apply_feedback(
        jfs, jnp.asarray(key), jnp.asarray(day), jnp.asarray(label),
        jnp.asarray(valid), jcfg.features)
    got = tonline.apply_feedback(
        tfs, torch.from_numpy(key.view(np.int32)).view(torch.uint32),
        torch.from_numpy(day), torch.from_numpy(label),
        torch.from_numpy(valid), tcfg.features)
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    after = g
    changed = [k for k in after if not np.array_equal(after[k], before[k])]
    if mode == "exact":
        # hits into the dense rows, misses into the sketch's fraud column,
        # and nothing else (no directory insert)
        assert sorted(changed) == ["terminal.fraud", "terminal_cms.fraud"]
        _, hit = tonline.lookup_slots(
            tfs.terminal_dir,
            torch.from_numpy(key.view(np.int32)).view(torch.uint32),
            torch.from_numpy(valid), tcfg.features.keydir_probes)
        assert 0 < int(hit.sum()) < int(valid.sum())
    else:
        assert changed == ["terminal.fraud"]


def test_a_label_for_a_wrapped_bucket_never_lands(small_dataset):
    jfs, tfs, jcfg, tcfg, jtxs = _built_states(small_dataset)
    before = tfs.terminal.fraud.clone()
    t = int(jtxs.terminal_id[0])
    slot = t & (tcfg.features.terminal_capacity - 1)
    bd = tfs.terminal.bucket_day[slot]
    live_day = int(bd.max())
    old_day = live_day - tcfg.features.n_day_buckets  # same bucket, wrapped
    key = torch.from_numpy(fold_key(np.array([t, t])).view(np.int32)) \
        .view(torch.uint32)
    tonline.apply_feedback(tfs, key, torch.tensor([old_day, live_day],
                                                  dtype=torch.int32),
                           torch.tensor([1, 1], dtype=torch.int32),
                           torch.tensor([True, True]), tcfg.features)
    diff = (tfs.terminal.fraud - before).nonzero().tolist()
    bucket = live_day % tcfg.features.n_day_buckets
    assert diff == [[slot, bucket]]
    assert float(tfs.terminal.fraud[slot, bucket] - before[slot, bucket]) \
        == 1.0


# -- FeedbackLoop end to end ----------------------------------------------

LAG = 3  # a batch's labels arrive this many batches later


class _DelayedLabels:
    """A source wrapper that publishes batch k's true labels while batch
    k+LAG is polled; in-band labels ride only on the first batch. At poll
    5 it re-publishes batch 0's labels (a replay) and two conflicting
    events for one transaction (the newer, ts 2, says legit)."""

    def __init__(self, inner, broker, encode, topic):
        self.inner, self.broker = inner, broker
        self.encode, self.topic = encode, topic
        self.polled = []

    def _publish(self, ids, ys, ts=0):
        self.broker.produce_many(self.topic, [b""] * len(ids),
                                 self.encode(ids, ys, ts_ms=ts))

    def poll_batch(self):
        cols = self.inner.poll_batch()
        k = len(self.polled)
        if k >= LAG:
            ids, ys = self.polled[k - LAG]
            self._publish(ids, ys)
        if k == 5:
            self._publish(*self.polled[0])
            t = self.polled[2][0][:1]
            self._publish(t, [0], ts=2)
            self._publish(t, [1], ts=1)
        if cols is not None:
            self.polled.append((np.array(cols["tx_id"]),
                                np.array(cols["label"])))
            if k > 0:
                cols = {c: v for c, v in cols.items() if c != "label"}
        return cols

    @property
    def offsets(self):
        return self.inner.offsets

    def seek(self, o):
        self.inner.seek(o)


@pytest.fixture(scope="module")
def loop_runs(small_dataset):
    jtxs = small_dataset[3].slice(slice(0, 2048))
    txs = port_txs(jtxs)
    jp, js, tp, ts = logreg_pair(2, scale=FEATURE_SCALE)
    out = {}
    for depth in (1, 2):
        jcfg, tcfg = configs(depth)
        jeng = JScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                              feature_cache=JFeatureCache(1 << 12))
        jb = JInProcBroker(2)
        jloop = JFeedbackLoop(jeng, jb)
        jsink = JMemorySink()
        jeng.run(_DelayedLabels(JReplaySource(jtxs, START, batch_rows=256,
                                              with_labels=True),
                                jb, jencode, JFEEDBACK_TOPIC),
                 sink=jsink, feedback=jloop)
        teng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu",
                             feature_cache=FeatureCache(1 << 12))
        tb = InProcBroker(2)
        tloop = FeedbackLoop(teng, tb)
        tsink = MemorySink()
        teng.run(_DelayedLabels(ReplaySource(txs, START, batch_rows=256,
                                             with_labels=True),
                                tb, encode_feedback_envelopes,
                                FEEDBACK_TOPIC),
                 tsink, feedback=tloop)
        out[depth] = dict(jeng=jeng, jloop=jloop, jout=jsink.concat(),
                          teng=teng, tloop=tloop, tout=tsink.concat(),
                          tp=tp)
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_feedback_loop_matches_the_jax_loop(loop_runs, depth):
    run = loop_runs[depth]
    jeng, teng = run["jeng"], run["teng"]
    assert run["tloop"].stats == run["jloop"].stats
    st = run["tloop"].stats
    assert st["applied"] > 0 and st["duplicates"] >= 1
    # replays and in-band labels were skipped, not re-landed
    assert st["applied"] < st["events"] - st["duplicates"]
    jfs, tfs = jeng.state.feature_state, teng.state.feature_state
    for table in ("customer", "terminal"):
        for name in ("bucket_day", "count", "fraud"):
            np.testing.assert_array_equal(
                getattr(getattr(tfs, table), name).numpy(),
                np.asarray(getattr(getattr(jfs, table), name)),
                err_msg=f"{table}.{name}")
        np.testing.assert_allclose(getattr(tfs, table).amount.numpy(),
                                   np.asarray(getattr(jfs, table).amount),
                                   rtol=1e-6)
    assert float(tfs.terminal.fraud.sum()) > 0
    for a, b in zip(params_np(teng.state.params),
                    params_np(jeng.state.params)):
        np.testing.assert_allclose(a, b, atol=ATOL_PARAMS)
    assert np.abs(teng.state.params.w.numpy() - run["tp"].w.numpy()).max() \
        > 1e-4  # the feedback SGD moved the model
    np.testing.assert_allclose(run["tout"]["prediction"],
                               run["jout"]["prediction"], atol=1e-6)
    for w in (1, 7, 30):
        col = f"terminal_id_risk_{w}day_window"
        np.testing.assert_array_equal(run["tout"][col], run["jout"][col])


def test_feedback_within_poll_newest_ts_wins(small_dataset):
    """The JAX suite's case: the newer legit label drains first, the stale
    fraud label after it; the legit one wins and no fraud lands."""
    from real_time_fraud_detection_system_tpu_torch.core.batch import (
        US_PER_DAY,
    )

    _, tcfg = configs(1)
    _, _, tp, ts = logreg_pair(3)
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu",
                        feature_cache=FeatureCache(1 << 10))
    cols = {"tx_id": np.zeros(1, np.int64),
            "tx_datetime_us": np.full(1, 20200, np.int64) * US_PER_DAY + 1,
            "customer_id": np.zeros(1, np.int64),
            "terminal_id": np.full(1, 7, np.int64),
            "tx_amount_cents": np.full(1, 1000, np.int64),
            "kafka_ts_ms": np.zeros(1, np.int64)}
    eng.process_batch(cols)
    broker = InProcBroker(1)
    msgs = (encode_feedback_envelopes([0], [0], ts_ms=2)
            + encode_feedback_envelopes([0], [1], ts_ms=1))
    broker.produce_many(FEEDBACK_TOPIC, [b"", b""], msgs)
    loop = FeedbackLoop(eng, broker)
    assert loop.poll_and_apply() == 1
    assert loop.stats == {"events": 2, "applied": 1, "missed": 0,
                          "duplicates": 1}
    assert float(eng.state.feature_state.terminal.fraud.sum()) == 0.0
    # a new consumer replays the same events: nothing lands again
    assert FeedbackLoop(eng, broker).poll_and_apply() == 0


def test_feedback_loop_needs_a_cache_and_counts_misses():
    _, tcfg = configs(1)
    _, _, tp, ts = logreg_pair(3)
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu")
    with pytest.raises(ValueError, match="FeatureCache"):
        FeedbackLoop(eng, InProcBroker(2))
    cache = FeatureCache(capacity=64)
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu",
                        feature_cache=cache)
    broker = InProcBroker(2)
    broker.produce_many(FEEDBACK_TOPIC, [b"k", b"k2"],
                        encode_feedback_envelopes([999_999, -1], [1, 1]))
    loop = FeedbackLoop(eng, broker)
    assert loop.cache is cache
    assert loop.poll_and_apply() == 0
    assert loop.stats["missed"] == 2


# -- apply_feedback: chunking and backtracking ----------------------------

def test_apply_feedback_backtracks_as_the_jax_engine(monkeypatch):
    """A backlog larger than the biggest bucket, raw features large enough
    that the first steps overshoot: the same accept/halve sequence as the
    JAX engine (``bool(l1 <= l0)`` per try), the same params."""
    jcfg, tcfg = configs(1, buckets=(64, 256))
    jp, js, tp, ts = logreg_pair(5)
    jeng = JScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                          online_lr=8.0)
    teng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu", online_lr=8.0)
    rng = np.random.default_rng(0)
    n = 256 * 2 + 37
    x = rng.normal(0, 5, (n, 15)).astype(np.float32)
    y = (x[:, 0] + x[:, 3] > 0).astype(np.int32)
    y[::7] = -1  # pending labels never train
    jseq, tseq = [], []
    jeng.apply_feedback(np.zeros((1, 15), np.float32),
                        np.array([-1], np.int32))  # builds its step
    jstep = jeng._feedback_step

    def jrec(*a):
        out = jstep(*a)
        jseq.append(bool(out[2] <= out[1]))
        return out

    jeng._feedback_step = jrec
    tstep = tengine.feedback_step

    def trec(*a):
        out = tstep(*a)
        tseq.append(bool(out[2] <= out[1]))
        return out

    monkeypatch.setattr(tengine, "feedback_step", trec)
    w = teng.state.params.w
    for _ in range(3):
        jeng.apply_feedback(x, y)
        teng.apply_feedback(x, y)
    assert tseq == jseq
    assert False in tseq and True in tseq  # halvings happened, steps landed
    assert teng.state.params.w is w  # copied in place
    scale = float(np.abs(np.asarray(jeng.state.params.w)).max())
    for a, b in zip(params_np(teng.state.params),
                    params_np(jeng.state.params)):
        np.testing.assert_allclose(a, b, atol=1e-6 * scale)


def test_apply_feedback_masks_unlabeled_rows():
    _, tcfg = configs(1)
    _, _, tp, ts = logreg_pair(3)
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu")
    w0 = eng.state.params.w.clone()
    eng.apply_feedback(np.ones((8, 15), np.float32), np.full(8, -1, np.int32))
    assert torch.equal(eng.state.params.w, w0)
    assert not eng._online_dirty
    eng.apply_feedback(np.ones((8, 15), np.float32),
                       np.array([1, -1, -1, -1, -1, -1, -1, -1], np.int32))
    assert not torch.equal(eng.state.params.w, w0)
    assert eng._online_dirty


# -- tree kinds -----------------------------------------------------------

def test_tree_kind_updates_state_only_and_refuses_sgd(small_dataset):
    jtxs = small_dataset[3].slice(slice(0, 512))
    txs = port_txs(jtxs)
    jcfg, tcfg = configs(2)
    jens = jforest.synthetic_ensemble(4, 3, 15, seed=1)
    tens = synthetic_ensemble(4, 3, 15, seed=1, device="cpu")
    _, js, _, ts = logreg_pair(1, scale=FEATURE_SCALE)
    jeng = JScoringEngine(jcfg, kind="forest", params=jens, scaler=js,
                          feature_cache=JFeatureCache(1 << 10))
    teng = ScoringEngine(tcfg, "forest", tens, ts, device="cpu",
                         feature_cache=FeatureCache(1 << 10))
    assert not teng.supports_online_sgd
    jeng.run(JReplaySource(jtxs, START, batch_rows=256))
    teng.run(ReplaySource(txs, START, batch_rows=256))
    jb, tb = JInProcBroker(2), InProcBroker(2)
    jb.produce_many(JFEEDBACK_TOPIC, [b""] * len(jtxs.tx_id),
                    jencode(jtxs.tx_id, jtxs.tx_fraud))
    tb.produce_many(FEEDBACK_TOPIC, [b""] * len(jtxs.tx_id),
                    encode_feedback_envelopes(jtxs.tx_id, jtxs.tx_fraud))
    got = FeedbackLoop(teng, tb).poll_and_apply()
    assert got == JFeedbackLoop(jeng, jb).poll_and_apply() > 0
    np.testing.assert_array_equal(
        teng.state.feature_state.terminal.fraud.numpy(),
        np.asarray(jeng.state.feature_state.terminal.fraud))
    with pytest.raises(ValueError, match="no gradient path"):
        teng.apply_feedback(np.zeros((4, 15), np.float32),
                            np.ones(4, np.int32))


def test_feature_cache_refuses_alerts_only_serving():
    import dataclasses

    _, tcfg = configs(1)
    tcfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
        tcfg.runtime, emit_features=False))
    _, _, tp, ts = logreg_pair(3)
    with pytest.raises(ValueError, match="alerts-only"):
        ScoringEngine(tcfg, "logreg", tp, ts, device="cpu",
                      feature_cache=FeatureCache(64))
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu")
    with pytest.raises(ValueError, match="alerts-only"):
        eng.set_shadow(object())
