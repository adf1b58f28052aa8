"""Port parity: the per-customer history state (``features/history.py``)
and the sequence kind served by ``ScoringEngine``, ``run_with_recovery``
and ``score``, against the JAX package.

Small sizes: d_model 16, 1-2 layers, K = 8 (naive attention) and K = 40
with ``seq_attn_block=16`` (blockwise), customer capacity 64. The weights
are the JAX package's ``init_transformer``, carried over by
``weights.from_numpy``; the streams are numpy from a seed, or the small
generated dataset.

Tolerances, and why they hold:

- ``pos``, ``count`` and ``last_t`` equal on rows ``[:C]``: integer
  bookkeeping on both sides. Row ``C`` is the sink that padding and
  unwritten rows scatter to, in no fixed order in either package (and
  ``index_put_`` on CUDA is nondeterministic there), so it is never
  compared;
- ``events`` within ``atol=1e-6``: the event channels are log1p, sin and
  cos of the same float32 inputs, which XLA and torch round within an ulp
  or two;
- probabilities within ``atol=1e-5``: the transformer's products add in
  other orders on the two sides (``tests/test_torch_sequence.py``), and
  the sigmoid keeps the difference below that;
- against the port's own offline oracle (``build_sequences``-style
  windows through the full ``transformer_logits``) within ``3e-4``, the
  JAX package's own tolerance for the same check
  (``tests/test_history.py``): the oracle's features come from float64
  times, the state's from float32;
- a supervised crash replay equals the clean run bit for bit: the same
  arithmetic in the same order on the same device.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.cli import main as jcli_main
from real_time_fraud_detection_system_tpu.config import Config as JConfig
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.core.batch import (
    make_batch as jmake_batch,
)
from real_time_fraud_detection_system_tpu.features import history as jhist
from real_time_fraud_detection_system_tpu.io import artifacts as jart
from real_time_fraud_detection_system_tpu.io import checkpoint as jckpt
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.io.sink import ParquetSink
from real_time_fraud_detection_system_tpu.models import sequence as jseq
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.core.batch import TxBatch
from real_time_fraud_detection_system_tpu_torch.features import (
    history as thist,
)
from real_time_fraud_detection_system_tpu_torch.io import checkpoint as tckpt
from real_time_fraud_detection_system_tpu_torch.io.registry import (
    make_model_registry,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models import sequence as tseq
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    FlakySource,
    run_with_recovery,
)
from real_time_fraud_detection_system_tpu_torch.runtime.feedback import (
    FeatureCache,
)
from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
    ShadowScorer,
    StreamingLearner,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)
from test_torch_online_sgd import port_txs  # pytest adds tests/

torch.set_num_threads(1)

START = 1_743_465_600
CAP = 64
ATOL_EVENTS = 1e-6
ATOL_PROB = 1e-5
ATOL_ORACLE = 3e-4


def jparams(n_layers=2, seed=3):
    return jseq.init_transformer(d_model=16, n_heads=2, n_layers=n_layers,
                                 d_ff=32, seed=seed)


# the JAX step compiled once per (config, batch shape), as its engine runs it
_JSTEP = jax.jit(jhist.update_and_score, static_argnames=("cfg",))


def port(obj):
    return weights.from_numpy(jax.tree.map(np.asarray, obj), "cpu")


def fcfgs(k, key_mode="direct", **kw):
    fk = dict(customer_capacity=CAP, terminal_capacity=CAP, history_len=k,
              seq_attn_block=16, key_mode=key_mode, **kw)
    return JFeatureConfig(**fk), FeatureConfig(**fk)


def _stream(n=300, n_cust=13, seed=0, oversized=0):
    """Customer ids, epoch-second times (non-decreasing, with same-second
    ties) and amounts; ``oversized`` rows of one customer lead the
    stream."""
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, n_cust, n).astype(np.int64)
    cust[:oversized] = 5
    t_s = np.sort(rng.integers(0, 20 * 86400, n)).astype(np.int64) \
        + 20_000 * 86400
    t_s[10:14] = t_s[10]  # same-second events
    amount = rng.integers(100, 50_000, n).astype(np.int64)
    return cust, t_s, amount


def _run_both(k, bs, key_mode="direct", n_layers=2, oversized=0,
              order_key=False, n=300):
    jc, tc = fcfgs(k, key_mode)
    jp = jparams(n_layers)
    tp = port(jp)
    cust, t_s, amount = _stream(n=n, oversized=oversized)
    js = jhist.init_history_state(jc)
    ts = thist.init_history_state(tc, "cpu")
    pj, pt = np.zeros(n), np.zeros(n)
    for s in range(0, n, bs):
        e = min(s + bs, n)
        b = jmake_batch(customer_id=cust[s:e],
                        terminal_id=np.zeros(e - s, np.int64),
                        tx_datetime_us=t_s[s:e] * 1_000_000,
                        amount_cents=amount[s:e], pad_to=bs)
        okey = (np.arange(bs, dtype=np.int32)[::-1].copy()
                if order_key else None)
        js, p = _JSTEP(js, jp, jax.tree.map(jnp.asarray, b), cfg=jc,
                       order_key=None if okey is None else jnp.asarray(okey))
        tb = TxBatch(*[torch.from_numpy(np.asarray(x)) for x in b])
        ts2, q = thist.update_and_score(
            ts, tp, tb, tc,
            order_key=None if okey is None else torch.from_numpy(okey))
        assert ts2 is ts and ts2.events is ts.events  # written in place
        pj[s:e] = np.asarray(p)[:e - s]
        pt[s:e] = q.numpy()[:e - s]
        # padding rows score 0
        assert (q.numpy()[e - s:] == 0).all()
    return js, ts, pj, pt, (cust, t_s, amount, tp, tc)


def assert_history_equal(ts, js, what=""):
    """Rows [:C] only: row C is the sink (see the module docstring)."""
    for name in ("pos", "count", "last_t"):
        np.testing.assert_array_equal(
            getattr(ts, name).numpy()[:-1],
            np.asarray(getattr(js, name))[:-1], err_msg=f"{what} {name}")
    np.testing.assert_allclose(ts.events.numpy()[:-1],
                               np.asarray(js.events)[:-1], atol=ATOL_EVENTS,
                               err_msg=f"{what} events")


@pytest.mark.parametrize("k", [8, 40])
@pytest.mark.parametrize("bs", [16, 256])
@pytest.mark.parametrize("key_mode", ["direct", "hash"])
def test_update_and_score_matches_jax(k, bs, key_mode):
    js, ts, pj, pt, _ = _run_both(k, bs, key_mode, oversized=30)
    assert_history_equal(ts, js, f"k={k} bs={bs} {key_mode}")
    np.testing.assert_allclose(pt, pj, atol=ATOL_PROB)
    assert pt.std() > 0
    assert int(ts.count[:-1].sum()) == 300
    if k == 8:
        # the oversized group kept its newest K events
        assert int(ts.count.max()) > k


def test_tie_order_key_matches_jax():
    """``order_key`` (the sharded step's tie break) orders same-second
    events as the JAX lexsort does."""
    js, ts, pj, pt, _ = _run_both(8, 64, order_key=True)
    assert_history_equal(ts, js, "order_key")
    np.testing.assert_allclose(pt, pj, atol=ATOL_PROB)


def _oracle(params, cust, t_s, amount, k, attn=None):
    """Each row's causal window (its customer's last k events up to
    itself) through the port's full transformer, scored at its own
    position."""
    out = np.zeros(len(cust))
    for i in range(len(cust)):
        sel = [j for j in range(i + 1) if cust[j] == cust[i]][-k:]
        f = tseq.event_features(amount[sel] / 100.0, t_s[sel])
        x = np.zeros((1, k, f.shape[1]), np.float32)
        x[0, :len(f)] = f
        logit = tseq.transformer_logits(params, torch.from_numpy(x), attn)
        out[i] = torch.sigmoid(logit[0, len(f) - 1]).item()
    return out


@pytest.mark.parametrize("k,bs", [(8, 16), (8, 256), (40, 64)])
def test_streaming_matches_the_offline_oracle(k, bs):
    _, ts, _, pt, (cust, t_s, amount, tp, tc) = _run_both(
        k, bs, oversized=30, n=150)
    attn = thist._attn_fn_for(tc, k)
    oracle = _oracle(tp, cust, t_s, amount, k, attn)
    np.testing.assert_allclose(pt, oracle, atol=ATOL_ORACLE)
    # the ring's cells hold their own positions
    pos = ts.pos.numpy()[:-1]
    assert ((pos < 0) | (pos % k == np.arange(k)[None, :])).all()


def test_attention_policy():
    jc, tc = fcfgs(8)
    assert thist._attn_fn_for(tc, 8) is None  # auto, K <= block: naive
    _, tc = fcfgs(40)
    assert thist._attn_fn_for(tc, 40) is not None  # auto: blockwise
    _, tc = fcfgs(40, seq_attn="naive")
    assert thist._attn_fn_for(tc, 40) is None
    _, tc = fcfgs(8, seq_attn="blockwise")
    fn = thist._attn_fn_for(tc, 8)
    # block = max(16, min(block, K)): one block of 16 over 8 keys
    q = torch.randn(2, 8, 2, 4, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(fn(q, q, q).numpy(),
                               tseq.naive_attn(q, q, q).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="seq_attn"):
        FeatureConfig(seq_attn="flash")


def test_history_state_carries_over_and_sizes():
    jc, tc = fcfgs(8)
    js = jhist.init_history_state(jc)
    ts = weights.from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert isinstance(ts, thist.HistoryState)
    assert ts.capacity == CAP and ts.history_len == 8
    fresh = thist.init_history_state(tc, "cpu")
    for a, b in zip(ts, fresh):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert thist.history_bytes(tc) == sum(
        t.numel() * t.element_size() for t in fresh)


# -- the engine -----------------------------------------------------------

def configs(k=8, buckets=(256,), **features):
    fk = dict(customer_capacity=256, terminal_capacity=512, history_len=k,
              seq_attn_block=16, **features)
    return (JConfig(features=JFeatureConfig(**fk),
                    runtime=JRuntimeConfig(batch_buckets=buckets,
                                           max_batch_rows=max(buckets))),
            Config(features=FeatureConfig(**fk),
                   runtime=RuntimeConfig(batch_buckets=buckets,
                                         max_batch_rows=max(buckets))))


def _scaler():
    js = JScaler(mean=jnp.zeros(15), scale=jnp.ones(15))
    return js, port(js)


@pytest.fixture(scope="module")
def jtxs(small_dataset):
    return small_dataset[3].slice(slice(0, 1536))


def _serve_jax(jcfg, jp, jtxs, stop=0):
    js, _ = _scaler()
    eng = JScoringEngine(jcfg, kind="sequence", params=jp, scaler=js)
    sink = JMemorySink()
    eng.run(JReplaySource(jtxs, START, batch_rows=256), sink=sink,
            max_batches=stop)
    return eng, sink.concat()


def _engine(tcfg, tp, **kw):
    _, ts = _scaler()
    return ScoringEngine(tcfg, "sequence", tp, ts, device="cpu", **kw)


@pytest.mark.parametrize("k", [8, 40])
def test_engine_matches_the_jax_engine(jtxs, k):
    jcfg, tcfg = configs(k)
    jp = jparams()
    jeng, jout = _serve_jax(jcfg, jp, jtxs)
    teng = _engine(tcfg, port(jp))
    sink = MemorySink()
    stats = teng.run(ReplaySource(port_txs(jtxs), START, batch_rows=256),
                     sink)
    tout = sink.concat()
    assert stats["batches"] == jeng.state.batches_done == 6
    np.testing.assert_allclose(tout["prediction"], jout["prediction"],
                               atol=ATOL_PROB)
    assert tout["prediction"].std() > 0
    # the feature columns are zeros by definition, as in JAX
    for col in tout:
        if col.endswith("_window") or col.startswith("tx_during"):
            assert not tout[col].any() and not jout[col].any(), col
    assert_history_equal(teng.state.feature_state, jeng.state.feature_state)
    assert not teng.supports_online_sgd


@pytest.mark.parametrize("case", ["exact", "online_lr", "feature_cache"])
def test_engine_refuses_what_jax_refuses(case):
    """The same refusals as the JAX engine, with its messages."""
    features = {"key_mode": "exact"} if case == "exact" else {}
    jcfg, tcfg = configs(8, **features)
    jp = jparams()
    js, ts = _scaler()
    kw = {"online_lr": 0.1} if case == "online_lr" else {}
    jkw, tkw = dict(kw), dict(kw)
    if case == "feature_cache":
        from real_time_fraud_detection_system_tpu.runtime import (
            FeatureCache as JFeatureCache,
        )

        jkw["feature_cache"] = JFeatureCache(capacity=64)
        tkw["feature_cache"] = FeatureCache(capacity=64)
    with pytest.raises(ValueError) as jerr:
        JScoringEngine(jcfg, kind="sequence", params=jp, scaler=js, **jkw)
    with pytest.raises(ValueError) as terr:
        ScoringEngine(tcfg, "sequence", port(jp), ts, device="cpu", **tkw)
    assert str(terr.value) == str(jerr.value)


def test_learning_and_feedback_refuse_the_sequence_kind(tmp_path):
    _, tcfg = configs(8)
    tp = port(jparams())
    _, ts = _scaler()
    eng = _engine(tcfg, tp)
    with pytest.raises(ValueError, match="shadow scoring is not wired"):
        eng.set_shadow(object())
    with pytest.raises(ValueError, match="feedback loop is not wired"):
        eng.apply_state_feedback(np.zeros(2), np.zeros(2), np.ones(2))
    with pytest.raises(ValueError, match="no gradient path"):
        eng.apply_feedback(np.zeros((2, 15), np.float32), np.ones(2))
    with pytest.raises(ValueError, match="no gradient path"):
        StreamingLearner("sequence", tp, ts, tcfg,
                         make_model_registry(str(tmp_path)), device="cpu")
    with pytest.raises(ValueError, match="history state"):
        ShadowScorer("sequence", tcfg, device="cpu")


# -- checkpoints and the supervisor ---------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_move_both_ways(jtxs, tmp_path, direction):
    jcfg, tcfg = configs(8)
    jp = jparams()
    d = str(tmp_path / "ck")
    txs = port_txs(jtxs)
    if direction == "jax_to_port":
        jeng, _ = _serve_jax(jcfg, jp, jtxs, stop=3)
        jckpt.Checkpointer(d).save(jeng.state)
        eng = _engine(tcfg, port(jp))
        held = list(eng.state.feature_state)
        assert tckpt.Checkpointer(d).restore(eng.state) is not None
        assert all(a is b for a, b in zip(eng.state.feature_state, held))
        assert_history_equal(eng.state.feature_state,
                             jeng.state.feature_state)
        # both resume and serve the rest alike
        jsrc = JReplaySource(jtxs, START, batch_rows=256)
        jsrc.seek(jeng.state.offsets)
        jsink = JMemorySink()
        jeng.run(jsrc, sink=jsink)
        src = ReplaySource(txs, START, batch_rows=256)
        src.seek(eng.state.offsets)
        sink = MemorySink()
        eng.run(src, sink)
        np.testing.assert_allclose(sink.concat()["prediction"],
                                   jsink.concat()["prediction"],
                                   atol=ATOL_PROB)
        assert_history_equal(eng.state.feature_state,
                             jeng.state.feature_state)
    else:
        eng = _engine(tcfg, port(jp))
        eng.run(ReplaySource(txs, START, batch_rows=256), max_batches=3)
        tckpt.Checkpointer(d).save(eng.checkpoint_state())
        with np.load(tckpt.Checkpointer(d).list_checkpoints()[-1]) as z:
            meta = json.loads(str(z["__meta__"]))
        assert list(meta["fs_leaves"].values()) == [
            ".events", ".pos", ".count", ".last_t"]
        js, _ = _scaler()
        jeng = JScoringEngine(jcfg, kind="sequence", params=jp, scaler=js)
        assert jckpt.Checkpointer(d).restore(jeng.state) is not None
        assert jeng.state.batches_done == 3
        assert_history_equal(eng.state.feature_state,
                             jeng.state.feature_state)


class IndexedSink:
    """Results by ``batch_index``: a replay overwrites its entry."""

    def __init__(self):
        self.batches = {}

    def append(self, res) -> None:
        self.batches[res.batch_index] = (res.tx_id.copy(), res.probs.copy())

    def truncate_after(self, batch_index: int) -> None:
        for i in [i for i in self.batches if i > batch_index]:
            del self.batches[i]


def test_supervised_crash_replays_each_row_once(jtxs, tmp_path):
    _, tcfg = configs(8, buckets=(128,))
    tcfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
        tcfg.runtime, checkpoint_every_batches=4))
    tp = port(jparams())
    txs = port_txs(jtxs)
    clean = _engine(tcfg, tp)
    want = IndexedSink()
    clean.run(ReplaySource(txs, START, batch_rows=128), want)
    engines = []

    def make():
        engines.append(_engine(tcfg, tp))
        return engines[-1]

    got = IndexedSink()
    stats = run_with_recovery(
        make, FlakySource(ReplaySource(txs, START, batch_rows=128),
                          fail_at=(7,)),
        tckpt.Checkpointer(str(tmp_path / "ck")), sink=got, max_restarts=2)
    assert stats["restarts"] == 1 and len(engines) == 2
    assert sorted(got.batches) == sorted(want.batches) == list(range(1, 13))
    for i, (ids, probs) in want.batches.items():
        np.testing.assert_array_equal(got.batches[i][0], ids)
        np.testing.assert_array_equal(got.batches[i][1], probs)
    fs, ref = engines[-1].state.feature_state, clean.state.feature_state
    for a, b in zip(fs, ref):
        assert torch.equal(a[:-1], b[:-1])
    assert int(fs.count[:-1].sum()) == len(txs.tx_id)


# -- the score command ----------------------------------------------------

@pytest.fixture(scope="module")
def score_files(jtxs, tmp_path_factory):
    from real_time_fraud_detection_system_tpu.io.artifacts import (
        save_transactions as jsave_transactions,
    )

    d = tmp_path_factory.mktemp("seqscore")
    jsave_transactions(str(d / "txs.npz"), jtxs)
    js, _ = _scaler()
    with open(d / "seq.npz", "wb") as f:
        f.write(jart.dump_model_bytes(JTrainedModel(
            kind="sequence", scaler=js, params=jparams())))
    return d


def test_score_cli_writes_the_parquet_of_the_jax_score(score_files,
                                                       capsys):
    pytest.importorskip("pyarrow")
    d = score_files
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "seq.npz"), "--batch-rows", "512"]
    assert jcli_main(["score", "--out", str(d / "j"), *common]) == 0
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["score", "--device", "cpu", "--out", str(d / "t"),
                      *common]) == 0
    tstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tstats["rows"] == jstats["rows"] == 1536
    assert tstats["kind"] == "sequence"
    jout = ParquetSink(str(d / "j")).read_all()
    tout = ParquetSink(str(d / "t")).read_all()
    assert sorted(tout) == sorted(jout)
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col], atol=ATOL_PROB)
        else:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)


@pytest.mark.parametrize("flags,jax_too", [
    (("--online-lr", "0.1"), True),
    (("--feedback-bootstrap", "localhost:1"), True),
    (("--learn-registry", "REG"), True),
    (("--key-mode", "exact"), False)],
    ids=["online-lr", "feedback", "learn-registry", "exact"])
def test_score_cli_refuses_the_sequence_kind_with_exit_2(score_files,
                                                         tmp_path, flags,
                                                         jax_too):
    """Each refusal exits 2 before serving a row, as the JAX ``score``
    does for the first three (the JAX engine raises for the fourth)."""
    d = score_files
    flags = tuple(str(tmp_path / "reg") if f == "REG" else f for f in flags)
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "seq.npz"), *flags]
    assert tcli.main(["score", "--device", "cpu", *common]) == 2
    if jax_too:
        assert jcli_main(["score", *common]) == 2
