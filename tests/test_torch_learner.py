"""Port parity: the continuous-learning loop (``runtime/learner.py``).

The cells of ``tests/test_learn_smoke.py`` on the port. The scripted run
serves the same stream through both packages: a blind logreg champion
(bias -4, flags nothing), the streaming learner trained on labeled
feedback (high-amount rows are fraud), shadow scoring, one promotion, then
inverted labels and one rollback. The learner is paused while a chunk is
served and drained after it, so the decisions are deterministic, and the
flight recorder's
learning events (publish, install, promote, rollback, with their versions
and lineage) equal the JAX loop's one for one; the live recall at the
promotion agrees within 1e-3 (a row whose probability sits within ulps of
the 0.5 threshold may flip between the packages' arithmetic).

Not held here: the JAX cells on ``/healthz`` (the metrics server comes
with ROADMAP A4b) and on mid-stream recompiles (the port has no compile
cache until the CUDA graphs of A4a).
"""

import json
import threading
import time
from types import SimpleNamespace

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
    LearnConfig as JLearnConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.io.registry import (
    make_model_registry as jmake_model_registry,
)
from real_time_fraud_detection_system_tpu.models.logreg import init_logreg
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
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
    encode_feedback_envelopes as jencode,
)
from real_time_fraud_detection_system_tpu.runtime.learner import (
    LearningLoop as JLearningLoop,
)
from real_time_fraud_detection_system_tpu.runtime.learner import (
    StreamingLearner as JStreamingLearner,
)
from real_time_fraud_detection_system_tpu.utils.metrics import (
    FlightRecorder as JFlightRecorder,
)
from real_time_fraud_detection_system_tpu.utils.metrics import (
    set_active_recorder as jset_active_recorder,
)
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    LearnConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    TrainedModel,
)
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    _StoreBackend,
)
from real_time_fraud_detection_system_tpu_torch.io.registry import (
    ModelRegistry,
    make_model_registry,
)
from real_time_fraud_detection_system_tpu_torch.io.store import LocalStore
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    predict_proba,
    synthetic_ensemble,
    to_gemm,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    Scaler,
    transform,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    TornStore,
)
from real_time_fraud_detection_system_tpu_torch.runtime.feedback import (
    FEEDBACK_TOPIC,
    FeatureCache,
    FeedbackLoop,
    encode_feedback_envelopes,
)
from real_time_fraud_detection_system_tpu_torch.runtime import (
    learner as learner_mod,
)
from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
    LearningLoop,
    ShadowScorer,
    StreamingLearner,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    InProcBroker,
    ReplaySource,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    FlightRecorder,
    get_registry,
    set_active_recorder,
)
from test_torch_online_sgd import port_txs  # pytest adds tests/

torch.set_num_threads(1)

EPOCH0 = 1_743_465_600
N_ROWS = 6144
CHUNK = 512
LEARN = dict(publish_every_labels=128, promote_min_labels=96,
             promote_margin=0.01, precision_tolerance=0.05,
             rollback_min_labels=96, rollback_margin=0.05,
             window_rows=1024, epochs=2)
FEATURES = dict(customer_capacity=256, terminal_capacity=512,
                cms_width=1 << 10)

_METRICS = {
    "trained": ("rtfds_learner_labels_trained_total", {}),
    "published": ("rtfds_learner_published_total", {}),
    "shadow_rows": ("rtfds_shadow_rows_total", {}),
    "divergence": ("rtfds_shadow_divergence_total", {}),
    "promoted": ("rtfds_model_promotions_total", {"outcome": "promoted"}),
    "refused": ("rtfds_model_promotions_total",
                {"outcome": "refused_corrupt"}),
    "rollbacks": ("rtfds_model_rollbacks_total", {}),
    "cache_hits": ("rtfds_feature_cache_lookups_total", {"outcome": "hit"}),
    "corrupt_trunc": ("rtfds_model_artifact_corrupt_total",
                      {"reason": "truncated"}),
    "corrupt_sum": ("rtfds_model_artifact_corrupt_total",
                    {"reason": "checksum"}),
    "resyncs": ("rtfds_model_resyncs_total", {}),
}


def _snap() -> dict:
    reg = get_registry()
    out = {}
    for key, (name, labels) in _METRICS.items():
        m = reg.get(name, **labels)
        out[key] = float(m.value) if m is not None else 0.0
    return out


def _cfg(**learn_kw) -> Config:
    return Config(features=FeatureConfig(**FEATURES),
                  runtime=RuntimeConfig(batch_buckets=(256,),
                                        max_batch_rows=256),
                  learn=LearnConfig(**{**LEARN, **learn_kw}))


def _jcfg(**learn_kw) -> JConfig:
    return JConfig(features=JFeatureConfig(**FEATURES),
                   runtime=JRuntimeConfig(batch_buckets=(256,),
                                          max_batch_rows=256),
                   learn=JLearnConfig(**{**LEARN, **learn_kw}))


def _blind(bias: float = -4.0, seed: int = 0):
    """The JAX suite's blind champion, in the port's tensors."""
    jp = init_logreg(15, seed=seed)
    params = LogRegParams(torch.tensor(np.asarray(jp.w)),
                          torch.tensor(np.float32(bias)))
    scaler = Scaler(torch.zeros(15), torch.ones(15))
    return params, scaler, TrainedModel(kind="logreg", scaler=scaler,
                                        params=params)


def _strong():
    params, scaler, _ = _blind(4.0)
    return TrainedModel(kind="logreg", scaler=scaler, params=params)


def _engine(cfg, params, scaler, **kw):
    return ScoringEngine(cfg, "logreg", params, scaler, device="cpu", **kw)


# -- the scripted run, in both packages -----------------------------------

def _learning_events(path: str) -> list:
    keep = {"model_published": ("version", "parent", "source"),
            "model_candidate": ("version", "champion"),
            "model_promoted": ("version", "previous"),
            "model_rollback": ("version", "regressed"),
            "model_canary_passed": ("version",),
            "model_promote_refused": ("version", "stage", "reason")}
    out = []
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            name = rec.get("event")
            if rec.get("kind") == "event" and name in keep:
                out.append((name,) + tuple(rec.get(k) for k in keep[name]))
    return out


def _recalls(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line)["recall"] for line in fh
                if '"model_promoted"' in line]


def _script(part, amt_thresh, tmp, port: bool):
    """Serve the chunks, feeding each chunk's labels after it (inverted
    once a promotion fired), until the rollback."""
    if port:
        cfg = _cfg()
        params, scaler, model = _blind()
        registry = make_model_registry(str(tmp / "registry"))
        learner = StreamingLearner(
            "logreg", params, scaler, cfg, registry,
            publish_every_labels=cfg.learn.publish_every_labels,
            window_rows=cfg.learn.window_rows, epochs=cfg.learn.epochs,
            device="cpu")
        learning = LearningLoop(registry, cfg, "logreg", model=model,
                                learner=learner, device="cpu")
        cache = FeatureCache(capacity=1 << 14)
        engine = _engine(cfg, params, scaler, feature_cache=cache)
        broker = InProcBroker(2)
        fb = FeedbackLoop(engine, broker, cache)
        recorder = FlightRecorder(str(tmp / "learn.jsonl"))
        set_active, source, encode, topic = (set_active_recorder,
                                             ReplaySource,
                                             encode_feedback_envelopes,
                                             FEEDBACK_TOPIC)
        promoted_now = lambda: _snap()["promoted"] > base["promoted"]  # noqa
        rolled_back = lambda: _snap()["rollbacks"] > base["rollbacks"]  # noqa
        txs = port_txs(part)
    else:
        cfg = _jcfg()
        jp = init_logreg(15)._replace(b=jnp.asarray(-4.0, jnp.float32))
        jsc = JScaler(mean=jnp.zeros(15), scale=jnp.ones(15))
        registry = jmake_model_registry(str(tmp / "jregistry"))
        learner = JStreamingLearner(
            "logreg", jp, jsc, cfg, registry,
            publish_every_labels=cfg.learn.publish_every_labels,
            window_rows=cfg.learn.window_rows, epochs=cfg.learn.epochs)
        learning = JLearningLoop(registry, cfg, "logreg",
                                 model=JTrainedModel(kind="logreg",
                                                     scaler=jsc, params=jp),
                                 learner=learner)
        cache = JFeatureCache(capacity=1 << 14)
        engine = JScoringEngine(cfg, kind="logreg", params=jp, scaler=jsc,
                                feature_cache=cache)
        broker = JInProcBroker(2)
        fb = JFeedbackLoop(engine, broker, cache)
        recorder = JFlightRecorder(str(tmp / "jlearn.jsonl"))
        set_active, source, encode, topic = (jset_active_recorder,
                                             JReplaySource, jencode,
                                             FEEDBACK_TOPIC)
        promoted_now = lambda: any(  # noqa: E731
            e[0] == "model_promoted" for e in _learning_events(
                str(tmp / "jlearn.jsonl")))
        rolled_back = lambda: any(  # noqa: E731
            e[0] == "model_rollback" for e in _learning_events(
                str(tmp / "jlearn.jsonl")))
        txs = part
    set_active(recorder)
    base = _snap()
    promoted = False
    rows = 0
    t_run = 0.0
    try:
        for s in range(0, N_ROWS, CHUNK):
            sl, jsl = txs.slice(slice(s, s + CHUNK)) if port else None, \
                part.slice(slice(s, s + CHUNK))
            # the learner waits while the chunk is served: the labels the
            # tap hands it then train after any reset the loop decided
            # (a race with the loop thread otherwise)
            learner.pause()
            t0 = time.perf_counter()
            engine.run(source(sl if port else jsl, EPOCH0, batch_rows=256),
                       feedback=fb, learning=learning)
            t_run += time.perf_counter() - t0
            learner.resume()
            rows += len(jsl.tx_id)
            promoted = promoted or promoted_now()
            y = (np.asarray(jsl.amount_cents) > amt_thresh).astype(np.int32)
            if promoted:
                y = 1 - y  # the injected regression
            broker.produce_many(topic, [str(int(t)).encode()
                                        for t in jsl.tx_id],
                                encode(jsl.tx_id, y))
            assert learner.drain(60.0), "learner queue failed to drain"
            if rolled_back():
                break
    finally:
        set_active(None)
        recorder.close()
        learning.close()
    path = str(tmp / ("learn.jsonl" if port else "jlearn.jsonl"))
    return SimpleNamespace(
        delta={k: _snap()[k] - base[k] for k in base}, registry=registry,
        engine=engine, events=_learning_events(path),
        recalls=_recalls(path), rows_fed=rows, t_run=t_run)


@pytest.fixture(scope="module")
def learn_runs(small_dataset, tmp_path_factory):
    part = small_dataset[3].slice(slice(0, N_ROWS))
    amt_thresh = float(np.percentile(part.amount_cents, 70))
    tmp = tmp_path_factory.mktemp("learn")
    return (_script(part, amt_thresh, tmp, port=True),
            _script(part, amt_thresh, tmp, port=False))


def test_learning_events_equal_the_jax_loop(learn_runs):
    run, jrun = learn_runs
    assert run.events == jrun.events
    np.testing.assert_allclose(run.recalls, jrun.recalls, atol=1e-3)
    assert run.rows_fed == jrun.rows_fed
    assert run.registry.versions() == jrun.registry.versions()
    for v in run.registry.versions():
        a, b = run.registry.meta(v), jrun.registry.meta(v)
        for k in ("parent", "source", "labels_trained", "kind"):
            assert a[k] == b[k], (v, k)


def test_stream_completes_and_learner_trains(learn_runs):
    run = learn_runs[0]
    assert run.engine.state.rows_done == run.rows_fed
    assert run.delta["trained"] > 0 and run.delta["published"] >= 2
    man = run.registry.meta(2)
    assert (man["source"], man["parent"]) == ("learner", 1)
    assert man["labels_trained"] > 0
    assert run.registry.meta(1)["source"] == "bootstrap"
    assert run.delta["shadow_rows"] > 0 and run.delta["divergence"] > 0
    assert run.delta["cache_hits"] > 0


def test_promotion_then_rollback_from_live_metrics(learn_runs):
    run = learn_runs[0]
    assert run.delta["promoted"] == 1 and run.delta["rollbacks"] == 1
    promoted = [e for e in run.events if e[0] == "model_promoted"]
    assert len(promoted) == 1 and promoted[0][2] == 1
    assert run.recalls[0] > 0.1
    rollback = [e for e in run.events if e[0] == "model_rollback"]
    assert rollback == [("model_rollback", 1, promoted[0][1])]
    assert run.registry.champion_version() == 1
    # the serving params are the original champion's, bit for bit, and
    # the params tensors are still the engine's own (swapped in place)
    champ = run.registry.get(1)
    assert torch.equal(run.engine.state.params.w, champ.params.w)
    assert float(run.engine.state.params.b) == -4.0
    assert run.engine.state.model_version == 1
    assert run.engine.state.params_epoch >= 2  # promotion + rollback


def test_shadow_overhead_bounded(learn_runs, small_dataset):
    """The no-shadow control over the same chunk schedule, on the CPU:
    generous, but a per-batch synchronous training would blow through."""
    run = learn_runs[0]
    part = port_txs(small_dataset[3].slice(slice(0, run.rows_fed)))
    cfg = _cfg()
    params, scaler, _ = _blind()
    cache = FeatureCache(capacity=1 << 14)
    eng = _engine(cfg, params, scaler, feature_cache=cache)
    fb = FeedbackLoop(eng, InProcBroker(2), cache)
    t0 = time.perf_counter()
    for s in range(0, run.rows_fed, CHUNK):
        eng.run(ReplaySource(part.slice(slice(s, s + CHUNK)), EPOCH0,
                             batch_rows=256), feedback=fb)
    t_control = time.perf_counter() - t0
    assert run.t_run <= 4.0 * t_control + 2.0


# -- corrupt candidates are never promoted --------------------------------

def test_torn_registry_put_refused_at_install(small_dataset, tmp_path):
    part = port_txs(small_dataset[3].slice(slice(0, 768)))
    cfg = _cfg(publish_every_labels=192, promote_min_labels=100_000)
    params, scaler, model = _blind()
    # PUT order: bootstrap npz(0) + manifest(1) + champion(2), then the
    # learner's first candidate npz (3) lands torn
    store = TornStore(LocalStore(str(tmp_path)), tear_at=3, keep_bytes=64)
    registry = ModelRegistry(_StoreBackend(store, prefix="", op_attempts=3))
    learner = StreamingLearner("logreg", params, scaler, cfg, registry,
                               publish_every_labels=192, window_rows=1024,
                               epochs=1, device="cpu")
    learning = LearningLoop(registry, cfg, "logreg", model=model,
                            learner=learner, device="cpu")
    cache = FeatureCache(capacity=1 << 14)
    engine = _engine(cfg, params, scaler, feature_cache=cache)
    broker = InProcBroker(2)
    fb = FeedbackLoop(engine, broker, cache)
    amt = float(np.percentile(part.amount_cents, 70))
    base = _snap()
    try:
        for s in range(0, 768, 256):
            sl = part.slice(slice(s, s + 256))
            engine.run(ReplaySource(sl, EPOCH0, batch_rows=256),
                       feedback=fb, learning=learning)
            broker.produce_many(
                FEEDBACK_TOPIC, [b""] * len(sl.tx_id),
                encode_feedback_envelopes(
                    sl.tx_id, (sl.amount_cents > amt).astype(np.int32)))
            assert learner.drain(60.0)
    finally:
        learning.close()
    delta = {k: _snap()[k] - base[k] for k in base}
    assert delta["refused"] >= 1 and delta["corrupt_trunc"] >= 1
    assert delta["promoted"] == 0
    assert 2 not in registry.versions()
    assert registry.champion_version() == 1
    assert float(engine.state.params.b) == pytest.approx(-4.0, abs=0.05)
    assert engine.state.rows_done == 768
    assert learning.shadow.candidate_version in (None, 3)


def test_bit_flip_refused_at_the_promotion_gate(tmp_path):
    cfg = _cfg(promote_min_labels=64)
    params, scaler, model = _blind()
    registry = make_model_registry(str(tmp_path / "reg"))
    learning = LearningLoop(registry, cfg, "logreg", model=model,
                            device="cpu")
    engine = _engine(cfg, params, scaler)
    learning.attach(engine)
    v2 = registry.publish(_strong(), parent=1, source="learner")
    learning.on_batch(engine)  # no learner: nothing installs by itself
    learning._install_candidate(engine, v2)
    assert learning.shadow.candidate_version == v2
    rng = np.random.default_rng(3)
    tx = np.arange(1, 257, dtype=np.int64)
    learning.shadow.score_batch(tx, rng.normal(size=(256, 15)).astype(
        np.float32), np.zeros(256, np.float32))
    learning.shadow.observe_labels(tx, np.ones(256, np.int32))
    path = tmp_path / "reg" / "model-v0000002.npz"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    base = _snap()
    w_before = engine.state.params.w.clone()
    learning.on_batch(engine)  # the gate re-verifies and refuses
    delta = {k: _snap()[k] - base[k] for k in base}
    assert delta["refused"] == 1 and delta["promoted"] == 0
    assert delta["corrupt_sum"] >= 1
    assert torch.equal(engine.state.params.w, w_before)
    assert registry.champion_version() == 1
    assert learning.shadow.candidate_version is None


def test_vanished_version_refused_at_install_and_gate(tmp_path):
    cfg = _cfg(promote_min_labels=64)
    params, scaler, model = _blind()
    registry = make_model_registry(str(tmp_path / "reg"))
    learning = LearningLoop(registry, cfg, "logreg", model=model,
                            device="cpu")
    engine = _engine(cfg, params, scaler)
    learning.attach(engine)
    v2 = registry.publish(_strong(), parent=1)
    (tmp_path / "reg" / "model-v0000002.json").unlink()
    base = _snap()
    learning._install_candidate(engine, v2)  # must not raise
    assert _snap()["refused"] - base["refused"] == 1
    assert learning.shadow.candidate_version is None
    v3 = registry.publish(_strong(), parent=1)
    learning._install_candidate(engine, v3)
    assert learning.shadow.candidate_version == v3
    tx = np.arange(1, 129, dtype=np.int64)
    learning.shadow.score_batch(tx, np.random.default_rng(11).normal(
        size=(128, 15)).astype(np.float32), np.zeros(128, np.float32))
    learning.shadow.observe_labels(tx, np.ones(128, np.int32))
    (tmp_path / "reg" / "model-v0000003.json").unlink()
    base = _snap()
    learning.on_batch(engine)
    assert _snap()["refused"] - base["refused"] == 1
    assert _snap()["promoted"] - base["promoted"] == 0
    assert registry.champion_version() == 1


# -- reload is versioned --------------------------------------------------

def test_reload_counted_by_outcome_and_registered(small_dataset, tmp_path):
    part = port_txs(small_dataset[3].slice(slice(0, 768)))
    cfg = _cfg()
    params, scaler, model = _blind()
    registry = make_model_registry(str(tmp_path / "reg"))
    learning = LearningLoop(registry, cfg, "logreg", model=model,
                            device="cpu")
    cache = FeatureCache(capacity=1 << 14)
    engine = _engine(cfg, params, scaler, feature_cache=cache,
                     online_lr=0.05)
    broker = InProcBroker(2)
    fb = FeedbackLoop(engine, broker, cache)
    reg = get_registry()

    def reloads(outcome):
        m = reg.get("rtfds_model_reloads_total", outcome=outcome)
        return float(m.value) if m is not None else 0.0

    sl0 = part.slice(slice(0, 256))
    engine.run(ReplaySource(sl0, EPOCH0, batch_rows=256), feedback=fb,
               learning=learning)
    broker.produce_many(FEEDBACK_TOPIC, [b""] * 256,
                        encode_feedback_envelopes(
                            sl0.tx_id, (np.arange(256) % 2)))
    base = (reloads("clean"), reloads("clobbered_online_updates"))
    w = engine.state.params.w
    epoch = engine.state.params_epoch
    swaps = [(_blind(0.3, seed=9)[0], None)]
    engine.run(ReplaySource(part.slice(slice(256, 512)), EPOCH0,
                            batch_rows=256), feedback=fb, learning=learning,
               model_reload=lambda: swaps.pop() if swaps else None)
    assert reloads("clobbered_online_updates") == base[1] + 1
    assert engine.state.params.w is w  # the swap copied in place
    assert engine.state.params_epoch == epoch + 1
    v = learning.champion_version
    assert v is not None and v > 1 and registry.champion_version() == v
    man = registry.meta(v)
    assert (man["source"], man["note"]) == ("reload",
                                            "clobbered_online_updates")
    assert engine.state.model_version == v
    swaps2 = [(_blind(0.1, seed=11)[0], None)]
    engine.run(ReplaySource(part.slice(slice(512, 768)), EPOCH0,
                            batch_rows=256), feedback=fb, learning=learning,
               model_reload=lambda: swaps2.pop() if swaps2 else None)
    assert reloads("clean") == base[0] + 1
    assert registry.meta(learning.champion_version)["note"] == "clean"


# -- the learner's thread -------------------------------------------------

def test_mid_train_reset_discards_writeback(tmp_path):
    cfg = _cfg()
    params, scaler, _ = _blind()
    learner = StreamingLearner("logreg", params, scaler, cfg,
                               make_model_registry(str(tmp_path)),
                               publish_every_labels=100_000, window_rows=256,
                               epochs=1, device="cpu")
    try:
        reset_params = _blind(0.5, seed=42)[0]
        orig = learner._fb_step
        fired = []

        def hijack(*a):
            if not fired:
                fired.append(1)
                learner.reset(reset_params, scaler, 7)
            return orig(*a)

        learner._fb_step = hijack
        before = _snap()["trained"]
        rng = np.random.default_rng(0)
        learner.submit(rng.normal(size=(64, 15)).astype(np.float32),
                       (np.arange(64) % 2).astype(np.int32))
        assert learner.drain(30.0) and fired
        with learner._plock:
            assert torch.equal(learner._params.w, reset_params.w)
            # the learner trains its own copy, never the caller's tensors
            assert learner._params.w.data_ptr() != reset_params.w.data_ptr()
        assert learner.parent_version == 7
        assert _snap()["trained"] == before
    finally:
        learner.close()


def test_pause_blocks_until_the_chunk_in_flight_is_done(tmp_path):
    cfg = _cfg()
    params, scaler, _ = _blind()
    learner = StreamingLearner("logreg", params, scaler, cfg,
                               make_model_registry(str(tmp_path)),
                               publish_every_labels=100_000, window_rows=256,
                               epochs=1, device="cpu")
    try:
        orig = learner._fb_step
        entered = threading.Event()

        def slow(*a):
            entered.set()
            time.sleep(0.25)
            return orig(*a)

        learner._fb_step = slow
        before = _snap()["trained"]
        learner.submit(np.random.default_rng(0).normal(size=(64, 15))
                       .astype(np.float32), np.ones(64, np.int32))
        assert entered.wait(10.0)
        learner.pause()
        assert not learner._in_train
        assert _snap()["trained"] == before + 64
        learner.resume()
    finally:
        learner.close()


def test_graph_capture_holds_the_learner_and_keeps_a_rung_one_pause(
        small_dataset, tmp_path):
    """The engine captures CUDA graphs with the learning loop's worker
    held idle (its device work would run beside the capture), and leaves
    it as it found it: running, or paused by the overload ladder's rung
    1. On the CPU nothing captures, so the capture's body is stubbed."""
    cfg = _cfg()
    params, scaler, model = _blind()
    learner = StreamingLearner("logreg", params, scaler, cfg,
                               make_model_registry(str(tmp_path / "l")),
                               publish_every_labels=100_000, device="cpu")
    learning = LearningLoop(make_model_registry(str(tmp_path / "r")), cfg,
                            "logreg", model=model, learner=learner,
                            device="cpu")
    engine = _engine(cfg, params, scaler)
    seen = []
    engine._capture_held = lambda sigs: seen.append(learner.paused)
    try:
        part = small_dataset[3].slice(slice(0, 256))
        engine.run(ReplaySource(port_txs(part), EPOCH0, batch_rows=256),
                   learning=learning)
        engine._capture([])
        assert seen == [True] and not learner.paused
        learning.pause()
        engine._capture([])
        assert seen == [True, True] and learner.paused
        learning.resume()
    finally:
        learning.close()


def test_worker_failure_reraised_with_its_type(tmp_path):
    cfg = _cfg()
    params, scaler, _ = _blind()
    learner = StreamingLearner("logreg", params, scaler, cfg,
                               make_model_registry(str(tmp_path)),
                               device="cpu")
    try:
        def boom(*a):
            raise ConnectionError("store down")

        learner._fb_step = boom
        learner.submit(np.ones((4, 15), np.float32), np.ones(4, np.int32))
        with pytest.raises(ConnectionError, match="store down"):
            learner.drain(10.0)
        learner.raise_pending()  # cleared: a recovered loop resumes
    finally:
        learner.close()
    with pytest.raises(ValueError, match="no gradient path"):
        StreamingLearner("forest", synthetic_ensemble(2, 2, 15, seed=0,
                                                      device="cpu"),
                         scaler, cfg, None, device="cpu")


# -- the canary watch -----------------------------------------------------

def _promoted_loop(tmp_path, **learn_kw):
    cfg = _cfg(promote_min_labels=64, rollback_min_labels=64, **learn_kw)
    params, scaler, model = _blind()
    registry = make_model_registry(str(tmp_path / "reg"))
    learning = LearningLoop(registry, cfg, "logreg", model=model,
                            device="cpu")
    engine = _engine(cfg, params, scaler)
    learning.attach(engine)
    v2 = registry.publish(_strong(), parent=1, source="learner")
    learning._install_candidate(engine, v2)
    rng = np.random.default_rng(5)
    tx = np.arange(1, 129, dtype=np.int64)
    learning.shadow.score_batch(tx, rng.normal(size=(128, 15)).astype(
        np.float32), np.zeros(128, np.float32))
    learning.shadow.observe_labels(tx, np.ones(128, np.int32))
    learning.on_batch(engine)  # recall 1.0 against 0: promote
    assert registry.champion_version() == v2 and learning._watch
    # the promoted params serve: the artifact's, bit for bit
    assert torch.equal(engine.state.params.b, _strong().params.b)
    return registry, learning, engine, rng, v2


def _window(learning, rng, start, labels, champ_p=0.0):
    tx = np.arange(start, start + 128, dtype=np.int64)
    learning.shadow.score_batch(tx, rng.normal(size=(128, 15)).astype(
        np.float32), np.full(128, champ_p, np.float32))
    learning.shadow.observe_labels(tx, np.full(128, labels, np.int32))


def test_install_deferred_during_the_watch_then_discarded(tmp_path):
    registry, learning, engine, rng, v2 = _promoted_loop(tmp_path)
    v3 = registry.publish(_strong(), parent=v2, source="learner")
    learning._pending_install = v3
    learning.on_batch(engine)
    assert learning.shadow.candidate_version is None
    assert learning._pending_install == v3
    _window(learning, rng, 500, 1)  # fraud the new champion misses
    learning.on_batch(engine)
    assert registry.champion_version() == 1
    assert learning._pending_install is None
    assert float(engine.state.params.b) == -4.0


def test_all_negative_canary_window_is_not_evidence(tmp_path):
    registry, learning, engine, rng, v2 = _promoted_loop(tmp_path)
    _window(learning, rng, 500, 0, champ_p=0.99)
    base = _snap()
    learning.on_batch(engine)
    assert _snap()["rollbacks"] == base["rollbacks"]
    assert registry.champion_version() == v2 and learning._watch
    _window(learning, rng, 900, 1)
    learning.on_batch(engine)
    assert _snap()["rollbacks"] == base["rollbacks"] + 1
    assert registry.champion_version() == 1


# -- external candidates (tree kinds have no learner) ---------------------

def test_external_publish_installed_promoted_never_reinstalled(tmp_path):
    cfg = _cfg(promote_min_labels=64, rollback_min_labels=64,
               external_poll_batches=1)
    params, scaler, model = _blind()
    registry = make_model_registry(str(tmp_path / "reg"))
    learning = LearningLoop(registry, cfg, "logreg", model=model,
                            device="cpu")
    engine = _engine(cfg, params, scaler)
    learning.attach(engine)
    v2 = registry.publish(_strong(), parent=1, source="cli")
    learning.on_batch(engine)  # the poll detects and installs
    assert learning.shadow.candidate_version == v2
    rng = np.random.default_rng(7)
    _window(learning, rng, 1, 1)
    base = _snap()
    learning.on_batch(engine)
    assert _snap()["promoted"] - base["promoted"] == 1
    _window(learning, rng, 500, 1)
    learning.on_batch(engine)
    assert registry.champion_version() == 1
    for _ in range(3):
        learning.on_batch(engine)
    assert learning.shadow.candidate_version is None
    # a candidate of another kind is refused once, never retried
    v3 = registry.publish(TrainedModel(
        kind="forest", scaler=scaler,
        params=synthetic_ensemble(2, 2, 15, seed=0, device="cpu")),
        parent=1, source="cli")
    learning.on_batch(engine)
    assert learning.shadow.candidate_version is None
    assert learning._ext_seen == v3


def test_tree_candidate_shadow_scores_through_the_leaf_sum(monkeypatch):
    """A forest candidate admitted by ``admit_tables`` dual-scores through
    the leaf-sum kernel's wrapper on tables derived once at install (on
    the CPU its plain version), equal to the plain predict."""
    cfg = _cfg()
    shadow = ShadowScorer("forest", cfg, capacity=1 << 10, device="cpu")
    ens = synthetic_ensemble(8, 4, 15, seed=3, device="cpu")
    scaler = Scaler(torch.zeros(15), torch.ones(15))
    shadow.set_candidate(2, ens, scaler)
    assert shadow._cand_tables is not None
    x = np.random.default_rng(1).normal(size=(200, 15)).astype(np.float32)
    calls = []
    wrapped = learner_mod.leaf_sum

    def counted(tables, z):
        calls.append(tables)
        return wrapped(tables, z)

    monkeypatch.setattr(learner_mod, "leaf_sum", counted)
    shadow.score_batch(np.arange(200), x, np.zeros(200, np.float32))
    assert calls == [shadow._cand_tables]
    want = predict_proba(to_gemm(ens, 15), transform(scaler,
                                                     torch.from_numpy(x)),
                         "f32").numpy()
    got = shadow._cand_p[np.arange(200) % shadow.capacity]
    np.testing.assert_array_equal(got, want.astype(np.float32))


# -- incarnation resync ---------------------------------------------------

def test_fresh_incarnation_readopts_the_promoted_champion(tmp_path):
    cfg = _cfg()
    params, scaler, model = _blind()
    registry = make_model_registry(str(tmp_path / "reg"))
    learning = LearningLoop(registry, cfg, "logreg", model=model,
                            device="cpu")
    better = _blind(0.7, seed=5)[0]
    learning.note_external_swap(better, scaler, "clean")
    v2 = learning.champion_version
    assert v2 == 2 and registry.champion_version() == 2
    before = _snap()["resyncs"]
    eng = _engine(cfg, params, scaler)
    w = eng.state.params.w
    learning.attach(eng)
    assert _snap()["resyncs"] == before + 1
    assert eng.state.model_version == v2
    assert eng.state.params.w is w and torch.equal(w, better.w)
    eng2 = _engine(cfg, better._replace(b=torch.tensor(0.25)), scaler)
    eng2.state.model_version = v2  # as a checkpoint restore sets it
    learning.attach(eng2)
    assert _snap()["resyncs"] == before + 1
    assert float(eng2.state.params.b) == 0.25


def test_unadopted_champion_stamp_stays_honest_and_heals(tmp_path):
    cfg = _cfg()
    params, scaler, model = _blind()
    registry = make_model_registry(str(tmp_path / "reg"))
    better = _blind(0.7, seed=5)[0]
    v1 = registry.publish(TrainedModel(kind="logreg", scaler=scaler,
                                       params=better))
    registry.promote(v1)
    learning = LearningLoop(registry, cfg, "logreg", model=model,
                            model_is_champion=False, device="cpu")
    assert learning._boot_version is None
    eng = _engine(cfg, params, scaler)
    learning.attach(eng)
    assert eng.state.model_version == v1
    assert torch.equal(eng.state.params.w, better.w)
