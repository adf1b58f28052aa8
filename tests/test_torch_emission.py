"""Port parity: selective and bf16 emission and the non-finite guard,
against the JAX engine's on the same weights and batches.

Tolerances (stated beside each assertion): the packing is held bit for
bit against ``jnp.nonzero(size=cap, fill_value=0)``'s; probabilities
within ``ATOL_PROB`` of the JAX engine's (the logit in another order), so
the flagged set may differ from the JAX engine's only on rows whose
probability lies within ``ATOL_PROB`` of the threshold; a flagged row's
features bit-identical to the port's own full emission (they ride the
packed transfer as raw float32), and to the JAX engine's except the
customer amount averages (``rtol=1e-6``: float32 window sums in another
order); bf16 features bit-identical to the port's float32 features
rounded to bf16. The guard's outputs are bit-identical to a run that
never saw the poisoned row.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.io.sink import (
    DeadLetterSink as JDeadLetterSink,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    DeadLetterSink,
    MemorySink,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
    pack_selective,
)
from real_time_fraud_detection_system_tpu_torch.runtime.feedback import (
    FeatureCache,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)
from test_torch_serving_loop import (  # pytest adds tests/
    START,
    _logreg,
    _loop_configs,
    _port_txs,
    _scaler,
)

torch.set_num_threads(1)

ATOL_PROB = 1e-6
RTOL_SUM_ORDER = 1e-6
ROWS = 3000
POLL = 250
AVG_AMOUNT_COLS = (4, 6, 8)  # customer avg amount over 1, 7, 30 days


class ListSink:
    """The raw BatchResults: bit-level comparisons need the float32
    matrix before any sink column cast."""

    def __init__(self):
        self.results = []

    def append(self, res) -> None:
        self.results.append(res)

    def cat(self):
        return (np.concatenate([r.probs for r in self.results]),
                np.concatenate([r.features for r in self.results]))


def _run_jax(jtxs, **runtime):
    jcfg, _ = _loop_configs(**runtime)
    mean, scale = _scaler()
    eng = JScoringEngine(jcfg, kind="logreg", params=_logreg(),
                         scaler=JScaler(jnp.asarray(mean),
                                        jnp.asarray(scale)))
    sink = ListSink()
    eng.run(JReplaySource(jtxs, START, batch_rows=POLL), sink=sink)
    probs, feats = sink.cat()
    return probs, feats, eng


def _run_port(jtxs, **runtime):
    _, tcfg = _loop_configs(**runtime)
    mean, scale = _scaler()
    params = weights.from_numpy(
        {"w": np.asarray(_logreg().w), "b": np.asarray(_logreg().b)},
        device="cpu")
    eng = ScoringEngine(tcfg, "logreg", params,
                        Scaler(torch.from_numpy(mean),
                               torch.from_numpy(scale)), device="cpu")
    sink = ListSink()
    stats = eng.run(ReplaySource(_port_txs(jtxs), START, batch_rows=POLL),
                    sink)
    probs, feats = sink.cat()
    return probs, feats, eng, stats


@pytest.fixture(scope="module")
def streams(small_dataset):
    jtxs = small_dataset[3].slice(slice(0, ROWS))
    tp, tf, _, _ = _run_port(jtxs)
    # a threshold that flags ~5% of the stream: both populations present
    thresh = float(np.quantile(tp, 0.95))
    return jtxs, tp, tf, thresh


def _same_features(t: np.ndarray, j: np.ndarray) -> None:
    for c in range(t.shape[1]):
        if c in AVG_AMOUNT_COLS:
            np.testing.assert_allclose(t[:, c], j[:, c], rtol=RTOL_SUM_ORDER)
        else:
            np.testing.assert_array_equal(t[:, c], j[:, c], err_msg=str(c))


# -- the packing ------------------------------------------------------------

def _jax_pack(probs, feats, valid, thresh, cap_fraction):
    pad = probs.shape[0]
    cap = max(8, int(pad * cap_fraction))
    flagged = valid & (probs >= thresh)
    idx = jnp.nonzero(flagged, size=cap, fill_value=0)[0]
    count = jnp.sum(flagged).astype(jnp.float32)
    return jnp.concatenate([probs, count[None], idx.astype(jnp.float32),
                            feats[idx].reshape(-1)])


@pytest.mark.parametrize("pad,frac_flagged,cap_fraction", [
    (64, 0.05, 1 / 16), (256, 0.02, 1 / 16), (256, 0.5, 1 / 16),
    (1024, 0.0, 1 / 16), (1024, 1.0, 0.25), (300, 0.1, 1.0)])
def test_packing_equals_jnp_nonzero_bit_for_bit(pad, frac_flagged,
                                                cap_fraction):
    """Fixed shape, ascending indices, fill 0 past the count — overflow
    (more flagged rows than the cap) keeps the first ``cap``."""
    rng = np.random.default_rng(pad)
    probs = rng.random(pad).astype(np.float32)
    valid = rng.random(pad) < 0.9
    thresh = float(np.quantile(probs, 1 - frac_flagged)) \
        if frac_flagged else 2.0
    probs = np.where(valid, probs, 0).astype(np.float32)
    feats = rng.normal(size=(pad, 15)).astype(np.float32)
    got = pack_selective(torch.from_numpy(probs), torch.from_numpy(feats),
                         torch.from_numpy(valid), thresh, cap_fraction)
    want = _jax_pack(jnp.asarray(probs), jnp.asarray(feats),
                     jnp.asarray(valid), thresh, cap_fraction)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- selective emission ------------------------------------------------------

def test_selective_emission_matches_jax_and_full_emission(streams):
    jtxs, full_p, full_f, thresh = streams
    # a cap of every row: the flagged rows of a burst never overflow it
    cfg = dict(emit_threshold=thresh, emit_cap_fraction=1.0)
    tp, tf, teng, stats = _run_port(jtxs, **cfg)
    jp, jf, jeng = _run_jax(jtxs, **cfg)
    # every row's probability lands, equal to full emission bit for bit
    np.testing.assert_array_equal(tp, full_p)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=ATOL_PROB)
    flagged = full_p >= thresh
    assert 0 < flagged.sum() < len(full_p)
    # flagged rows: bit-identical to full emission; the rest zeros
    np.testing.assert_array_equal(tf[flagged], full_f[flagged])
    assert not tf[~flagged].any()
    # the JAX engine flags the same rows, except within ATOL_PROB of the
    # threshold, and emits the same features for them
    jflag = jf.any(axis=1)
    assert np.array_equal(jflag, flagged) or np.all(
        np.abs(jp[jflag != flagged] - thresh) <= ATOL_PROB)
    both = jflag & flagged
    _same_features(tf[both], jf[both])
    assert teng.selective_overflows == jeng.selective_overflows == 0
    assert stats["selective_overflows"] == 0


def test_selective_overflow_fetches_the_full_matrix(streams):
    """A cap far below the flagged count overflows every batch; the
    output is then exactly full emission, as in the JAX engine."""
    jtxs, full_p, full_f, _ = streams
    cfg = dict(emit_threshold=1e-6, emit_cap_fraction=0.001)
    tp, tf, teng, stats = _run_port(jtxs, **cfg)
    _, _, jeng = _run_jax(jtxs, **cfg)
    assert teng.selective_overflows == jeng.selective_overflows > 0
    assert stats["selective_overflows"] == teng.selective_overflows
    np.testing.assert_array_equal(tp, full_p)
    np.testing.assert_array_equal(tf, full_f)


def test_selective_threshold_above_every_probability(streams):
    jtxs, full_p, _, _ = streams
    above = float(np.nextafter(full_p.max(), np.float32(2)))
    assert above <= 1.0
    tp, tf, teng, stats = _run_port(jtxs, emit_threshold=above)
    np.testing.assert_array_equal(tp, full_p)
    assert tp.any() and not tf.any()
    assert stats["selective_overflows"] == 0


def test_selective_overflows_are_a_per_run_count(streams):
    jtxs, _, _, _ = streams
    _, tcfg = _loop_configs(emit_threshold=1e-6, emit_cap_fraction=0.001)
    mean, scale = _scaler()
    params = weights.from_numpy(
        {"w": np.asarray(_logreg().w), "b": np.asarray(_logreg().b)},
        device="cpu")
    eng = ScoringEngine(tcfg, "logreg", params,
                        Scaler(torch.from_numpy(mean),
                               torch.from_numpy(scale)), device="cpu")
    s1 = eng.run(ReplaySource(_port_txs(jtxs.slice(slice(0, 1000))), START,
                              batch_rows=POLL))
    s2 = eng.run(ReplaySource(_port_txs(jtxs.slice(slice(0, 500))), START,
                              batch_rows=POLL))
    assert s1["selective_overflows"] == 4 and s2["selective_overflows"] == 2
    assert eng.selective_overflows == 6


# -- bf16 emission ------------------------------------------------------------

def test_bf16_emission_is_the_float32_features_rounded(streams):
    jtxs, full_p, full_f, _ = streams
    tp, tf, _, _ = _run_port(jtxs, emit_dtype="bfloat16")
    # the classifier read float32: predictions unchanged, bit for bit
    np.testing.assert_array_equal(tp, full_p)
    want = torch.from_numpy(full_f).to(torch.bfloat16).to(
        torch.float32).numpy()
    np.testing.assert_array_equal(tf, want)
    assert tf.dtype == np.float32
    jp, jf, _ = _run_jax(jtxs, emit_dtype="bfloat16")
    np.testing.assert_allclose(tp, jp, rtol=0, atol=ATOL_PROB)
    # the same rounding of the same float32 columns; the amount averages
    # within one bf16 step (their float32 sums differ by RTOL_SUM_ORDER)
    for c in range(15):
        if c in AVG_AMOUNT_COLS:
            np.testing.assert_allclose(tf[:, c], jf[:, c], rtol=2 ** -7)
        else:
            np.testing.assert_array_equal(tf[:, c], jf[:, c])


# -- the checks ---------------------------------------------------------------

@pytest.mark.parametrize("runtime,cache,match", [
    (dict(emit_threshold=1.5), False, "emit_threshold must be in"),
    (dict(emit_threshold=0.5, emit_cap_fraction=0.0), False,
     "emit_cap_fraction"),
    (dict(emit_threshold=0.5, emit_dtype="bfloat16"), False, "bfloat16"),
    (dict(emit_threshold=0.5, emit_features=False), False, "alerts-only"),
    (dict(emit_dtype="float16"), False, "emit_dtype must be"),
    (dict(emit_dtype="bfloat16"), True, "feature cache"),
    (dict(emit_threshold=0.5), True, "feature cache"),
    (dict(nan_guard=True), False, "dead-letter sink"),
])
def test_emission_refusals_match_the_jax_engine(runtime, cache, match):
    jcfg, tcfg = _loop_configs(**runtime)
    mean, scale = _scaler()
    jcache = None
    if cache:
        from real_time_fraud_detection_system_tpu.runtime import (
            FeatureCache as JFeatureCache,
        )

        jcache = JFeatureCache(capacity=64)
    with pytest.raises(ValueError, match=match):
        JScoringEngine(jcfg, kind="logreg", params=_logreg(),
                       scaler=JScaler(jnp.asarray(mean),
                                      jnp.asarray(scale)),
                       feature_cache=jcache)
    with pytest.raises(ValueError, match=match):
        ScoringEngine(tcfg, "logreg", weights.from_numpy(
            {"w": np.asarray(_logreg().w), "b": np.asarray(_logreg().b)},
            device="cpu"), Scaler(torch.from_numpy(mean),
                                  torch.from_numpy(scale)),
            device="cpu",
            feature_cache=FeatureCache(capacity=64) if cache else None)


@pytest.mark.parametrize("runtime", [dict(emit_threshold=0.5),
                                     dict(emit_dtype="bfloat16")])
def test_shadow_refuses_selective_and_bf16_emission(runtime):
    _, tcfg = _loop_configs(**runtime)
    mean, scale = _scaler()
    eng = ScoringEngine(tcfg, "logreg", weights.from_numpy(
        {"w": np.asarray(_logreg().w), "b": np.asarray(_logreg().b)},
        device="cpu"), Scaler(torch.from_numpy(mean),
                              torch.from_numpy(scale)), device="cpu")
    with pytest.raises(ValueError, match="shadow scoring"):
        eng.set_shadow(object())


# -- the non-finite guard -----------------------------------------------------

H = 3_600_000_000  # one hour in microseconds


def _batch(rows, labels=None):
    tx, ts, cust, term, cents = zip(*rows)
    cols = {
        "tx_id": np.array(tx, np.int64),
        "tx_datetime_us": np.array(ts, np.int64),
        "customer_id": np.array(cust, np.int64),
        "terminal_id": np.array(term, np.int64),
        "tx_amount_cents": np.array(cents, np.int64),
        "kafka_ts_ms": np.array(ts, np.int64) // 1000,
    }
    if labels is not None:
        cols["label"] = np.array(labels, np.int32)
    return cols


def _poisoned_batches(labels: bool):
    """JAX ``tests/test_faults.py``'s case: tx 3's amount hits the
    degenerate scaler column exactly (0/0 -> a NaN score); customer 5
    comes back in batch 3, whose windows show any contamination."""
    lab = (lambda *v: list(v)) if labels else (lambda *v: None)
    return [
        _batch([(1, 1 * H, 5, 9, 1000), (2, 2 * H, 6, 9, 2500)], lab(0, 1)),
        _batch([(3, 3 * H, 5, 9, 66600), (4, 4 * H, 6, 8, 1234)],
               lab(1, 0)),
        _batch([(5, 5 * H, 5, 9, 2000), (6, 6 * H, 6, 8, 700)], lab(0, 0)),
    ]


class _ListSource:
    def __init__(self, batches):
        self._batches = list(batches)
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


def _degenerate_scaler():
    mean = np.zeros(15, np.float32)
    scale = np.ones(15, np.float32)
    mean[0], scale[0] = 666.0, 0.0
    return mean, scale


def _guard_cfgs(guard: bool):
    _, tcfg = _loop_configs()
    fields = dict(batch_buckets=(64,), max_batch_rows=64, nan_guard=guard)
    from real_time_fraud_detection_system_tpu.config import (
        Config as JConfig,
    )
    from real_time_fraud_detection_system_tpu.config import (
        FeatureConfig as JFeatureConfig,
    )
    from real_time_fraud_detection_system_tpu.config import (
        RuntimeConfig as JRuntimeConfig,
    )

    feats = dict(customer_capacity=128, terminal_capacity=256,
                 cms_width=1 << 10)
    jcfg = JConfig(features=JFeatureConfig(**feats),
                   runtime=JRuntimeConfig(**fields))
    tcfg = dataclasses.replace(
        tcfg, features=dataclasses.replace(tcfg.features, **feats),
        runtime=dataclasses.replace(tcfg.runtime, **fields))
    return jcfg, tcfg


def _port_guarded(batches, guard, tmp_path, online_lr=0.0, name="dlq"):
    _, tcfg = _guard_cfgs(guard)
    mean, scale = _degenerate_scaler()
    dlq = DeadLetterSink(str(tmp_path / f"{name}.jsonl")) if guard else None
    eng = ScoringEngine(
        tcfg, "logreg", LogRegParams(torch.full((15,), 0.01),
                                     torch.tensor(0.0)),
        Scaler(torch.from_numpy(mean), torch.from_numpy(scale)),
        device="cpu", dead_letter=dlq, online_lr=online_lr)
    sink = MemorySink()
    eng.run(_ListSource(batches), sink=sink)
    return eng, sink.concat(), dlq


def _sorted(out: dict) -> dict:
    order = np.argsort(out["tx_id"])
    return {k: v[order] for k, v in out.items() if k != "processed_at_us"}


def test_nan_guard_quarantines_the_row_as_the_jax_engine(tmp_path):
    batches = _poisoned_batches(labels=False)
    clean = [{k: v[b["tx_id"] != 3] for k, v in b.items()} for b in batches]
    eng, out, dlq = _port_guarded(batches, True, tmp_path)
    _, ctrl, _ = _port_guarded(clean, False, tmp_path)
    recs = dlq.read_all()
    assert [r["tx_id"] for r in recs] == [3]
    assert recs[0]["reason"] == "nonfinite"
    out, ctrl = _sorted(out), _sorted(ctrl)
    assert np.isfinite(out["prediction"]).all()
    # bit for bit the run that never saw tx 3: predictions and windows
    for col in ctrl:
        np.testing.assert_array_equal(out[col], ctrl[col], err_msg=col)
    assert eng.state.batches_done == 3 and eng.state.rows_done == 5
    # the JAX engine's guard on the same batches
    jcfg, _ = _guard_cfgs(True)
    mean, scale = _degenerate_scaler()
    jdlq = JDeadLetterSink(str(tmp_path / "jdlq.jsonl"))
    jeng = JScoringEngine(
        jcfg, kind="logreg",
        params=JLogRegParams(w=jnp.full(15, 0.01, jnp.float32),
                             b=jnp.float32(0.0)),
        scaler=JScaler(jnp.asarray(mean), jnp.asarray(scale)),
        dead_letter=jdlq)
    jsink = JMemorySink()
    jeng.run(_ListSource(batches), sink=jsink)
    jout = _sorted(jsink.concat())
    assert [r["tx_id"] for r in jdlq.read_all()] == [3]
    for col in jout:
        if col == "prediction":
            np.testing.assert_allclose(out[col], jout[col], rtol=0,
                                       atol=ATOL_PROB)
        elif "avg_amount" in col:
            np.testing.assert_allclose(out[col], jout[col],
                                       rtol=RTOL_SUM_ORDER)
        else:
            np.testing.assert_array_equal(out[col], jout[col], err_msg=col)


def _poison_step(eng) -> None:
    """A step whose score of the row with amount 666.00 comes out NaN,
    after the state and the in-step SGD took the row in (a degenerate
    scaler would make every other row's SGD input infinite too)."""
    step = eng._step

    def poisoned(packed):
        out = step(packed)
        amount = packed[4].view(torch.float32)
        return out._replace(probs=torch.where(
            amount == 666.0, torch.full_like(out.probs, float("nan")),
            out.probs))

    eng._step = poisoned


def test_nan_guard_rolls_back_the_in_step_sgd(tmp_path):
    """Under the in-step SGD the step writes the params too: the twins
    hold them, and the re-scored batch leaves params, windows and scores
    as a run without the row does, bit for bit."""
    batches = _poisoned_batches(labels=True)
    clean = [{k: v[b["tx_id"] != 3] for k, v in b.items()} for b in batches]
    _, tcfg = _guard_cfgs(True)
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(0, 0.1, 15).astype(np.float32))

    def serve(bs, guard, name):
        cfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
            tcfg.runtime, nan_guard=guard))
        dlq = DeadLetterSink(str(tmp_path / f"{name}.jsonl")) \
            if guard else None
        eng = ScoringEngine(cfg, "logreg",
                            LogRegParams(w.clone(), torch.tensor(-1.0)),
                            Scaler(torch.zeros(15), torch.full((15,), 50.0)),
                            device="cpu", dead_letter=dlq, online_lr=0.05)
        _poison_step(eng)
        sink = MemorySink()
        eng.run(_ListSource(bs), sink=sink)
        return eng, sink.concat(), dlq

    eng, out, dlq = serve(batches, True, "sgd")
    ctrl_eng, ctrl, _ = serve(clean, False, "ctrl")
    assert np.isfinite(out["prediction"]).all()
    assert not np.array_equal(eng.state.params.w.numpy(), w.numpy())
    assert [r["tx_id"] for r in dlq.read_all()] == [3]
    np.testing.assert_array_equal(eng.state.params.w.numpy(),
                                  ctrl_eng.state.params.w.numpy())
    np.testing.assert_array_equal(eng.state.params.b.numpy(),
                                  ctrl_eng.state.params.b.numpy())
    for a, b in zip(eng.state.feature_state.customer,
                    ctrl_eng.state.feature_state.customer):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(_sorted(out)["prediction"],
                                  _sorted(ctrl)["prediction"])


def test_nan_guard_serves_at_depth_one_and_an_all_bad_batch(tmp_path):
    """Every row of batch 2 poisoned: an empty result keeps the batch
    index, and the stream goes on; the guard serves at depth 1."""
    batches = _poisoned_batches(labels=False)
    batches[1] = _batch([(3, 3 * H, 5, 9, 66600)])
    eng, out, dlq = _port_guarded(batches, True, tmp_path, name="all")
    assert [r["tx_id"] for r in dlq.read_all()] == [3]
    assert sorted(out["tx_id"].tolist()) == [1, 2, 5, 6]
    assert eng.state.batches_done == 3
    _, tcfg = _guard_cfgs(True)
    assert tcfg.runtime.pipeline_depth == 2
    stats = ScoringEngine(
        tcfg, "logreg", LogRegParams(torch.zeros(15), torch.tensor(0.0)),
        Scaler(torch.zeros(15), torch.ones(15)), device="cpu",
        dead_letter=DeadLetterSink(str(tmp_path / "d.jsonl"))).run(
            _ListSource(batches[:1]))
    assert stats["pipeline_depth"] == 1
