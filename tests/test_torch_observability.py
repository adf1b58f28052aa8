"""Port parity: observability — the Prometheus text and the snapshot,
``MetricsServer``'s four endpoints and ``/healthz`` body, ``run_manifest``,
the flight record with ``set_sample_every``, the span tracer and
``summarize_chrome``, the engine's metric families and per-batch flight
records, and the overload ladder's components read from the live source,
prefetch and sink series.

Tolerances: text, JSON bodies, record fields, digests and components are
compared exactly (the same registry content renders the same bytes; the
clock is pinned where a body carries an age).
"""

import json
import time
import urllib.error
import urllib.request

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
    OverloadConfig as JOverloadConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.io import sink as jsink
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu.runtime import overload as joverload
from real_time_fraud_detection_system_tpu.runtime import prefetch as jprefetch
from real_time_fraud_detection_system_tpu.runtime import sources as jsources
from real_time_fraud_detection_system_tpu.utils import metrics as jmetrics
from real_time_fraud_detection_system_tpu.utils import trace as jtrace
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    OverloadConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io import sink as tsink
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.runtime import (
    overload as toverload,
)
from real_time_fraud_detection_system_tpu_torch.runtime import (
    prefetch as tprefetch,
)
from real_time_fraud_detection_system_tpu_torch.runtime import (
    sources as tsources,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    PHASES,
    TRANSFER_BYTES,
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.utils import (
    metrics as tmetrics,
)
from real_time_fraud_detection_system_tpu_torch.utils import trace as ttrace
from real_time_fraud_detection_system_tpu_torch.utils.tracing import (
    profile_to,
)

torch.set_num_threads(1)

EPOCH0 = 1_743_465_600
NOW = 1_800_000_000.0
WAIT_S = 5.0


def _fill(reg, **over):
    """The same content in a registry of either package: every type,
    labels that need escaping, a histogram with samples in several
    buckets and past the last bound."""
    reg.counter("rtfds_rows_total", "rows scored").inc(1234)
    reg.counter("rtfds_sink_rows_total", "rows written",
                sink='par"quet\\x').inc(7)
    reg.gauge("rtfds_queue_depth", "in flight").set(2)
    reg.gauge("rtfds_source_lag_rows", "backlog").set(
        over.get("lag", 4096.5))
    h = reg.histogram("rtfds_batch_latency_seconds", "latency")
    for v in (3e-6, 0.004, 0.004, 0.3, 75.0):
        h.observe(v)
    reg.histogram("rtfds_phase_seconds", "phases",
                  phase="host_prep").observe(0.002)
    reg.gauge("rtfds_last_batch_unix_seconds", "last").set(
        over.get("last", NOW - 5.0))


def test_prometheus_text_and_snapshot_match_jax():
    regs = [jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()]
    for r in regs:
        _fill(r)
    texts = [r.render_prometheus() for r in regs]
    assert texts[0] == texts[1]
    assert 'sink="par\\"quet\\\\x"' in texts[1]
    assert 'rtfds_batch_latency_seconds_bucket{le="+Inf"} 5' in texts[1]
    snaps = [r.snapshot() for r in regs]
    assert json.dumps(snaps[0], sort_keys=True) == json.dumps(
        snaps[1], sort_keys=True)
    assert (jmetrics.render_snapshot_prometheus(snaps[0])
            == tmetrics.render_snapshot_prometheus(snaps[1])
            == texts[1])


def _health_content(reg, case: str):
    _fill(reg, last=NOW - (400.0 if case == "stale" else 5.0))
    reg.counter("rtfds_engine_restarts_total", "r", cause="crash").inc(2)
    reg.counter("rtfds_engine_restarts_total", "r", cause="stall").inc()
    reg.counter("rtfds_crash_loops_total", "c").inc()
    reg.gauge("rtfds_checkpoint_lineage_depth", "d").set(3)
    reg.gauge("rtfds_last_checkpoint_unix_seconds", "c").set(NOW - 9.0)
    reg.counter("rtfds_feature_cache_lookups_total", "l",
                outcome="hit").inc(90)
    reg.counter("rtfds_feature_cache_lookups_total", "l",
                outcome="miss").inc(10)
    reg.gauge("rtfds_feature_cache_occupancy", "o").set(77)
    reg.gauge("rtfds_feature_cache_capacity", "c").set(128)
    for t, v in (("customer", 11), ("terminal", 22)):
        reg.gauge("rtfds_feature_slots_occupied", "o", table=t).set(v)
        reg.counter("rtfds_feature_slots_reclaimed_total", "r",
                    table=t).inc(v // 2)
    reg.counter("rtfds_feature_tier_rows_total", "t", tier="dense").inc(30)
    reg.counter("rtfds_feature_tier_rows_total", "t", tier="cms").inc(10)
    reg.gauge("rtfds_feature_state_bytes", "b", tier="total").set(1000)
    reg.gauge("rtfds_feature_state_budget_bytes", "b").set(4000)
    reg.gauge("rtfds_feature_cold_keys", "k").set(5)
    reg.counter("rtfds_feature_cold_promotions_total", "p").inc(3)
    reg.gauge("rtfds_feature_cold_promote_backlog", "b").set(1)
    reg.gauge("rtfds_feature_cold_promote_queue_limit", "q").set(64)
    for m in ("f32", "bf16", "int8"):
        reg.gauge("rtfds_z_mode", "z", mode=m).set(1.0 if m == "int8"
                                                     else 0.0)
    reg.gauge("rtfds_use_pallas", "p").set(1)
    reg.gauge("rtfds_model_version", "v", role="champion").set(2)
    reg.gauge("rtfds_model_version", "v", role="candidate").set(3)
    reg.counter("rtfds_model_promotions_total", "p",
                outcome="promoted").inc()
    reg.counter("rtfds_model_rollbacks_total", "r").inc(0)
    if case == "dlq":
        reg.gauge("rtfds_dead_letter_rows", "d").set(3)
    if case == "overload":
        reg.gauge("rtfds_overload_rung", "r").set(2)
        reg.gauge("rtfds_shed_pending_rows", "p").set(256)
        reg.counter("rtfds_shed_rows_total", "s").inc(512)
        reg.counter("rtfds_overload_transitions_total", "t",
                    direction="climb").inc(2)
        reg.gauge("rtfds_source_lag_trend_rows_per_s", "t").set(-3.5)
    if case == "fallback":
        reg.gauge("rtfds_checkpoint_serving_fallback", "f").set(1)


@pytest.mark.parametrize("case,lag_max", [
    ("ok", None), ("ok", 10_000.0), ("lagging", 100.0), ("stale", None),
    ("dlq", None), ("overload", None), ("fallback", None), ("empty", None)])
def test_healthz_body_matches_jax(monkeypatch, case, lag_max):
    """The same registry content gives the same ``/healthz`` verdict and
    body in both packages (the fleet's per-shard fields are A7's)."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    bodies = []
    for m in (jmetrics, tmetrics):
        reg = m.MetricsRegistry()
        if case != "empty":
            _health_content(reg, case)
        server = m.MetricsServer(registry=reg, max_source_lag_rows=lag_max)
        bodies.append(server.health())
    assert bodies[0] == bodies[1]
    ok, body = bodies[1]
    want = {"ok": "ok", "lagging": "unhealthy", "stale": "unhealthy",
            "dlq": "degraded", "overload": "degraded",
            "fallback": "degraded", "empty": "ok"}[case]
    assert body["status"] == want and ok == (want != "unhealthy")


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=WAIT_S) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_metrics_server_endpoints_match_jax(monkeypatch):
    """Both servers on an ephemeral port answer ``/metrics``,
    ``/metrics.json``, ``/healthz``, ``/trace`` and a 404 with the same
    status, type and (but for ``/trace``, whose spans are each process
    tracer's own) body."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    servers = []
    for m in (jmetrics, tmetrics):
        reg = m.MetricsRegistry()
        _health_content(reg, "ok")
        servers.append(m.MetricsServer(port=0, registry=reg,
                                       max_source_lag_rows=10.0).start())
    try:
        for path in ("/metrics", "/metrics.json", "/healthz", "/nope",
                     "/trace?x=1"):
            got = [_get(s.url + path) for s in servers]
            assert got[0][:2] == got[1][:2], path
            if path != "/trace?x=1":
                assert got[0][2] == got[1][2], path
        code, _, body = got[1]
        assert code == 200 and "traceEvents" in json.loads(body)
        code, _, body = _get(servers[1].url + "/healthz")
        assert code == 503 and json.loads(body)["status"] == "unhealthy"
    finally:
        for s in servers:
            s.stop()
    assert servers[1]._thread is None and servers[1]._httpd is None


def test_run_manifest_keys_match_jax():
    jm = jmetrics.run_manifest(cfg=JConfig(), model_kind="forest",
                               scorer="tpu", source="replay")
    tm = tmetrics.run_manifest(cfg=Config(), model_kind="forest",
                               scorer="tpu", source="replay")
    assert sorted(jm) == sorted(tm)
    assert tm["backend"] == "cpu" and tm["n_devices"] == 1
    assert len(tm["config_hash"]) == 16
    assert tmetrics.run_manifest(backend="cuda")["backend"] == "cuda"


def _records(m, path, sample_every=1):
    rec = m.FlightRecorder(str(path), manifest={"model_kind": "forest",
                                                "start_unix_s": 1.0})
    for i in range(1, 8):
        if i == 3:
            rec.set_sample_every(sample_every)
        rec.record_batch(i, 100 + i, {"host_prep": 0.25, "dispatch": 0.5},
                         queue_depth=i % 3, latency_s=0.75,
                         trace_id=f"b{i:08d}")
        if i == 4:
            rec.record_event("overload_climb", rung=1)
    rec.close()
    man, records = m.FlightRecorder.read(str(path))
    return man, [{k: v for k, v in r.items() if k != "t"} for r in records]


@pytest.mark.parametrize("sample_every", [1, 3])
def test_flight_record_fields_and_sampling_match_jax(tmp_path, sample_every):
    """The same calls write the same records: the batch fields, the
    sampled batches once rung 1 thins the record, events never sampled."""
    jgot = _records(jmetrics, tmp_path / "j.jsonl", sample_every)
    tgot = _records(tmetrics, tmp_path / "t.jsonl", sample_every)
    assert jgot == tgot
    batches = [r["batch"] for r in tgot[1] if r["kind"] == "batch"]
    assert batches == ([1, 2, 3, 4, 5, 6, 7] if sample_every == 1
                       else [1, 2, 3, 6])
    assert any(r.get("event") == "overload_climb" for r in tgot[1])


FIXED_TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "ts": 0,
     "args": {"name": "rtfds"}},
    {"ph": "X", "name": "host_prep", "ts": 10.0, "dur": 250.0, "pid": 1,
     "tid": 7, "args": {"trace_id": "b00000001", "batch": 1}},
    {"ph": "X", "name": "dispatch", "ts": 260.0, "dur": 900.5, "pid": 1,
     "tid": 7, "args": {"trace_id": "b00000001", "batch": 1, "rows": 5}},
    {"ph": "X", "name": "host_prep", "ts": 300.0, "dur": 50.0, "pid": 1,
     "tid": 7, "args": {"trace_id": "b00000002", "batch": 2}},
    {"ph": "X", "name": "source/replay", "ts": 1.0, "dur": 3.0, "pid": 1,
     "tid": 8, "args": {"trace_id": "", "batch": 0}},
    {"ph": "X", "name": "xla_compile", "ts": 0.0, "dur": 5000.0, "pid": 1,
     "tid": 7, "args": {"trace_id": "b00000002", "batch": 2, "fn": "s"}},
    {"ph": "i", "name": "reload", "ts": 5.0, "pid": 1, "tid": 7},
]}


@pytest.mark.parametrize("top_k", [1, 3, 10])
def test_summarize_chrome_matches_jax(top_k):
    assert (jtrace.summarize_chrome(FIXED_TRACE, top_k=top_k)
            == ttrace.summarize_chrome(FIXED_TRACE, top_k=top_k))


def test_tracer_spans_and_export_match_jax_shape():
    """The port's tracer with the JAX tracer's API: disabled spans are
    the shared no-op, explicit batches, ``add_span`` and ``instant``;
    its export digests as the JAX package digests it, and no NVTX range
    opens unless asked (a CPU build has no NVTX at all)."""
    tr = ttrace.Tracer(capacity=8)
    assert tr.span("x") is tr.span("y") and tr.begin_batch(1) == ""
    tr.configure(enabled=True)
    assert tr.begin_batch(3) == "b00000003"
    with tr.span("host_prep", rows=4):
        pass
    with tr.span("result_wait", batch="b00000002"):
        pass
    tr.add_span("source/replay", time.perf_counter(), time.perf_counter(),
                batch="")
    tr.instant("reload")
    trace = tr.export_chrome()
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert sorted(names) == ["host_prep", "reload", "result_wait",
                             "source/replay"]
    assert trace["otherData"]["tracing_enabled"] is True
    assert jtrace.summarize_chrome(trace) == ttrace.summarize_chrome(trace)
    by = {b["trace_id"]: b for b in ttrace.summarize_chrome(trace)
          ["batches"]}
    assert set(by) == {"b00000002", "b00000003"}
    with pytest.raises(RuntimeError, match="NVTX"):
        with tr.span("dispatch", nvtx=True):
            pass
    tr.configure(capacity=2)
    assert len(tr) <= 2 and tr.capacity == 2


def _port_params(params):
    import jax

    return weights.from_numpy(jax.tree.map(np.asarray, params),
                              device="cpu")


def _forest_engines(cfg_kw, registry_t, registry_j):
    params = jforest.synthetic_ensemble(6, 4, 15, seed=1)
    rng = np.random.default_rng(2)
    mean = rng.normal(size=15).astype(np.float32)
    scale = rng.uniform(0.5, 2, 15).astype(np.float32)
    tcfg = Config(features=FeatureConfig(customer_capacity=256,
                                         terminal_capacity=512),
                  runtime=RuntimeConfig(batch_buckets=(256,), **cfg_kw))
    jcfg = JConfig(features=JFeatureConfig(customer_capacity=256,
                                           terminal_capacity=512),
                   runtime=JRuntimeConfig(batch_buckets=(256,), **cfg_kw))
    teng = ScoringEngine(tcfg, "forest", _port_params(params),
                         Scaler(torch.from_numpy(mean),
                                torch.from_numpy(scale)),
                         device="cpu", metrics=registry_t)
    jeng = JScoringEngine(jcfg, kind="forest", params=params,
                          scaler=JScaler(jnp.asarray(mean),
                                         jnp.asarray(scale)),
                          metrics=registry_j)
    return teng, jeng


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


# Families each engine registers that the other does not, each named:
# the port's graph counters (the JAX package counts AOT compiles in
# rtfds_precompiled_steps_total, which both register) and its transfer
# bytes; the JAX engine's recompile alarm, which has no counterpart in the
# port (nothing is compiled while it serves), and its fetch head start
# (the test finds it by the JAX engine's series), which the port's
# result_wait/fetch_wait span and device track replace.
PORT_ONLY = {"cuda_graph_captures_total", "cuda_graph_recaptures_total",
             TRANSFER_BYTES}
JAX_ONLY = {"rtfds_xla_recompiles_total"}


def test_engine_metric_families_are_the_jax_engines(small_dataset,
                                                    tmp_path):
    """After 3 batches each engine's own registry holds the same families
    — the port's a subset of the JAX engine's but for the named
    exceptions — and the per-batch series agree."""
    treg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    teng, jeng = _forest_engines({}, treg, jreg)
    jtxs = small_dataset[3].slice(slice(0, 768))
    teng.run(tsources.ReplaySource(_port_txs(jtxs), EPOCH0,
                                   batch_rows=256), tsink.MemorySink())
    jeng.run(jsources.ReplaySource(jtxs, EPOCH0, batch_rows=256),
             jsink.MemorySink())
    tfam, jfam = set(treg.snapshot()), set(jreg.snapshot())
    head_start = {n for n in jfam if jreg.get(n) is jeng._m_fetch_overlap}
    assert tfam - jfam == PORT_ONLY
    assert len(head_start) == 1
    assert jfam - tfam == JAX_ONLY | head_start
    for name in ("rtfds_batches_total", "rtfds_rows_total"):
        assert treg.get(name).value == jreg.get(name).value
    for ph in PHASES:
        assert treg.get("rtfds_phase_seconds", phase=ph).count == \
            jreg.get("rtfds_phase_seconds", phase=ph).count, ph
    assert treg.get("rtfds_batch_latency_seconds").count == 3
    assert treg.get("rtfds_queue_depth").value == 0
    assert treg.get("rtfds_z_mode", mode="f32").value == 1.0
    assert treg.get("rtfds_use_pallas").value == 1.0  # the fused forest


def test_engine_flight_record_and_spans_match_jax(small_dataset, tmp_path):
    """With the tracer on and a flight record, each engine writes one
    batch record per batch with the same fields (its phases are the
    loop's five, its trace id names the batch's spans), and the exported
    spans hold one host_prep, dispatch, result_wait and sink_write span
    per batch, on a CPU engine without NVTX."""
    jt, tt = jtrace.get_tracer(), ttrace.get_tracer()
    keep = (jt.enabled, tt.enabled)
    jt.configure(enabled=True, annotate=False)
    tt.configure(enabled=True)
    jt.clear()
    tt.clear()
    try:
        treg, jreg = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
        teng, jeng = _forest_engines({}, treg, jreg)
        assert teng._nvtx is False
        teng.recorder = tmetrics.FlightRecorder(str(tmp_path / "t.jsonl"))
        jeng.recorder = jmetrics.FlightRecorder(str(tmp_path / "j.jsonl"))
        jtxs = small_dataset[3].slice(slice(0, 768))
        teng.run(tsources.ReplaySource(_port_txs(jtxs), EPOCH0,
                                       batch_rows=256), tsink.MemorySink())
        jeng.run(jsources.ReplaySource(jtxs, EPOCH0, batch_rows=256),
                 jsink.MemorySink())
        teng.recorder.close()
        jeng.recorder.close()
        trecs = [r for r in tmetrics.FlightRecorder.read(
            str(tmp_path / "t.jsonl"))[1] if r["kind"] == "batch"]
        jrecs = [r for r in jmetrics.FlightRecorder.read(
            str(tmp_path / "j.jsonl"))[1] if r["kind"] == "batch"]
        assert len(trecs) == len(jrecs) == 3
        for t, j in zip(trecs, jrecs):
            assert sorted(t) == sorted(j)
            assert sorted(t["phases"]) == sorted(j["phases"]) \
                == sorted(PHASES)
            assert (t["batch"], t["rows"], t["trace_id"]) == \
                (j["batch"], j["rows"], j["trace_id"])
        tsum = ttrace.summarize_chrome(tt.export_chrome())
        jsum = jtrace.summarize_chrome(jt.export_chrome())
        # the final, empty poll opens the next batch's source_poll span
        assert [b["trace_id"] for b in tsum["batches"]] == \
            [b["trace_id"] for b in jsum["batches"]] == \
            [r["trace_id"] for r in trecs] + ["b00000004"]
        for tb, jb in zip(tsum["batches"], jsum["batches"]):
            # the JAX engine's first batch also holds its jit compile
            assert sorted(tb["phases_ms"]) == sorted(
                k for k in jb["phases_ms"] if k != "xla_compile")
        names = [e["name"] for e in tt.export_chrome()["traceEvents"]]
        for ph in ("host_prep", "dispatch", "result_wait", "sink_write"):
            assert names.count(ph) == 3, ph
    finally:
        jt.configure(enabled=keep[0])
        tt.configure(enabled=keep[1])
        jt.clear()
        tt.clear()


def test_profile_to_writes_a_chrome_trace(tmp_path):
    with profile_to(str(tmp_path / "prof")):
        torch.ones(4).sum()
    with profile_to(None):
        pass
    files = list((tmp_path / "prof").iterdir())
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def _ladder_components(small_dataset, monkeypatch, pkg):
    """Live series in a fresh registry: a replay source's lag (read
    ahead by a prefetcher of 4 batches), the prefetch queue's depth, and
    an async sink whose writer holds one result while two more wait;
    then the controller's components."""
    import threading

    sources, prefetch, sink, overload, metrics, cfg_cls, ocfg_cls = (
        (jsources, jprefetch, jsink, joverload, jmetrics, JRuntimeConfig,
         JOverloadConfig) if pkg == "jax" else
        (tsources, tprefetch, tsink, toverload, tmetrics, RuntimeConfig,
         OverloadConfig))
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(sources, "get_registry", lambda: reg)
    jtxs = small_dataset[3].slice(slice(0, 4096))
    txs = jtxs if pkg == "jax" else _port_txs(jtxs)
    inner = sources.ReplaySource(txs, EPOCH0, batch_rows=256)
    pf = prefetch.PrefetchSource(inner, max_batches=4, registry=reg)
    started, gate = threading.Event(), threading.Event()

    class _Held:
        def append(self, res):
            started.set()
            gate.wait(WAIT_S)

    snk = sink.AsyncSink(_Held(), max_queue=4, registry=reg)
    try:
        t0 = time.monotonic()
        while not (pf._q.qsize() == 4 and inner.offsets == [5 * 256]):
            assert time.monotonic() - t0 < WAIT_S
            time.sleep(0.01)
        snk.append(object())
        started.wait(WAIT_S)
        snk.append(object())
        snk.append(object())
        rcfg = cfg_cls(prefetch_batches=4, sink_queue_batches=4,
                       overload=ocfg_cls(enabled=True, spill_path="",
                                         lag_high_rows=2048))
        ctl = overload.OverloadController(rcfg, registry=reg)
        return ctl._pressure(include_latency=False)
    finally:
        gate.set()
        snk.close()
        pf.close()


def test_ladder_components_read_the_live_series(small_dataset, monkeypatch):
    """The ladder's ``lag``, ``prefetch_fill`` and ``sink_fill`` come from
    the series the source, the prefetcher and the async sink publish,
    and equal the JAX controller's over the JAX package's own."""
    jp, jc = _ladder_components(small_dataset, monkeypatch, "jax")
    tp, tc = _ladder_components(small_dataset, monkeypatch, "port")
    assert (tp, tc) == (jp, jc)
    assert tc == {"lag": (4096 - 5 * 256) / 2048, "prefetch_fill": 1.0,
                  "sink_fill": 0.5}
    assert tp == 1.375


def test_overload_climbs_on_the_live_sink_series(small_dataset, tmp_path):
    """An engine whose async sink's writer is slow for its first batches:
    the ladder climbs on ``sink_fill`` from the sink's own series (the
    flight record's climb events name the component), descends to rung 0
    once the writer keeps up, and the scores equal an unthrottled run's."""
    reg = tmetrics.MetricsRegistry()
    cfg = Config(features=FeatureConfig(customer_capacity=256,
                                        terminal_capacity=512),
                 runtime=RuntimeConfig(
                     batch_buckets=(256,), sink_queue_batches=2,
                     pipeline_depth=1,
                     overload=OverloadConfig(
                         enabled=True, spill_path="", climb_dwell_batches=1,
                         descend_dwell_batches=1, recorder_sample_every=2)))
    params = _port_params(jforest.synthetic_ensemble(4, 3, 15, seed=2))
    scaler = Scaler(torch.zeros(15), torch.ones(15))
    txs = _port_txs(small_dataset[3].slice(slice(0, 12288)))

    class _Slow(tsink.MemorySink):
        def append(self, res):
            if len(self.batches) < 4:
                time.sleep(0.03)
            super().append(res)

    class _QuietSpell:
        """From the 12th poll, zero-row polls until the sink's writer has
        caught up, and one more: a live stream's lull, the ladder's clock
        while rung 3 defers every batch."""

        def __init__(self, inner):
            self.inner, self.polls, self.quiet = inner, 0, 0
            self.t0 = None

        def poll_batch(self):
            self.polls += 1
            if self.polls > 12 and self.quiet < 2:
                self.t0 = self.t0 or time.monotonic()
                assert time.monotonic() - self.t0 < WAIT_S
                self.quiet += snk._q.unfinished_tasks == 0
                cols = self.inner.poll_batch()
                self.inner.seek([self.inner.offsets[0] - len(cols["tx_id"])])
                return {k: v[:0] for k, v in cols.items()}
            return self.inner.poll_batch()

        @property
        def offsets(self):
            return self.inner.offsets

    ref = tsink.MemorySink()
    ScoringEngine(cfg, "forest", params, scaler, device="cpu",
                  metrics=tmetrics.MetricsRegistry()).run(
        tsources.ReplaySource(txs, EPOCH0, batch_rows=256), ref)
    inner = _Slow()
    snk = tsink.AsyncSink(inner, max_queue=2, registry=reg)
    eng = ScoringEngine(cfg, "forest", params, scaler, device="cpu",
                        metrics=reg)
    eng.recorder = tmetrics.FlightRecorder(str(tmp_path / "fr.jsonl"))
    try:
        eng.run(_QuietSpell(tsources.ReplaySource(txs, EPOCH0,
                                                  batch_rows=256)), snk)
    finally:
        snk.close()
        eng.recorder.close()
    events = [r for r in tmetrics.FlightRecorder.read(
        str(tmp_path / "fr.jsonl"))[1] if r["kind"] == "event"]
    climbs = [e for e in events if e["event"] == "overload_climb"]
    assert climbs and all("sink_fill" in e for e in climbs)
    assert reg.get("rtfds_overload_rung").value == 0
    a, b = ref.concat(), inner.concat()
    assert np.array_equal(a["tx_id"], b["tx_id"])
    assert np.array_equal(a["prediction"], b["prediction"])
