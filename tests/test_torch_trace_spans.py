"""The port's span tree, run-scoped span aggregates and device track
(``utils/trace.py``), on the CPU: each engine stage's children under it,
the ``trace`` entry of ``ScoringEngine.run``'s stats and its counters
against the configuration's arithmetic, nothing with the tracer off, the
export on ``torch.profiler``'s clock, and ``summarize_chrome``'s self
times and device idle credit on a fixed trace."""

import time

import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    AsyncSink,
    MemorySink,
)
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    synthetic_ensemble,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.utils import trace as ttrace
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
)

DAY0 = 20_000
ROWS = 2048  # a bucket whose work outweighs the spans' own cost
N_BATCHES = 4
CAPS = (4096, 8192)  # customer, terminal hot-tier slots
COMPACT_EVERY = 2
STAGES = ("source_poll", "host_prep", "dispatch", "result_wait",
          "sink_write")
CHILDREN = {
    "host_prep": ("host_prep/dedup", "host_prep/validate",
                  "host_prep/staging_wait", "host_prep/pack"),
    "dispatch": ("dispatch/h2d", "dispatch/replay", "dispatch/fetch_issue"),
    "result_wait": ("result_wait/fetch_wait", "result_wait/decode",
                    "result_wait/hooks", "result_wait/tail"),
    "sink_write": ("sink_write/convert",),
}


class _ListSource:
    def __init__(self, batches):
        self._batches = batches
        self._i = 0

    def poll_batch(self):
        if self._i >= len(self._batches):
            return None
        self._i += 1
        return dict(self._batches[self._i - 1])

    @property
    def offsets(self):
        return [self._i]


def _stream(seed=1, n_keys=3000):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(N_BATCHES):
        us = (((DAY0 + b) * 86400 + rng.integers(0, 86400, ROWS))
              .astype(np.int64) * 1_000_000)
        out.append({
            "tx_id": np.arange(b * ROWS, (b + 1) * ROWS, dtype=np.int64),
            "tx_datetime_us": us,
            "customer_id": rng.integers(0, n_keys, ROWS).astype(np.int64),
            "terminal_id": rng.integers(0, n_keys, ROWS).astype(np.int64),
            "tx_amount_cents": rng.integers(100, 50000, ROWS)
            .astype(np.int64),
            "kafka_ts_ms": us // 1000,
        })
    return out


def _engine(depth=2):
    rng = np.random.default_rng(3)
    cfg = Config(features=FeatureConfig(
        key_mode="exact", customer_capacity=CAPS[0],
        terminal_capacity=CAPS[1], compact_every=COMPACT_EVERY,
        cms_width=1024, windows=(1, 2, 3), delay_days=1, n_day_buckets=8),
        runtime=RuntimeConfig(batch_buckets=(ROWS,), pipeline_depth=depth))
    return ScoringEngine(
        cfg, "forest", synthetic_ensemble(8, 5, 15, seed=3, device="cpu"),
        Scaler(torch.from_numpy(rng.normal(3, 1, 15).astype(np.float32)),
               torch.from_numpy(rng.uniform(0.5, 3, 15)
                                .astype(np.float32))),
        device="cpu", metrics=MetricsRegistry())


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Every test starts from a reset process-wide tracer: a file that ran
    earlier on the same worker may have left it enabled (its export clock
    pinned minutes ago), with scopes aggregating or spans open."""
    ttrace.get_tracer().reset()
    yield


@pytest.fixture
def tracer():
    tr = ttrace.get_tracer()
    was = tr.enabled
    tr.clear()
    tr.configure(enabled=True)
    try:
        yield tr
    finally:
        tr.configure(enabled=was)
        tr.clear()


@pytest.mark.parametrize("depth", [1, 2])
def test_every_batch_has_its_stages_and_children_under_them(tracer, depth):
    """Each batch's five stages, each stage's children (and compaction's,
    on its batches) with the stage as parent, inside its interval; over
    the run, host prep's, dispatch's and the result wait's children cover
    at least 80% of the stage (the sink's own code is its self time)."""
    _engine(depth).run(_ListSource(_stream()), MemorySink())
    events = [e for e in tracer.export_chrome()["traceEvents"]
              if e["ph"] == "X"]
    by_id = {e["args"]["id"]: e for e in events}
    cover = {stage: [0.0, 0.0] for stage in CHILDREN if stage != "sink_write"}
    for b in range(1, N_BATCHES + 1):
        tid = f"b{b:08d}"
        evs = [e for e in events if e["args"]["trace_id"] == tid]
        roots = {e["name"]: e for e in evs if "parent" not in e["args"]}
        assert sorted(roots) == sorted(STAGES), tid
        want = dict(CHILDREN)
        if b % COMPACT_EVERY == 0:
            want["result_wait"] = want["result_wait"] + ("state_compact",)
        for stage, names in want.items():
            kids = [e for e in evs if e["args"].get("parent")
                    == roots[stage]["args"]["id"]]
            assert sorted(k["name"] for k in kids) == sorted(names), tid
            p = roots[stage]
            for k in kids:
                assert by_id[k["args"]["parent"]] is p
                assert k["tid"] == p["tid"]
                assert p["ts"] <= k["ts"]
                # the export rounds to the nanosecond
                assert k["ts"] + k["dur"] <= p["ts"] + p["dur"] + 2e-3
            if stage in cover:
                cover[stage][0] += sum(k["dur"] for k in kids)
                cover[stage][1] += p["dur"]
    for stage, (kids_us, stage_us) in cover.items():
        assert kids_us >= 0.8 * stage_us, (stage, kids_us, stage_us)


def test_run_trace_entry_names_every_span_and_counts_the_bytes(tracer):
    """The run's ``trace`` entry: every span name, counted once a batch
    (polls once more, compaction every second batch), medians within the
    run's, self times no longer than the totals, no device track on the
    CPU, and the counters' deltas of this run alone as the configuration
    sets them: 7 int32 rows of the bucket in, 16 float32 columns of each
    row and the 2 float32 tier counts out, every slot of both hot-tier
    tables swept each compaction, and no sequence rows."""
    eng = _engine()
    tracer.add_span("before_the_run", time.perf_counter(),
                    time.perf_counter())
    for seed in (1, 2):
        stats = eng.run(_ListSource(_stream(seed)), MemorySink())
        tr = stats["trace"]
        spans = tr["spans"]
        names = set(STAGES) | {"state_compact"} | {
            n for kids in CHILDREN.values() for n in kids}
        assert set(spans) == names
        for name, agg in spans.items():
            want = {"source_poll": N_BATCHES + 1,
                    "state_compact": N_BATCHES // COMPACT_EVERY
                    }.get(name, N_BATCHES)
            assert agg["count"] == want, name
            assert agg["self_ms"] >= 0.0 and agg["median_ms"] > 0.0
        assert spans["dispatch/replay"]["median_ms"] <= \
            spans["dispatch"]["median_ms"]
        assert tr["device"] == {}
        rows = stats["rows"]
        assert rows == N_BATCHES * ROWS
        assert tr["counters"] == {
            "transfer_bytes": {"h2d": N_BATCHES * 7 * ROWS * 4,
                               "d2h": rows * 16 * 4 + N_BATCHES * 2 * 4},
            "compact_slots_swept": {
                "customer": N_BATCHES // COMPACT_EVERY * CAPS[0],
                "terminal": N_BATCHES // COMPACT_EVERY * CAPS[1]},
            # the sequence step's rows by path: no series on a forest
            "sequence_rows_scored": {}}
    assert not tracer._scopes


def test_async_sink_conversion_stays_off_the_batches(tracer):
    """Behind an ``AsyncSink`` the conversion runs on the writer thread,
    where no span is open: it is recorded for the timeline only (no
    batch, no parent), so each batch's phases are its five stages alone
    and ``sink_write`` has no child; the conversion is recorded once a
    batch (the last poll, finding the source dry, only polls)."""
    sink = AsyncSink(MemorySink(), registry=MetricsRegistry())
    try:
        _engine().run(_ListSource(_stream()), sink)
    finally:
        sink.close()
    trace = tracer.export_chrome()
    digest = ttrace.summarize_chrome(trace)
    # the last poll, which finds the source dry, opens a batch of its own
    *batches, last = digest["batches"]
    assert len(batches) == N_BATCHES
    assert list(last["phases_ms"]) == ["source_poll"]
    for b in batches:
        assert sorted(b["phases_ms"]) == sorted(STAGES), b["trace_id"]
        assert not any(k.startswith("sink_write/")
                       for k in b["children_ms"]), b["trace_id"]
    convert = [e for e in trace["traceEvents"]
               if e["name"] == "sink_write/convert"]
    assert len(convert) == N_BATCHES
    assert all(e["args"]["trace_id"] == "" and "parent" not in e["args"]
               for e in convert)
    assert not any(e["name"].startswith("sink/")
                   for e in trace["traceEvents"])


def test_tracer_off_records_no_span_and_no_trace_entry():
    tr = ttrace.get_tracer()
    was = tr.enabled
    tr.configure(enabled=False)
    tr.clear()
    try:
        stats = _engine().run(_ListSource(_stream()), MemorySink())
        assert "trace" not in stats
        assert len(tr) == 0 and not tr._scopes
        assert tr.span("host_prep/dedup") is tr.span("sink_write/convert")
    finally:
        tr.configure(enabled=was)


def test_export_lays_over_the_profilers_clock(tracer):
    """Under ``torch.profiler`` (CPU activity) a span opens a profiler
    annotation of its name; once exported, the span and the annotation
    start within 50 µs of each other on the same clock (after a first
    span, whose annotation builds the profiler's operator)."""
    from torch.profiler import ProfilerActivity, profile

    tracer.begin_batch(7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("warm_up"):
            pass
        for i in range(5):
            with tracer.span(f"clock_check_{i}"):
                time.sleep(0.002)
    starts = {e.name(): e.start_ns() / 1e3
              for e in prof.profiler.kineto_results.events()}
    spans = {e["name"]: e["ts"] for e in tracer.export_chrome()[
        "traceEvents"] if e["name"].startswith("clock_check_")}
    assert len(spans) == 5
    for name, ts in spans.items():
        assert abs(starts[f"rtfds.{name}#7"] - ts) < 50.0, name


# A fixed trace with parents and a device track: batch 1's stage "a"
# (0-100 µs) has children "a/x" (10-40) and "a/y" (50-90, and its own child
# "a/y/z" 60-70); the device ran 0-20, 45-55 and 95-120 µs.
TREE_TRACE = {"traceEvents": [
    {"ph": "X", "name": "a", "cat": "rtfds", "ts": 0.0, "dur": 100.0,
     "pid": 1, "tid": 7, "args": {"trace_id": "b00000001", "batch": 1,
                                  "id": 1}},
    {"ph": "X", "name": "a/x", "cat": "rtfds", "ts": 10.0, "dur": 30.0,
     "pid": 1, "tid": 7, "args": {"trace_id": "b00000001", "batch": 1,
                                  "id": 2, "parent": 1}},
    {"ph": "X", "name": "a/y", "cat": "rtfds", "ts": 50.0, "dur": 40.0,
     "pid": 1, "tid": 7, "args": {"trace_id": "b00000001", "batch": 1,
                                  "id": 3, "parent": 1}},
    {"ph": "X", "name": "a/y/z", "cat": "rtfds", "ts": 60.0, "dur": 10.0,
     "pid": 1, "tid": 7, "args": {"trace_id": "b00000001", "batch": 1,
                                  "id": 4, "parent": 3}},
    {"ph": "X", "name": "b", "cat": "rtfds", "ts": 100.0, "dur": 30.0,
     "pid": 1, "tid": 7, "args": {"trace_id": "b00000001", "batch": 1,
                                  "id": 5}},
    {"ph": "X", "name": "device/step", "cat": "device", "ts": 0.0,
     "dur": 20.0, "pid": 1, "tid": 0,
     "args": {"trace_id": "b00000001", "batch": 1, "id": 6}},
    {"ph": "X", "name": "device/compact", "cat": "device", "ts": 45.0,
     "dur": 10.0, "pid": 1, "tid": 0,
     "args": {"trace_id": "b00000001", "batch": 1, "id": 7}},
    {"ph": "X", "name": "device/step", "cat": "device", "ts": 95.0,
     "dur": 25.0, "pid": 1, "tid": 0,
     "args": {"trace_id": "b00000001", "batch": 1, "id": 8}},
]}


def test_summary_self_times_and_device_idle_credit():
    """Phases over the roots, children and self times (a span less what
    its children cover), and each device gap credited to the innermost
    host span that covers at least half of it: 20-45 µs to ``a/x`` (20 of
    25 µs), 55-95 µs to ``a/y`` (35 of 40; its child ``a/y/z`` 10)."""
    s = ttrace.summarize_chrome(TREE_TRACE)
    (b,) = s["batches"]
    assert b["phases_ms"] == {"a": 0.1, "b": 0.03}
    assert b["total_ms"] == 0.13 and b["critical_phase"] == "a"
    assert b["children_ms"] == {"a/x": 0.03, "a/y": 0.04, "a/y/z": 0.01}
    assert b["self_ms"] == {"a": 0.03, "a/x": 0.03, "a/y": 0.03,
                            "a/y/z": 0.01, "b": 0.03}
    assert s["device_idle_by_span"] == {"a/x": 0.025, "a/y": 0.04}
    assert s["device_window_ms"] == 0.12 and s["device_busy_ms"] == 0.055
    assert s["n_events"] == 8


def test_scope_aggregates_only_what_completes_while_open():
    tr = ttrace.Tracer(enabled=True)
    with tr.span("early"):
        pass
    scope = tr.open_scope()
    with tr.span("stage"):
        with tr.span("stage/part"):
            time.sleep(0.001)
    t = time.perf_counter()
    tr.add_device_span("device/step", t - 0.004, t - 0.001)
    tr.add_device_span("device/step", t - 0.002, t)
    got = tr.close_scope(scope)
    assert tr.close_scope(scope) == got and not tr._scopes
    assert set(got["spans"]) == {"stage", "stage/part"}
    stage, part = got["spans"]["stage"], got["spans"]["stage/part"]
    assert stage["count"] == part["count"] == 1
    assert part["self_ms"] == pytest.approx(part["median_ms"])
    assert stage["self_ms"] == pytest.approx(
        stage["median_ms"] - part["median_ms"])
    dev = got["device"]["device/step"]
    assert dev["count"] == 2
    assert dev["mean_ms"] == pytest.approx(2.5, abs=1e-6)
    assert dev["median_ms"] == pytest.approx(2.5, abs=1e-6)
