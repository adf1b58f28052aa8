"""Port parity: the ingest sources — ``RawTableSource`` over the
persistent raw-transactions table in both directions (a table one package
writes, the other reads), ``KafkaSource`` through a copy of the fake
``confluent_kafka`` module of ``tests/test_kafka_source.py`` (the same
columns, offsets and commits as the JAX source's), the tables' upsert
semantics, and the per-source and per-sink series against the JAX
package's on one stream.

Tolerances: everything here is integer or bit-identical — batches,
columns, offsets, commits, partitions, watermark refusals and the
series' counts.
"""

import os
import sys
import types

import numpy as np
import pytest

from real_time_fraud_detection_system_tpu.core.envelope import (
    encode_transaction_envelopes,
)
from real_time_fraud_detection_system_tpu.io import sink as jsink
from real_time_fraud_detection_system_tpu.io import tables as jtables
from real_time_fraud_detection_system_tpu.runtime import sources as jsources
from real_time_fraud_detection_system_tpu.utils import metrics as jmetrics
from real_time_fraud_detection_system_tpu_torch.core import schema
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io import sink as tsink
from real_time_fraud_detection_system_tpu_torch.io import tables as ttables
from real_time_fraud_detection_system_tpu_torch.runtime import (
    sources as tsources,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    BatchResult,
)
from real_time_fraud_detection_system_tpu_torch.utils import (
    metrics as tmetrics,
)

EPOCH0 = 1_743_465_600
US_PER_DAY = 86_400 * 1_000_000
TOPIC = "debezium.payment.transactions"
OFFSET_INVALID = -1001


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def _raw_cols(n: int, seed: int, first_id: int = 0, day0: int = 20180):
    rng = np.random.default_rng(seed)
    return {
        "tx_id": np.arange(first_id, first_id + n, dtype=np.int64),
        "tx_datetime_us": ((day0 + rng.integers(0, 6, n)) * 86_400
                           + rng.integers(0, 86_400, n)).astype(np.int64)
        * 1_000_000,
        "customer_id": rng.integers(0, 50, n).astype(np.int64),
        "terminal_id": rng.integers(0, 80, n).astype(np.int64),
        "tx_amount_cents": rng.integers(100, 30_000, n).astype(np.int64),
    }


def _write_table(module, directory: str):
    """Two merges and flushes through ``module``'s writer: inserts, then
    updates of some of the same rows (a later version) and new rows."""
    table = module.RawTransactionsTable(directory)
    first = _raw_cols(300, 1)
    table.merge(first, ts=first["tx_datetime_us"] // 1000)
    table.flush()
    upd = {k: v[:40].copy() for k, v in first.items()}
    upd["tx_amount_cents"] = upd["tx_amount_cents"] + 7
    more = _raw_cols(120, 2, first_id=300)
    both = {k: np.concatenate([upd[k], more[k]]) for k in upd}
    table.merge(both, ts=both["tx_datetime_us"] // 1000 + 1)
    table.flush()
    return table


def _drain(src):
    out = []
    while (cols := src.poll_batch()) is not None:
        out.append((cols, list(src.offsets)))
    return out


def _same_stream(a, b):
    assert len(a) == len(b)
    for (ca, oa), (cb, ob) in zip(a, b):
        assert oa == ob
        assert sorted(ca) == sorted(cb)
        for k in ca:
            assert ca[k].dtype == cb[k].dtype, k
            assert np.array_equal(ca[k], cb[k]), k


def _parts(directory: str):
    return sorted(os.path.relpath(os.path.join(r, f), directory)
                  for r, _, fs in os.walk(directory) for f in fs)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("window", [(None, None), ("2025-04-03", None),
                                    (None, "2025-04-04"),
                                    ("2025-04-02", "2025-04-04")],
                         ids=["all", "from", "to", "from-to"])
def test_raw_table_source_reads_either_packages_table(tmp_path, writer,
                                                      window):
    """A table written by one package is served identically by both
    packages' ``RawTableSource``: the same batches, offsets and watermark,
    under every day window."""
    d = str(tmp_path / "raw")
    _write_table(jtables if writer == "jax" else ttables, d)
    other = str(tmp_path / "other")
    _write_table(ttables if writer == "jax" else jtables, other)
    assert _parts(d) == _parts(other)  # the same partitions and parts
    lo, hi = window
    srcs = [m.RawTableSource(d, batch_rows=64, from_day=lo, to_day=hi)
            for m in (jsources, tsources)]
    assert srcs[0].n == srcs[1].n > 0
    assert srcs[0].offsets == srcs[1].offsets
    _same_stream(_drain(srcs[0]), _drain(srcs[1]))
    jr = jtables.RawTransactionsTable(d).read_all()
    tr = ttables.RawTransactionsTable(d).read_all()
    for k in jr:
        assert np.array_equal(jr[k], tr[k]), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_raw_table_source_watermark_guards_the_resume(tmp_path, writer):
    """Offsets resume across constructions while the table only grows
    beyond the watermark; late rows at or below it make ``seek`` raise in
    both packages."""
    d = str(tmp_path / "raw")
    table = _write_table(jtables if writer == "jax" else ttables, d)
    srcs = [m.RawTableSource(d, batch_rows=100) for m in (jsources,
                                                           tsources)]
    for s in srcs:
        s.poll_batch()
        s.poll_batch()
    ck = srcs[1].offsets
    assert ck == srcs[0].offsets and ck[0] == 200
    # appended beyond the watermark: resumes, the new rows served last
    late_day = int(ck[2]) // US_PER_DAY + 1
    beyond = _raw_cols(10, 3, first_id=10_000, day0=late_day)
    table.merge(beyond, ts=beyond["tx_datetime_us"] // 1000)
    table.flush()
    got = []
    for m in (jsources, tsources):
        s = m.RawTableSource(d, batch_rows=100)
        s.seek(ck)
        got.append(_drain(s))
        assert np.array_equal(np.sort(got[-1][-1][0]["tx_id"][-10:]),
                              beyond["tx_id"])
    _same_stream(*got)
    # late data at or below the watermark
    late = _raw_cols(5, 4, first_id=20_000, day0=20180)
    table.merge(late, ts=late["tx_datetime_us"] // 1000)
    table.flush()
    for m in (jsources, tsources):
        s = m.RawTableSource(d, batch_rows=100)
        with pytest.raises(ValueError, match="watermark"):
            s.seek(ck)


def test_raw_table_source_refusals_match_jax(tmp_path):
    """An empty directory and a bad day filter raise the JAX package's
    errors."""
    for m in (jsources, tsources):
        with pytest.raises(FileNotFoundError, match="tx_date"):
            m.RawTableSource(str(tmp_path / "none"))
    d = str(tmp_path / "raw")
    _write_table(ttables, d)
    for m in (jsources, tsources):
        with pytest.raises(ValueError, match="bad day filter"):
            m.RawTableSource(d, from_day="04/01/2025")


def test_upsert_table_matches_jax_merge_for_merge():
    """``UpsertTable``: inserts, updates, stale replays, deletes of known
    and unknown keys and re-inserts give the JAX table's counts and rows
    after every merge."""
    tables = [jtables.UpsertTable(jtables.TableSchema(
        "t", "tx_id", (("tx_id", "int64"), ("v", "int64")))),
        ttables.UpsertTable(schema.TableSchema(
            "t", "tx_id", (("tx_id", "int64"), ("v", "int64"))))]
    steps = [
        ({"tx_id": [1, 2, 3, 2], "v": [10, 20, 30, 21]}, [5, 5, 5, 6], None),
        ({"tx_id": [2, 4], "v": [22, 40]}, [4, 7], None),  # 2 is stale
        ({"tx_id": [1, 9], "v": [0, 0]}, [8, 8], [2, 2]),  # deletes
        ({"tx_id": [9, 1], "v": [90, 11]}, [7, 9], None),  # tomb, re-ins
        ({"tx_id": [5, 6, 5], "v": [50, 60, 51]}, None, None),  # seq ts
    ]
    for cols, ts, op in steps:
        cols = {k: np.asarray(v, np.int64) for k, v in cols.items()}
        kw = {}
        if ts is not None:
            kw["ts"] = np.asarray(ts, np.int64)
        if op is not None:
            kw["op"] = np.asarray(op, np.int8)
        got = [t.merge(dict(cols), **kw) for t in tables]
        assert got[0] == got[1]
        a, b = (t.to_columns() for t in tables)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        assert len(tables[0]) == len(tables[1])
        assert np.array_equal(tables[0].last_merged_slots,
                              tables[1].last_merged_slots)


def test_schemas_match_jax():
    from real_time_fraud_detection_system_tpu.core import schema as jschema

    for name in ("CUSTOMERS", "TERMINALS", "TRANSACTIONS"):
        a, b = getattr(jschema, name), getattr(schema, name)
        assert (a.name, a.key, a.fields) == (b.name, b.key, b.fields)
        assert a.dtype == b.dtype
    assert (jschema.ANALYZED_TRANSACTIONS_FIELDS
            == schema.ANALYZED_TRANSACTIONS_FIELDS)


def test_raw_table_sink_lands_the_engine_rows_as_jax(tmp_path):
    """The sink protocol (``append(BatchResult)``) writes the same table:
    event-time versions, so a replayed batch is a no-op in both."""
    rng = np.random.default_rng(5)
    n = 200
    res = BatchResult(
        tx_id=np.arange(n, dtype=np.int64),
        tx_datetime_us=(20180 * 86_400 + rng.integers(0, 3 * 86_400, n))
        .astype(np.int64) * 1_000_000,
        customer_id=rng.integers(0, 9, n).astype(np.int64),
        terminal_id=rng.integers(0, 9, n).astype(np.int64),
        amount_cents=rng.integers(1, 999, n).astype(np.int64),
        features=np.zeros((n, 15), np.float32),
        probs=np.zeros(n, np.float32), latency_s=0.0, batch_index=1)
    out = []
    for m, sub in ((jtables, "j"), (ttables, "t")):
        t = m.RawTransactionsTable(str(tmp_path / sub))
        t.append(res)
        t.append(res)  # the replay: no-op
        t.flush()
        assert len(t) == n
        out.append(t.read_all())
    for k in out[0]:
        assert np.array_equal(out[0][k], out[1][k]), k
    assert _parts(str(tmp_path / "j")) == _parts(str(tmp_path / "t"))


# -- KafkaSource through a fake confluent_kafka ----------------------------


def _build_fake_module():
    """A copy of ``tests/test_kafka_source.py``'s fake client."""
    mod = types.ModuleType("confluent_kafka")

    class TopicPartition:
        def __init__(self, topic, partition, offset=OFFSET_INVALID):
            self.topic = topic
            self.partition = partition
            self.offset = offset

    class KafkaError:
        _PARTITION_EOF = -191

        def __init__(self, code, retriable=False):
            self._code = code
            self._retriable = retriable

        def code(self):
            return self._code

        def retriable(self):
            return self._retriable

    class KafkaException(Exception):
        pass

    class _Msg:
        def __init__(self, topic, partition, offset, key, value, ts_ms,
                     err=None):
            self._topic = topic
            self._partition = partition
            self._offset = offset
            self._key = key
            self._value = value
            self._ts_ms = ts_ms
            self._err = err

        def error(self):
            return self._err

        def value(self):
            return self._value

        def key(self):
            return self._key

        def partition(self):
            return self._partition

        def offset(self):
            return self._offset

        def timestamp(self):
            return (1, self._ts_ms)

    class Consumer:
        def __init__(self, conf):
            self.conf = conf
            self.topic = None
            self.logs = {}
            self.positions = {}
            self.assigned = []
            self.committed = []
            self._on_assign = None
            self._on_revoke = None
            self._pending_rebalance = False
            self._fetch_started = False
            self.closed = False

        def inject(self, topic, logs):
            self.topic = topic
            self.logs = logs

        def force_rebalance(self):
            tps = [TopicPartition(self.topic, p) for p in list(self.assigned)]
            if self._on_revoke:
                self._on_revoke(self, tps)
            self.assigned = []
            self.positions = {}
            self._pending_rebalance = True

        def subscribe(self, topics, on_assign=None, on_revoke=None):
            self.topic = topics[0]
            self._on_assign = on_assign
            self._on_revoke = on_revoke
            self._pending_rebalance = True

        def assign(self, tps):
            self.assigned = sorted(tp.partition for tp in tps)
            for tp in tps:
                if tp.offset is not None and tp.offset >= 0:
                    self.positions[tp.partition] = tp.offset
                else:
                    self.positions.setdefault(tp.partition, 0)

        def seek(self, tp):
            if not self._fetch_started or tp.partition not in self.assigned:
                raise KafkaException("Local: Erroneous state")
            self.positions[tp.partition] = tp.offset

        def poll(self, timeout=None):
            self._fetch_started = True
            if self._pending_rebalance:
                self._pending_rebalance = False
                tps = [TopicPartition(self.topic, p)
                       for p in sorted(self.logs)]
                if self._on_assign is not None:
                    self._on_assign(self, tps)
                else:
                    self.assign(tps)
            for p in list(self.assigned):
                pos = self.positions.get(p, 0)
                log = self.logs.get(p, [])
                if pos < len(log):
                    self.positions[p] = pos + 1
                    return log[pos]
            return None

        def commit(self, offsets=None, asynchronous=True):
            self.committed.append(
                [(tp.partition, tp.offset) for tp in (offsets or [])])

        def close(self):
            self.closed = True

    mod.TopicPartition = TopicPartition
    mod.KafkaError = KafkaError
    mod.KafkaException = KafkaException
    mod.Consumer = Consumer
    mod._Msg = _Msg
    return mod


@pytest.fixture()
def fake_kafka(monkeypatch):
    mod = _build_fake_module()
    monkeypatch.setitem(sys.modules, "confluent_kafka", mod)
    return mod


def _make_logs(mod, n_rows=100, n_partitions=2, seed=0):
    rng = np.random.default_rng(seed)
    tx_id = np.arange(n_rows, dtype=np.int64)
    t_us = (20200 * 86400 + rng.integers(0, 86400, n_rows)).astype(
        np.int64) * 1_000_000
    customer = rng.integers(0, 50, n_rows).astype(np.int64)
    terminal = rng.integers(0, 80, n_rows).astype(np.int64)
    cents = rng.integers(100, 30000, n_rows).astype(np.int64)
    msgs = encode_transaction_envelopes(tx_id, t_us, customer, terminal,
                                        cents)
    logs = {p: [] for p in range(n_partitions)}
    for i, m in enumerate(msgs):
        p = int(customer[i]) % n_partitions
        logs[p].append(mod._Msg(TOPIC, p, len(logs[p]),
                                str(int(customer[i])).encode(), m,
                                int(t_us[i] // 1000)))
    return logs


def _both_sources(fake, logs, **kw):
    """The JAX and the port KafkaSource over their own fake consumers of
    the same logs."""
    out = []
    for m in (jsources, tsources):
        holder = {}

        def factory(conf, holder=holder):
            c = fake.Consumer(conf)
            c.inject(TOPIC, logs)
            holder["c"] = c
            return c

        kw2 = dict(kw)
        kw2.setdefault("idle_timeout_s", 0.05)
        kw2.setdefault("poll_timeout_s", 0.05)
        src = m.KafkaSource("broker:9092", consumer_factory=factory, **kw2)
        out.append((src, holder["c"]))
    return out


def _kafka_drain(src):
    out = []
    while (cols := src.poll_batch()) is not None:
        out.append((cols, list(src.offsets)))
    return out


def _scenario(name, fake, src, consumer, logs):
    """One of the JAX tests' scenarios on ``src``: what it returns must
    be equal across the packages."""
    if name == "drain":
        got = _kafka_drain(src)
        src.commit()
        return got, consumer.committed, consumer.conf
    if name == "seek_resume":
        first = src.poll_batch()
        ck = list(src.offsets)
        src.seek(ck)
        return [(first, ck)] + _kafka_drain(src), consumer.committed, None
    if name == "rebalance":
        first = src.poll_batch()
        consumer.force_rebalance()
        return [(first, list(src.offsets))] + _kafka_drain(src), None, None
    if name == "manual":
        return _kafka_drain(src), None, None
    if name == "manual_seek_first":
        src.seek([3, 5])
        return _kafka_drain(src), None, None
    if name == "commit_override":
        src.poll_batch()
        src.commit(offsets=[2, -1])
        return None, consumer.committed, None
    raise AssertionError(name)


@pytest.mark.parametrize("name,kw", [
    ("drain", {"batch_rows": 32}),
    ("seek_resume", {"batch_rows": 16}),
    ("rebalance", {"batch_rows": 16}),
    ("manual", {"partitions": [1], "n_partitions": 2}),
    ("manual_seek_first", {"partitions": [0, 1], "n_partitions": 2}),
    ("commit_override", {"batch_rows": 8}),
])
def test_kafka_source_matches_jax(fake_kafka, name, kw):
    """The same logs through each package's KafkaSource: the same
    columns, offsets after every poll, commits and consumer config."""
    logs = _make_logs(fake_kafka, n_rows=90)
    (js, jc), (ts, tc) = _both_sources(fake_kafka, logs, **kw)
    jgot = _scenario(name, fake_kafka, js, jc, logs)
    tgot = _scenario(name, fake_kafka, ts, tc, logs)
    if jgot[0] is not None:
        _same_stream(jgot[0], tgot[0])
    assert jgot[1] == tgot[1] and jgot[2] == tgot[2]
    ts.close()
    assert tc.closed


def test_kafka_tombstone_eof_and_errors_match_jax(fake_kafka):
    """Tombstones are skipped past, the end-of-partition marker skipped, a
    retriable error raises ``ConnectionError`` and a fatal one the
    client's ``KafkaException``, as in the JAX source."""
    logs = _make_logs(fake_kafka, n_rows=10, n_partitions=1)
    logs[0].append(fake_kafka._Msg(TOPIC, 0, len(logs[0]), b"5", None, 1))
    logs[0].append(fake_kafka._Msg(
        TOPIC, 0, len(logs[0]), None, None, 0,
        err=fake_kafka.KafkaError(fake_kafka.KafkaError._PARTITION_EOF)))
    (js, _), (ts, _) = _both_sources(fake_kafka, logs, batch_rows=64)
    _same_stream(_kafka_drain(js), _kafka_drain(ts))
    assert ts.offsets == js.offsets and ts.offsets[0] >= 11
    for retriable, exc in ((True, ConnectionError),
                           (False, fake_kafka.KafkaException)):
        logs = _make_logs(fake_kafka, n_rows=2, n_partitions=1)
        logs[0].append(fake_kafka._Msg(
            TOPIC, 0, len(logs[0]), None, None, 0,
            err=fake_kafka.KafkaError(-195, retriable=retriable)))
        for src, _ in _both_sources(fake_kafka, logs, batch_rows=1):
            src.poll_batch()
            src.poll_batch()
            with pytest.raises(exc):
                src.poll_batch()


def test_kafka_source_without_the_client_names_it(monkeypatch):
    """Without ``confluent_kafka`` the source and its factory raise
    ``ModuleNotFoundError`` naming it — no silent fallback."""
    monkeypatch.setitem(sys.modules, "confluent_kafka", None)
    with pytest.raises(ModuleNotFoundError, match="confluent_kafka") as e:
        tsources.make_kafka_source("broker:9092")
    assert e.value.name == "confluent_kafka"
    with pytest.raises(ModuleNotFoundError, match="confluent_kafka"):
        tsources.KafkaSource("broker:9092")


def test_kafka_source_publishes_no_lag_gauge(fake_kafka):
    """Like the JAX source, a Kafka poll counts rows but never creates
    the lag gauge (a broker round trip per poll)."""
    logs = _make_logs(fake_kafka, n_rows=20)
    (_, _), (ts, _) = _both_sources(fake_kafka, logs, batch_rows=64)
    assert ts._m_lag is None
    before = ts._m_ingested.value
    _kafka_drain(ts)
    assert ts._m_ingested.value == before + 20 and ts._m_lag is None


# -- the series of sources and sinks -----------------------------------------


def _series(reg, names, **labels):
    out = {}
    for name in names:
        m = reg.get(name, **labels)
        if m is None:
            out[name] = None
        elif hasattr(m, "count"):
            out[name] = m.count
        else:
            out[name] = m.value
    return out


SOURCE_SERIES = ("rtfds_source_poll_seconds", "rtfds_source_rows_total",
                 "rtfds_source_seeks_total")


@pytest.mark.parametrize("mode", ["columnar", "envelope"])
def test_source_series_match_jax_on_one_stream(small_dataset, mode):
    """One stream through each package's ReplaySource: the same number of
    polls, rows and seeks (as deltas of each package's process-wide
    registry) and the same lag after every poll."""
    jtxs = small_dataset[3].slice(slice(0, 1500))
    srcs = [jsources.ReplaySource(jtxs, EPOCH0, batch_rows=256, mode=mode),
            tsources.ReplaySource(_port_txs(jtxs), EPOCH0, batch_rows=256,
                                  mode=mode)]
    regs = [jmetrics.get_registry(), tmetrics.get_registry()]
    before = [_series(r, SOURCE_SERIES, source="replay") for r in regs]
    lags = [[], []]
    for i, (src, reg) in enumerate(zip(srcs, regs)):
        while src.poll_batch() is not None:
            lags[i].append(reg.get("rtfds_source_lag_rows").value)
        lags[i].append(reg.get("rtfds_source_lag_rows").value)
        src.seek([0] * len(src.offsets))
    after = [_series(r, SOURCE_SERIES, source="replay") for r in regs]
    deltas = [{k: a[k] - (b[k] or 0) for k in a}
              for a, b in zip(after, before)]
    assert deltas[0] == deltas[1]
    assert deltas[1]["rtfds_source_rows_total"] == 1500
    assert deltas[1]["rtfds_source_seeks_total"] == 1
    assert lags[0] == lags[1] and lags[1][-1] == 0


def _results(n_batches: int, rows: int = 64):
    rng = np.random.default_rng(9)
    out = []
    for i in range(n_batches):
        out.append(dict(
            tx_id=np.arange(i * rows, (i + 1) * rows, dtype=np.int64),
            tx_datetime_us=np.full(rows, EPOCH0 * 1_000_000, np.int64),
            customer_id=rng.integers(0, 9, rows).astype(np.int64),
            terminal_id=rng.integers(0, 9, rows).astype(np.int64),
            amount_cents=rng.integers(1, 999, rows).astype(np.int64),
            features=rng.random((rows, 15)).astype(np.float32),
            probs=rng.random(rows).astype(np.float32), latency_s=0.0,
            batch_index=i + 1))
    return out


SINK_SERIES = ("rtfds_sink_write_seconds", "rtfds_sink_rows_total",
               "rtfds_sink_failures_total")


def test_parquet_sink_series_match_jax(tmp_path):
    """Both packages' ParquetSink over the same results: the same writes,
    rows and failures (deltas), the same parts, and bytes counted for
    every part."""
    from real_time_fraud_detection_system_tpu.runtime.engine import (
        BatchResult as JBatchResult,
    )

    regs = [jmetrics.get_registry(), tmetrics.get_registry()]
    before = [_series(r, SINK_SERIES + ("rtfds_sink_bytes_total",),
                      sink="parquet") for r in regs]
    res = _results(3)
    sinks = [jsink.ParquetSink(str(tmp_path / "j")),
             tsink.ParquetSink(str(tmp_path / "t"))]
    for s, cls in zip(sinks, (JBatchResult, BatchResult)):
        for r in res:
            s.append(cls(**r))
    after = [_series(r, SINK_SERIES + ("rtfds_sink_bytes_total",),
                     sink="parquet") for r in regs]
    deltas = [{k: a[k] - (b[k] or 0) for k in a}
              for a, b in zip(after, before)]
    for k in SINK_SERIES:
        assert deltas[0][k] == deltas[1][k], k
    assert deltas[1]["rtfds_sink_rows_total"] == 3 * 64
    assert deltas[1]["rtfds_sink_bytes_total"] == sum(
        os.path.getsize(tmp_path / "t" / f)
        for f in os.listdir(tmp_path / "t"))
    assert sorted(os.listdir(tmp_path / "j")) == sorted(
        os.listdir(tmp_path / "t"))


def test_async_sink_series_match_jax():
    """``AsyncSink``'s queue series, on an injected registry: the same
    families and labels as the JAX sink's, the depth back at 0 after a
    drain, and a blocked enqueue counted."""
    import threading

    gate = threading.Event()

    class _Gated:
        def __init__(self):
            self.n = 0

        def append(self, res):
            gate.wait(5.0)
            self.n += 1

    regs = [jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()]
    res = _results(4, rows=4)
    from real_time_fraud_detection_system_tpu.runtime.engine import (
        BatchResult as JBatchResult,
    )

    for reg, m, cls in zip(regs, (jsink, tsink), (JBatchResult,
                                                   BatchResult)):
        gate.clear()
        inner = _Gated()
        s = m.AsyncSink(inner, max_queue=1, registry=reg)
        timer = threading.Timer(0.2, gate.set)
        timer.start()
        for r in res:
            s.append(cls(**r))
        s.drain()
        s.close()
        timer.join(5.0)
        assert inner.n == 4
    snaps = [r.snapshot() for r in regs]
    assert sorted(snaps[0]) == sorted(snaps[1])
    for name in snaps[0]:
        assert ([row["labels"] for row in snaps[0][name]["series"]]
                == [row["labels"] for row in snaps[1][name]["series"]])
    for reg in regs:
        assert reg.get("rtfds_sink_queue_depth", sink="_Gated").value == 0
        assert reg.get("rtfds_sink_backpressure_seconds_total",
                       sink="_Gated").value > 0.05


def test_memory_sink_reports_its_writes():
    """The port's MemorySink publishes the sink series under
    ``sink="memory"`` (the JAX MemorySink publishes none)."""
    reg = tmetrics.get_registry()
    before = _series(reg, ("rtfds_sink_rows_total",
                           "rtfds_sink_write_seconds"), sink="memory")
    s = tsink.MemorySink()
    for r in _results(2):
        s.append(BatchResult(**r))
    after = _series(reg, ("rtfds_sink_rows_total",
                          "rtfds_sink_write_seconds"), sink="memory")
    assert after["rtfds_sink_rows_total"] - (
        before["rtfds_sink_rows_total"] or 0) == 128
    assert after["rtfds_sink_write_seconds"] - (
        before["rtfds_sink_write_seconds"] or 0) == 2
