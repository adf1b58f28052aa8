"""Stream sources — port of the JAX package's ``runtime/sources.py``.

- :class:`InProcBroker` — a Kafka-semantics in-process log: topics ×
  partitions, append-only, offset-addressed, key-hash partition
  assignment.
- :class:`ReplaySource` — replays a generated
  :class:`~..data.generator.Transactions` table as raw columnar slices
  (the zero-parse path), or through the broker as Debezium envelopes
  (``mode="envelope"``, exercising the decode as a Kafka deployment
  would).
- :class:`SyntheticSource` — a paced live generator over a table.
- :class:`RawTableSource` — streams the persistent raw-transactions table
  (``io/tables.py``) back through the engine: backfill, re-scoring after a
  retrain.
- :class:`KafkaSource` — the production ingress, the Debezium transaction
  topic (``confluent_kafka``, imported when one is built).

Every source publishes the JAX package's per-source series
(:class:`_SourceTelemetry`): ``rtfds_source_poll_seconds``,
``rtfds_source_rows_total`` (the overload ladder's ``scored + deferred ==
polled`` ledger reads it), ``rtfds_source_seeks_total`` and, where the
source knows its backlog, ``rtfds_source_lag_rows`` (``/healthz`` and the
ladder's ``lag`` component read it). ``runtime/prefetch.py`` polls any of
them ahead of the loop on a thread of its own.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from real_time_fraud_detection_system_tpu_torch.core.envelope import (
    decode_transaction_envelopes_fast,
    encode_transaction_envelopes,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    get_registry,
)
from real_time_fraud_detection_system_tpu_torch.utils.trace import get_tracer

TOPIC = "debezium.payment.transactions"


class _SourceTelemetry:
    """The per-source series of the JAX package, resolved once at
    construction: the poll histogram, rows ingested, seeks, and — for
    sources that know their backlog — the lag gauge."""

    def _init_source_metrics(self, source_kind: str) -> None:
        reg = get_registry()
        self._tracer = get_tracer()
        self._source_kind = source_kind
        self._m_poll = reg.histogram(
            "rtfds_source_poll_seconds", "source poll_batch wall time",
            source=source_kind)
        self._m_ingested = reg.counter(
            "rtfds_source_rows_total", "rows ingested", source=source_kind)
        self._m_seeks = reg.counter(
            "rtfds_source_seeks_total",
            "checkpoint-resume / replay seeks", source=source_kind)
        # Registered at the first set: a source that cannot compute a
        # backlog (Kafka) must not leave a permanent 0 that /healthz would
        # read as healthy. Unlabeled: /healthz and the overload ladder
        # read it without knowing which source serves.
        self._m_lag = None

    def _observe_poll(self, t0: float, cols: Optional[dict],
                      lag: Optional[int] = None) -> None:
        t1 = time.perf_counter()
        self._m_poll.observe(t1 - t0)
        n = 0
        if cols is not None:
            n = len(next(iter(cols.values()), ()))
            if n:
                self._m_ingested.inc(n)
        if self._tracer.enabled:
            # timeline only (batch=""): under prefetch or pipelining this
            # poll may serve a later batch than the current one; the
            # engine's source_poll span carries the attribution
            self._tracer.add_span(f"source/{self._source_kind}", t0, t1,
                                  batch="", rows=n)
        if lag is not None:
            if self._m_lag is None:
                self._m_lag = get_registry().gauge(
                    "rtfds_source_lag_rows",
                    "known backlog: rows available but not yet served")
            self._m_lag.set(lag)


@dataclass
class _Record:
    offset: int
    ts_ms: int
    key: bytes
    value: bytes


class InProcBroker:
    """Partitioned append-only log with Kafka offset semantics."""

    def __init__(self, n_partitions: int = 8):
        self.n_partitions = n_partitions
        self._topics: Dict[str, List[List[_Record]]] = {}
        self._lock = threading.Lock()

    def _topic(self, name: str) -> List[List[_Record]]:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = [[] for _ in range(self.n_partitions)]
            return self._topics[name]

    def partition_of(self, key: bytes) -> int:
        # FNV-1a over the key bytes — stable across runs and processes.
        h = 2166136261
        for byte in key:
            h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
        return h % self.n_partitions

    def produce(self, topic: str, key: bytes, value: bytes, ts_ms: int = 0,
                partition: Optional[int] = None) -> Tuple[int, int]:
        part = self.partition_of(key) if partition is None else partition
        log = self._topic(topic)[part]
        with self._lock:
            off = len(log)
            log.append(_Record(off, ts_ms, key, value))
        return part, off

    def produce_many(self, topic: str, keys: Sequence[bytes],
                     values: Sequence[bytes],
                     ts_ms: Optional[Sequence[int]] = None) -> None:
        for i, (k, v) in enumerate(zip(keys, values)):
            self.produce(topic, k, v, ts_ms[i] if ts_ms is not None else 0)

    def poll(self, topic: str, partition: int, offset: int,
             max_records: int) -> List[_Record]:
        log = self._topic(topic)[partition]
        with self._lock:
            return log[offset:offset + max_records]

    def end_offsets(self, topic: str) -> List[int]:
        t = self._topic(topic)
        with self._lock:
            return [len(p) for p in t]


class ReplaySource(_SourceTelemetry):
    """Serves micro-batches from a transactions table as numpy column
    dicts.

    ``mode="columnar"`` slices the table in order, ``batch_rows`` rows per
    poll. ``mode="envelope"`` encodes the whole table to Debezium
    envelopes up front (Python, ~10 µs a row), produces them to an
    :class:`InProcBroker` keyed by customer, and polls the partitions
    round robin, ``batch_rows // n_partitions`` records from each, through
    the envelope decoder (``decode_workers`` threads, 0 = auto). With
    ``with_labels`` each columnar batch carries the table's fraud labels
    (an envelope carries none). The lag gauge is the table's rows not
    yet served (columnar) or the broker's unpolled records (envelope).
    """

    def __init__(
        self,
        txs: Transactions,
        start_epoch_s: int,
        batch_rows: int = 4096,
        mode: str = "columnar",
        n_partitions: int = 8,
        with_labels: bool = False,
        decode_workers: int = 0,
    ):
        if mode not in ("columnar", "envelope"):
            raise ValueError(f"mode must be 'columnar' or 'envelope', got "
                             f"{mode!r}")
        self.txs = txs
        self.start_epoch_s = start_epoch_s
        self.batch_rows = batch_rows
        self.mode = mode
        self.with_labels = with_labels
        self.n_partitions = n_partitions
        self.decode_workers = decode_workers
        self._pos = 0
        self._init_source_metrics("replay")
        if mode == "envelope":
            self.broker = InProcBroker(n_partitions)
            t_us = txs.epoch_us(start_epoch_s)
            msgs = encode_transaction_envelopes(
                txs.tx_id, t_us, txs.customer_id, txs.terminal_id,
                txs.amount_cents)
            keys = [str(int(c)).encode() for c in txs.customer_id]
            self.broker.produce_many(TOPIC, keys, msgs,
                                     ts_ms=(t_us // 1000).tolist())
            self._offsets = [0] * n_partitions

    def poll_batch(self) -> Optional[dict]:
        """Next micro-batch as a column dict (None when exhausted)."""
        t0 = time.perf_counter()
        cols = self._poll_inner()
        if self.mode == "columnar":
            lag = self.txs.n - self._pos
        else:
            lag = sum(self.broker.end_offsets(TOPIC)) - sum(self._offsets)
        self._observe_poll(t0, cols, lag=lag)
        return cols

    def _poll_inner(self) -> Optional[dict]:
        if self.mode == "columnar":
            if self._pos >= self.txs.n:
                return None
            s, e = self._pos, min(self._pos + self.batch_rows, self.txs.n)
            self._pos = e
            part = self.txs.slice(slice(s, e))
            us = part.epoch_us(self.start_epoch_s)
            cols = {
                "tx_id": part.tx_id,
                "tx_datetime_us": us,
                "customer_id": part.customer_id,
                "terminal_id": part.terminal_id,
                "tx_amount_cents": part.amount_cents,
                "kafka_ts_ms": us // 1000,
            }
            if self.with_labels:
                cols["label"] = part.tx_fraud.astype(np.int32)
            return cols

        per = max(1, self.batch_rows // self.n_partitions)
        msgs: List[bytes] = []
        ts: List[int] = []
        for p in range(self.n_partitions):
            recs = self.broker.poll(TOPIC, p, self._offsets[p], per)
            self._offsets[p] += len(recs)
            msgs += [r.value for r in recs]
            ts += [r.ts_ms for r in recs]
        if not msgs:
            return None
        cols, invalid = decode_transaction_envelopes_fast(
            msgs, ts, self.decode_workers)
        if invalid.any():
            keep = ~invalid
            cols = {k: v[keep] for k, v in cols.items()}
        return cols

    @property
    def offsets(self) -> List[int]:
        if self.mode == "columnar":
            return [self._pos]
        return list(self._offsets)

    def seek(self, offsets: Sequence[int]) -> None:
        """Restore the consumption position (checkpoint resume)."""
        self._m_seeks.inc()
        if self.mode == "columnar":
            self._pos = int(offsets[0])
        else:
            self._offsets = list(offsets)


class SyntheticSource(_SourceTelemetry):
    """Paced live generator — the ``datagen`` container analogue: batches
    at ``rate_tps`` transactions per second of wall clock (as fast as
    possible when 0), drawn from a pre-generated table. Its series are
    ``source="synthetic"`` (the poll time includes the pacing sleep); the
    inner replay cursor is read through ``_poll_inner``, so no row counts
    under ``source="replay"`` too."""

    def __init__(self, txs: Transactions, start_epoch_s: int,
                 rate_tps: float = 0.0, batch_rows: int = 4096):
        self._replay = ReplaySource(txs, start_epoch_s, batch_rows,
                                    "columnar")
        self.rate_tps = rate_tps
        self._init_source_metrics("synthetic")

    def poll_batch(self) -> Optional[dict]:
        t0 = time.perf_counter()
        cols = self._replay._poll_inner()
        if cols is not None and self.rate_tps > 0:
            time.sleep(len(cols["tx_id"]) / self.rate_tps)
        self._observe_poll(t0, cols,
                           lag=self._replay.txs.n - self._replay._pos)
        return cols

    @property
    def offsets(self) -> List[int]:
        return self._replay.offsets

    def seek(self, offsets: Sequence[int]) -> None:
        self._m_seeks.inc()
        self._replay._pos = int(offsets[0])


class RawTableSource(_SourceTelemetry):
    """Streams the persistent raw-transactions table
    (``io/tables.py::RawTransactionsTable``, ``tx_date=*/part-*.parquet``)
    back through the engine: backfill, re-scoring after a retrain.

    The table is read once at construction (latest-wins across parts),
    sorted into time order (``tx_datetime_us``, then ``tx_id``), cut to
    ``[from_day, to_day]`` (inclusive ``YYYY-MM-DD``) when given, and
    served ``batch_rows`` at a time. Rows written after construction are
    not seen.

    A resume across constructions is watermark-guarded: ``offsets`` is
    ``[pos, n_snapshot, max_ts, max_tx_id]``, and ``seek`` checks that the
    first ``n_snapshot`` sorted rows are still exactly the rows at or
    below that watermark. Rows appended beyond it sort after the snapshot
    and are served once the stream reaches them; late rows at or below it
    raise ``ValueError``, since resuming by position would skip or
    re-serve rows.
    """

    def __init__(self, directory: str, batch_rows: int = 4096,
                 from_day: Optional[str] = None,
                 to_day: Optional[str] = None):
        from real_time_fraud_detection_system_tpu_torch.io.tables import (
            RawTransactionsTable,
        )

        cols = RawTransactionsTable(directory).read_all()
        if not cols:
            raise FileNotFoundError(
                f"no raw-transactions partitions under {directory!r} "
                "(expected tx_date=*/part-*.parquet)")
        if from_day or to_day:
            from real_time_fraud_detection_system_tpu_torch.core.batch \
                import US_PER_DAY
            from real_time_fraud_detection_system_tpu_torch.utils.timing \
                import date_to_epoch_s

            def _day_num(s: str) -> int:
                try:
                    return date_to_epoch_s(s) // 86400
                except ValueError as e:
                    raise ValueError(
                        f"bad day filter {s!r} (want YYYY-MM-DD): {e}"
                    ) from None

            days = cols["tx_datetime_us"] // US_PER_DAY
            keep = np.ones(len(days), dtype=bool)
            if from_day:
                keep &= days >= _day_num(from_day)
            if to_day:
                keep &= days <= _day_num(to_day)
            cols = {k: v[keep] for k, v in cols.items()}
        order = np.lexsort((cols["tx_id"], cols["tx_datetime_us"]))
        self._cols = {k: np.ascontiguousarray(v[order])
                      for k, v in cols.items()}
        self.batch_rows = batch_rows
        self._pos = 0
        n = len(self._cols["tx_id"])
        if n:
            self._snapshot = (n, int(self._cols["tx_datetime_us"][-1]),
                              int(self._cols["tx_id"][-1]))
        else:
            self._snapshot = (0, -1, -1)
        self._init_source_metrics("raw_table")

    @property
    def n(self) -> int:
        return len(self._cols["tx_id"])

    def poll_batch(self) -> Optional[dict]:
        t0 = time.perf_counter()
        if self._pos >= self.n:
            self._observe_poll(t0, None, lag=0)
            return None
        s, e = self._pos, min(self._pos + self.batch_rows, self.n)
        self._pos = e
        out = {k: v[s:e] for k, v in self._cols.items()}
        # replayed history: the event time is the transport time too
        out["kafka_ts_ms"] = out["tx_datetime_us"] // 1000
        self._observe_poll(t0, out, lag=self.n - self._pos)
        return out

    @property
    def offsets(self) -> List[int]:
        n_snap, wts, wtx = self._snapshot
        return [self._pos, n_snap, wts, wtx]

    def seek(self, offsets: Sequence[int]) -> None:
        if len(offsets) >= 4:
            _, n_snap, wts, wtx = (int(x) for x in offsets[:4])
            ts = self._cols["tx_datetime_us"]
            tid = self._cols["tx_id"]
            in_snap = (ts < wts) | ((ts == wts) & (tid <= wtx))
            got = int(in_snap.sum())
            if got != n_snap or not bool(in_snap[:got].all()):
                raise ValueError(
                    "RawTableSource resume: the table changed at or below "
                    f"the checkpoint watermark (ts={wts}, tx_id={wtx}): "
                    f"expected {n_snap} snapshot rows, found {got}. Late "
                    "or rewritten data shifts sort positions, so resuming "
                    "by offset would skip or re-serve rows — re-run the "
                    "backfill from scratch (or bound it with "
                    "from_day/to_day).")
        self._m_seeks.inc()
        self._pos = int(offsets[0])


def raise_for_kafka_error(ck, err) -> bool:
    """The poll-error policy of every Kafka consumer here: True for the
    end-of-partition marker (the caller skips it); ``ConnectionError`` for
    a retriable transport or broker error (the supervisor's default
    ``recover_on`` restarts through it); ``KafkaException`` for a fatal
    one (auth, config)."""
    if getattr(err, "code", lambda: None)() == getattr(
            ck.KafkaError, "_PARTITION_EOF", -191):
        return True
    if getattr(err, "retriable", lambda: False)():
        raise ConnectionError(f"kafka transient error: {err}")
    raise ck.KafkaException(err)


class KafkaSource(_SourceTelemetry):
    """A Kafka consumer of the Debezium transaction topic → column dicts:
    up to ``batch_rows`` messages per poll, decoded in one pass
    (``decode_transaction_envelopes_fast``).

    ``confluent_kafka`` is imported when the source is built; without it
    the constructor raises ``ModuleNotFoundError`` naming it.

    Offsets, as the checkpointer records them: ``offsets`` is a dense
    per-partition list of the next offsets to consume (-1: never consumed
    here, left to ``auto.offset.reset``); ``seek`` re-assigns them;
    ``commit`` commits them to the broker. Auto-commit is off, so the
    broker's committed offsets trail the checkpoint and a crash can only
    replay rows, never skip them.

    ``partitions=None`` subscribes as a consumer group (on assignment,
    partitions with checkpointed offsets are positioned there); an
    explicit list ``assign``s those partitions. ``consumer_factory``
    defaults to ``confluent_kafka.Consumer``. Publishes no lag gauge: a
    high-watermark query per poll is a broker round trip on the hot path.
    """

    TOPIC_DEFAULT = TOPIC

    def __init__(self, bootstrap_servers: str, topic: str = TOPIC_DEFAULT,
                 group_id: str = "rtfds-scorer", batch_rows: int = 4096,
                 poll_timeout_s: float = 1.0,
                 idle_timeout_s: Optional[float] = None,
                 partitions: Optional[Sequence[int]] = None,
                 n_partitions: Optional[int] = None,
                 config: Optional[dict] = None, consumer_factory=None,
                 decode_workers: int = 0):
        import confluent_kafka as ck

        self._ck = ck
        self.topic = topic
        self.batch_rows = batch_rows
        self.poll_timeout_s = poll_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self.decode_workers = decode_workers
        conf = {
            "bootstrap.servers": bootstrap_servers,
            "group.id": group_id,
            "enable.auto.commit": False,
            "auto.offset.reset": "earliest",
            **(config or {}),
        }
        factory = consumer_factory or ck.Consumer
        self._consumer = factory(conf)
        self._init_source_metrics("kafka")
        self._next: Dict[int, int] = {}  # partition -> next offset
        self._n_partitions = n_partitions
        self._manual = partitions is not None
        if self._manual:
            self._assigned = sorted(int(p) for p in partitions)
            self._consumer.assign(
                [ck.TopicPartition(topic, p) for p in self._assigned])
        else:
            self._assigned = []
            self._consumer.subscribe([topic], on_assign=self._on_assign,
                                     on_revoke=self._on_revoke)

    def _on_assign(self, consumer, tps) -> None:
        for tp in tps:
            p = tp.partition
            if p not in self._assigned:
                self._assigned.append(p)
            if p in self._next:
                # resume from the checkpointed position, not the group's
                tp.offset = self._next[p]
        self._assigned.sort()
        consumer.assign(tps)

    def _on_revoke(self, consumer, tps) -> None:
        for tp in tps:
            if tp.partition in self._assigned:
                self._assigned.remove(tp.partition)
        # _next stays: a partition that comes back resumes where it was

    def poll_batch(self) -> Optional[dict]:
        """Up to ``batch_rows`` messages, decoded. Returns what arrived
        within ``poll_timeout_s`` (a partial batch keeps latency bounded);
        None — the end of the stream — only when ``idle_timeout_s`` is set
        and nothing arrived within it; otherwise an empty poll is a
        zero-row batch (the engine waits a trigger and polls again)."""
        t0 = time.perf_counter()
        cols = self._poll_inner()
        self._observe_poll(t0, cols)
        return cols

    def _poll_inner(self) -> Optional[dict]:
        msgs: List[bytes] = []
        ts_ms: List[int] = []
        deadline = time.monotonic() + self.poll_timeout_s
        idle_deadline = (time.monotonic() + self.idle_timeout_s
                         if self.idle_timeout_s is not None else None)
        while len(msgs) < self.batch_rows:
            now = time.monotonic()
            if msgs and now >= deadline:
                break
            if not msgs and idle_deadline is not None \
                    and now >= idle_deadline:
                return None
            msg = self._consumer.poll(
                min(self.poll_timeout_s, 0.1) if msgs
                else self.poll_timeout_s)
            if msg is None:
                if msgs or idle_deadline is None:
                    break
                continue
            err = msg.error()
            if err is not None:
                if getattr(err, "code", lambda: None)() == getattr(
                        self._ck.KafkaError, "_PARTITION_EOF", -191):
                    continue  # the end-of-partition marker
                if msgs:
                    # never drop buffered rows (their offsets are tracked
                    # already): return them; a lasting error comes back
                    # on the next poll with an empty buffer
                    break
                raise_for_kafka_error(self._ck, err)
            self._next[msg.partition()] = msg.offset() + 1
            if msg.value() is None:
                continue  # a tombstone (CDC delete): nothing to score
            msgs.append(msg.value())
            t = msg.timestamp()
            ts_ms.append(int(t[1]) if t and t[1] and t[1] > 0 else 0)
        if not msgs:
            if idle_deadline is not None:
                return None
            # a zero-row batch with the decoder's column contract
            return decode_transaction_envelopes_fast([], [])[0]
        cols, invalid = decode_transaction_envelopes_fast(
            msgs, ts_ms, self.decode_workers)
        if invalid.any():
            keep = ~invalid
            cols = {k: v[keep] for k, v in cols.items()}
        return cols

    @property
    def offsets(self) -> List[int]:
        """Dense next-offset list, as long as the highest partition seen
        + 1 (or ``n_partitions``); -1 = never consumed."""
        n = self._n_partitions
        if n is None:
            seen = list(self._next) + list(self._assigned)
            n = (max(seen) + 1) if seen else 0
        out = [-1] * n
        for p, off in self._next.items():
            if p < n:
                out[p] = off
        return out

    def seek(self, offsets: Sequence[int]) -> None:
        """Restore the positions (checkpoint resume). Manual assignment
        re-``assign``s with explicit offsets (librdkafka seeks only a
        partition whose fetcher has started); a subscription records them
        for the rebalance callback and seeks the partitions it holds."""
        self._m_seeks.inc()
        ck = self._ck
        for p, off in enumerate(offsets):
            if int(off) >= 0:
                self._next[p] = int(off)
        if self._manual:
            parts = sorted(set(self._assigned) | set(self._next))
            self._consumer.assign([
                ck.TopicPartition(self.topic, p, self._next.get(p, -1001))
                for p in parts])
            self._assigned = parts
            return
        for p in list(self._assigned):
            if p in self._next:
                self._consumer.seek(
                    ck.TopicPartition(self.topic, p, self._next[p]))

    def commit(self, offsets: Optional[Sequence[int]] = None) -> None:
        """Commit next offsets to the broker (after a checkpoint).
        ``offsets`` (the dense layout of :attr:`offsets`, -1 = skip)
        overrides the tracked positions: the prefetcher passes its
        consumed offsets, so a commit never records its read-ahead."""
        ck = self._ck
        if offsets is not None:
            pairs = [(p, int(off)) for p, off in enumerate(offsets)
                     if int(off) >= 0]
        else:
            pairs = sorted(self._next.items())
        tps = [ck.TopicPartition(self.topic, p, off) for p, off in pairs]
        if tps:
            self._consumer.commit(offsets=tps, asynchronous=False)

    def close(self) -> None:
        self._consumer.close()


def make_kafka_source(bootstrap_servers: str, **kwargs) -> KafkaSource:
    """The production Kafka ingress; raises ``ModuleNotFoundError`` naming
    ``confluent_kafka`` where it is not installed."""
    try:
        import confluent_kafka  # noqa: F401
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "confluent_kafka is not installed: KafkaSource needs it "
            "(use ReplaySource or RawTableSource without a broker)",
            name="confluent_kafka") from e
    return KafkaSource(bootstrap_servers, **kwargs)
