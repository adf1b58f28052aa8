"""Result sinks — port of the JAX package's ``io/sink.py``: the
``analyzed_transactions`` append path.

- :class:`ParquetSink` — one Parquet part file per micro-batch under a
  local directory (``pyarrow`` is imported when one is built, so the
  package imports without it); :class:`StoreParquetSink` — the same parts
  in an object store (``io/store.py``, S3/MinIO);
- :class:`IcebergSink` — appends to an Iceberg ``analyzed_transactions``
  table through a pyiceberg catalog (:func:`make_iceberg_sink`; the
  catalog is injectable);
- :class:`MemorySink` — keeps every batch's columns in memory;
- :class:`ConsoleSink` — the reference's ``.show()`` analogue;
- :class:`FanoutSink` — several sinks in order;
- :class:`AsyncSink` — appends on a background writer thread behind a
  bounded queue;
- :class:`DeadLetterSink` (JSONL) and :class:`ParquetDeadLetterSink` —
  the dead-letter queue that the fault supervisor's poison isolation
  writes, idempotent by ``tx_id``.

The analyzed-output sinks publish the JAX package's series
(:class:`_SinkTelemetry`: ``rtfds_sink_write_seconds``,
``rtfds_sink_rows_total``, ``rtfds_sink_bytes_total``,
``rtfds_sink_failures_total``, by ``sink``), and :class:`AsyncSink` its
queue's ``rtfds_sink_queue_depth`` and
``rtfds_sink_backpressure_seconds_total`` (the overload ladder's
``sink_fill`` reads the depth).
"""

from __future__ import annotations

import base64
import json
import os
import queue
import threading
import time
from typing import List, Optional

import numpy as np

from real_time_fraud_detection_system_tpu_torch.features.spec import (
    FEATURE_NAMES,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    active_recorder,
    get_registry,
)
from real_time_fraud_detection_system_tpu_torch.utils.trace import get_tracer


class _SinkTelemetry:
    """The per-sink series, by sink kind, resolved once per sink: write
    latency, rows, bytes, failed appends."""

    def _init_sink_metrics(self, sink_kind: str) -> None:
        reg = get_registry()
        self._tracer = get_tracer()
        self._sink_kind = sink_kind
        self._m_write = reg.histogram(
            "rtfds_sink_write_seconds", "sink append wall time",
            sink=sink_kind)
        self._m_rows = reg.counter(
            "rtfds_sink_rows_total", "rows written", sink=sink_kind)
        self._m_bytes = reg.counter(
            "rtfds_sink_bytes_total", "bytes written", sink=sink_kind)
        self._m_failures = reg.counter(
            "rtfds_sink_failures_total", "failed appends", sink=sink_kind)

    def _observe_write(self, t0: float, rows: int, nbytes: int,
                       timeline: bool = True) -> None:
        t1 = time.perf_counter()
        self._m_write.observe(t1 - t0)
        self._m_rows.inc(rows)
        if nbytes:
            self._m_bytes.inc(nbytes)
        if timeline and self._tracer.enabled:
            # timeline only (batch=""): on an async sink's writer, or
            # with batches in flight, the current batch is a later one;
            # the engine's sink_write span carries the attribution
            self._tracer.add_span(f"sink/{self._sink_kind}", t0, t1,
                                  batch="", rows=rows, bytes=nbytes)


def _result_to_columns(res) -> dict:
    """BatchResult → analyzed_transactions column dict."""
    now_us = int(time.time() * 1e6)
    n = len(res.tx_id)
    cols = {
        "tx_id": res.tx_id.astype(np.int64),
        "tx_datetime_us": res.tx_datetime_us.astype(np.int64),
        "customer_id": res.customer_id.astype(np.int64),
        "terminal_id": res.terminal_id.astype(np.int64),
        "tx_amount": res.amount_cents.astype(np.float64) / 100.0,
    }
    # feature columns, lower-cased like the reference table DDL
    for i, name in enumerate(FEATURE_NAMES):
        if name == "TX_AMOUNT":
            continue
        dt = np.int32 if ("NB_TX" in name or "DURING" in name) else np.float64
        cols[name.lower()] = res.features[:, i].astype(dt)
    cols["processed_at_us"] = np.full(n, now_us, dtype=np.int64)
    cols["prediction"] = res.probs.astype(np.float64)
    return cols


class FanoutSink:
    """Append to several sinks; ``flush`` and ``truncate_after`` reach
    those that have them."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def append(self, res) -> None:
        for s in self.sinks:
            s.append(res)

    def flush(self) -> None:
        for s in self.sinks:
            f = getattr(s, "flush", None)
            if f is not None:
                f()

    def truncate_after(self, batch_index: int) -> None:
        for s in self.sinks:
            f = getattr(s, "truncate_after", None)
            if f is not None:
                f(batch_index)


WRITER_STACK_BYTES = 64 << 20


class AsyncSink:
    """Offload ``append`` to a background writer thread: the serving
    loop's sink write becomes one enqueue on a bounded queue.

    - Ordered: one writer drains a FIFO, so the inner sink sees appends in
      the loop's order.
    - Bounded: at most ``max_queue`` results wait; a full queue blocks the
      loop thread, and the time it blocked is added to
      ``rtfds_sink_backpressure_seconds_total``; the queue's depth rides
      ``rtfds_sink_queue_depth``. Both are labeled with the inner sink's
      class and land in ``registry`` (default: the process-wide one).
    - Errors propagate: the writer's first failure is raised on the loop
      thread at the next ``append``, ``drain``, ``flush`` or ``close``, as
      its original exception; while it is pending the writer discards
      what is queued, and the raise clears it.
    - ``drain()`` blocks until every queued append has landed;
      ``flush``, ``truncate_after``, ``read_all`` and ``concat`` drain
      first, and the engine drains at the end of every run.
    """

    _STOP = object()

    def __init__(self, inner, max_queue: int = 8, registry=None):
        if inner is None:
            raise ValueError("AsyncSink needs an inner sink")
        self.inner = inner
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(max_queue)))
        self._error: Optional[BaseException] = None
        reg = registry if registry is not None else get_registry()
        kind = type(inner).__name__
        self._m_depth = reg.gauge(
            "rtfds_sink_queue_depth",
            "batch results queued for the async sink writer", sink=kind)
        self._m_backpressure = reg.counter(
            "rtfds_sink_backpressure_seconds_total",
            "loop-thread seconds blocked on a full async sink queue",
            sink=kind)
        # pyarrow's ParquetWriter, run on a thread with the default 8 MB
        # stack in a process that also runs torch and XLA, crashed at
        # random (SIGSEGV in its constructor; pyarrow 25.0, Linux; 16 MB
        # crashed too, 64 MB never did)
        default = threading.stack_size(WRITER_STACK_BYTES)
        try:
            self._thread = threading.Thread(target=self._writer, daemon=True,
                                            name="sink-writer")
            self._thread.start()
        finally:
            threading.stack_size(default)

    def _writer(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is self._STOP:
                    return
                if self._error is None:
                    try:
                        self.inner.append(item)
                    # the thread boundary: park the original exception
                    # for the loop thread, which re-raises it
                    except BaseException as e:  # noqa: BLE001
                        self._error = e
            finally:
                self._q.task_done()
                self._m_depth.set(self._q.qsize())

    def _raise_pending(self) -> None:
        err = self._error
        if err is not None:
            self._error = None
            raise err

    def append(self, res) -> None:
        self._raise_pending()
        t0 = time.perf_counter()
        self._q.put(res)  # blocks when full
        waited = time.perf_counter() - t0
        if waited > 1e-4:  # an uncontended put is ~µs; count only blocks
            self._m_backpressure.inc(waited)
        self._m_depth.set(self._q.qsize())

    def drain(self) -> None:
        """Block until every queued append has landed (or failed); raise
        a writer failure here."""
        self._q.join()
        self._raise_pending()

    def flush(self) -> None:
        self.drain()
        f = getattr(self.inner, "flush", None)
        if f is not None:
            f()

    def truncate_after(self, batch_index: int) -> None:
        self.drain()
        f = getattr(self.inner, "truncate_after", None)
        if f is not None:
            f(batch_index)

    def read_all(self) -> dict:
        self.drain()
        return self.inner.read_all()

    def concat(self) -> dict:
        self.drain()
        return self.inner.concat()

    def close(self) -> None:
        """Drain, stop the writer thread, and raise a pending error."""
        if self._thread.is_alive():
            self._q.join()
            self._q.put(self._STOP)
            self._thread.join(timeout=30.0)
        self._raise_pending()


class MemorySink(_SinkTelemetry):
    """Keeps every batch's analyzed columns in memory (its series under
    ``sink="memory"``; the bytes are the columns' ``nbytes``)."""

    def __init__(self):
        self.batches: List[dict] = []
        self._init_sink_metrics("memory")

    def append(self, res) -> None:
        t0 = time.perf_counter()
        # a child of the span open on this thread (the engine's
        # sink_write); on an async sink's writer, where none is open, a
        # timeline span (batch="", as _observe_write's): the current
        # batch is a later one. It stands for the sink's timeline span.
        batch = None if self._tracer.open_span() else ""
        with self._tracer.span("sink_write/convert", batch=batch):
            cols = _result_to_columns(res)
        self.batches.append(cols)
        self._observe_write(t0, len(res.tx_id),
                            sum(v.nbytes for v in cols.values()),
                            timeline=False)

    def concat(self) -> dict:
        if not self.batches:
            return {}
        keys = self.batches[0].keys()
        return {k: np.concatenate([b[k] for b in self.batches]) for k in keys}


class ConsoleSink:
    """Prints every ``every``-th batch: its size, mean and max
    probability, and its first ``limit`` rows."""

    def __init__(self, every: int = 1, limit: int = 5):
        self.every = every
        self.limit = limit
        self._n = 0

    def append(self, res) -> None:
        self._n += 1
        if self._n % self.every:
            return
        n = len(res.tx_id)
        print(f"[batch {self._n}] rows={n} p(fraud): "
              f"mean={res.probs.mean():.4f} max={res.probs.max():.4f}")
        for i in range(min(self.limit, n)):
            print(f"  tx {res.tx_id[i]} cust {res.customer_id[i]} "
                  f"amt {res.amount_cents[i] / 100:.2f} -> "
                  f"{res.probs[i]:.4f}")


def _part_order(name: str):
    """Indexed parts (``part-<batch_index>``) numerically first, then
    timestamp-named parts by name (their stems are zero-padded)."""
    base = name.rsplit("/", 1)[-1]
    stem = base[len("part-"):-len(".parquet")] \
        if base.startswith("part-") and base.endswith(".parquet") else ""
    if stem.isdigit():
        return (0, int(stem), "")
    return (1, 0, name)


def _part_name(res, seq: int) -> tuple:
    """The part name of ``res`` (``part-<batch_index>``, or a timestamp
    and ``seq`` when it has no index) and the next ``seq``."""
    idx = getattr(res, "batch_index", -1)
    if idx >= 0:
        return f"part-{idx:08d}.parquet", seq
    return f"part-{int(time.time() * 1e3)}-{seq:06d}.parquet", seq + 1


class ParquetSink(_SinkTelemetry):
    """One part file per batch: ``<dir>/part-<batch_index>.parquet``.

    A replayed batch carries the same ``batch_index`` and overwrites its
    own part instead of appending a duplicate. Writes go to a temporary
    name and are renamed into place, so a reader never sees a torn part.
    Results without an index fall back to timestamp naming.
    """

    def __init__(self, directory: str):
        # imported on the thread that builds the sink, not on an
        # AsyncSink's writer thread
        import pyarrow as pa
        import pyarrow.parquet as pq

        self._pa, self._pq = pa, pq
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._seq = 0
        self._init_sink_metrics("parquet")

    def append(self, res) -> None:
        pa, pq = self._pa, self._pq
        t0 = time.perf_counter()
        try:
            cols = _result_to_columns(res)
            table = pa.table({k: pa.array(v) for k, v in cols.items()})
            name, self._seq = _part_name(res, self._seq)
            path = os.path.join(self.directory, name)
            tmp = path + ".tmp"
            pq.write_table(table, tmp)
            nbytes = os.path.getsize(tmp)
            os.replace(tmp, path)
        except Exception:
            self._m_failures.inc()
            raise
        self._observe_write(t0, len(res.tx_id), nbytes)

    def truncate_after(self, batch_index: int) -> None:
        """Drop indexed parts beyond ``batch_index`` (the restore fence)."""
        for f in os.listdir(self.directory):
            if not (f.startswith("part-") and f.endswith(".parquet")):
                continue
            stem = f[len("part-"):-len(".parquet")]
            if stem.isdigit() and int(stem) > batch_index:
                os.remove(os.path.join(self.directory, f))

    def read_all(self) -> dict:
        pa, pq = self._pa, self._pq
        files = sorted((os.path.join(self.directory, f)
                        for f in os.listdir(self.directory)
                        if f.endswith(".parquet")), key=_part_order)
        if not files:
            return {}
        table = pa.concat_tables([pq.read_table(f) for f in files])
        return {c: table[c].to_numpy() for c in table.column_names}


class StoreParquetSink(_SinkTelemetry):
    """:class:`ParquetSink`'s part-per-batch layout in an object store
    (``io/store.py``): a replayed batch overwrites its own part, object
    PUTs are atomic (no temporary name), and ``truncate_after`` is the
    same restore fence."""

    def __init__(self, store):
        import pyarrow as pa
        import pyarrow.parquet as pq

        self._pa, self._pq = pa, pq
        self.store = store
        self._seq = 0
        self._init_sink_metrics("store_parquet")

    def append(self, res) -> None:
        pa, pq = self._pa, self._pq
        t0 = time.perf_counter()
        try:
            cols = _result_to_columns(res)
            table = pa.table({k: pa.array(v) for k, v in cols.items()})
            name, self._seq = _part_name(res, self._seq)
            buf = pa.BufferOutputStream()
            pq.write_table(table, buf)
            data = buf.getvalue().to_pybytes()
            self.store.put(name, data)
        except Exception:
            self._m_failures.inc()
            raise
        self._observe_write(t0, len(res.tx_id), len(data))

    def truncate_after(self, batch_index: int) -> None:
        for key in self.store.list(""):
            f = key.rsplit("/", 1)[-1]
            if not (f.startswith("part-") and f.endswith(".parquet")):
                continue
            stem = f[len("part-"):-len(".parquet")]
            if stem.isdigit() and int(stem) > batch_index:
                self.store.delete(key)

    def read_all(self) -> dict:
        import io as _io

        pa, pq = self._pa, self._pq
        keys = sorted((k for k in self.store.list("")
                       if k.endswith(".parquet")), key=_part_order)
        if not keys:
            return {}
        table = pa.concat_tables(
            [pq.read_table(_io.BytesIO(self.store.get(k))) for k in keys])
        return {c: table[c].to_numpy() for c in table.column_names}


def _dlq_row_record(cols: dict, i: int, *, reason: str, error: str,
                    batch_index: int, offsets, trace_id: str,
                    envelope: Optional[bytes]) -> dict:
    """One quarantined row as a JSON-able record: its decoded columns,
    the raw envelope where the caller still has it, and the error and
    lineage an operator needs to triage it."""
    def scalar(v):
        x = v[i]
        try:
            return x.item()
        except AttributeError:
            return x

    rec = {
        "tx_id": int(cols["tx_id"][i]),
        "reason": reason,
        "error": str(error)[:500],
        "batch_index": int(batch_index),
        "offsets": [int(o) for o in offsets] if offsets is not None
        else None,
        "trace_id": trace_id or "",
        "t": time.time(),
        "columns": {k: scalar(v) for k, v in cols.items()},
    }
    if envelope is not None:
        rec["envelope_b64"] = base64.b64encode(bytes(envelope)).decode()
    return rec


class _DeadLetterTelemetry:
    """Dead-letter counters (``rtfds_dead_letter_rows_total{reason}``),
    the row gauge (``rtfds_dead_letter_rows``) and flight-record events;
    ``registry`` and ``recorder_fn`` override where they land."""

    def _init_dlq_metrics(self, registry=None, recorder_fn=None) -> None:
        self._reg = registry if registry is not None else get_registry()
        self._recorder = (recorder_fn if recorder_fn is not None
                          else active_recorder)
        self._m_gauge = self._reg.gauge(
            "rtfds_dead_letter_rows",
            "rows currently quarantined in the dead-letter queue")

    def _observe_put(self, written: int, reason: str, batch_index: int,
                     total: int) -> None:
        if written:
            self._reg.counter(
                "rtfds_dead_letter_rows_total",
                "rows quarantined to the dead-letter queue by reason",
                reason=reason).inc(written)
        self._m_gauge.set(total)
        rec = self._recorder()
        if rec is not None and written:
            rec.record_event("dead_letter", rows=written, reason=reason,
                             batch=int(batch_index))


class DeadLetterSink(_DeadLetterTelemetry):
    """JSONL dead-letter queue, one record per quarantined row.

    Idempotent by ``tx_id``: a row already quarantined is skipped (the
    seen-set is rebuilt from the file on open), so a crash during a
    bisection and the replay after it neither lose nor duplicate rows;
    ``read_all`` also keeps the latest record per ``tx_id``.
    """

    def __init__(self, path: str, registry=None, recorder_fn=None):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._seen: set = set()
        self._init_dlq_metrics(registry, recorder_fn)
        if os.path.exists(path):
            for rec in self._iter_file():
                self._seen.add(int(rec["tx_id"]))
        self._f = open(path, "a", encoding="utf-8")
        self._m_gauge.set(len(self._seen))

    def _iter_file(self):
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn tail after a crash
                if "tx_id" in rec:
                    yield rec

    def put_rows(self, cols: dict, *, reason: str, error: str = "",
                 errors: Optional[List[str]] = None, batch_index: int = -1,
                 offsets=None, trace_id: str = "",
                 envelopes: Optional[List[bytes]] = None) -> int:
        """Quarantine every row of ``cols`` not quarantined yet;
        ``errors`` is a message per row (``error`` the shared one).
        Returns the rows written."""
        n = len(cols["tx_id"])
        written = 0
        with self._lock:
            for i in range(n):
                tx = int(cols["tx_id"][i])
                if tx in self._seen:
                    continue
                rec = _dlq_row_record(
                    cols, i, reason=reason,
                    error=errors[i] if errors is not None else error,
                    batch_index=batch_index, offsets=offsets,
                    trace_id=trace_id,
                    envelope=envelopes[i] if envelopes is not None
                    else None)
                self._f.write(json.dumps(rec, separators=(",", ":"),
                                         default=str) + "\n")
                self._seen.add(tx)
                written += 1
            self._f.flush()
        self._observe_put(written, reason, batch_index, len(self._seen))
        return written

    def read_all(self) -> List[dict]:
        """Quarantined rows, the latest record per ``tx_id``, ordered by
        (batch_index, tx_id)."""
        with self._lock:
            self._f.flush()
        by_tx = {}
        for rec in self._iter_file():
            by_tx[int(rec["tx_id"])] = rec
        return sorted(by_tx.values(),
                      key=lambda r: (r.get("batch_index", -1), r["tx_id"]))

    def tx_ids(self) -> List[int]:
        return sorted(self._seen)

    def __len__(self) -> int:
        return len(self._seen)

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class ParquetDeadLetterSink(_DeadLetterTelemetry):
    """:class:`DeadLetterSink` as Parquet parts under a directory, one
    per quarantine call (``dlq-<batch_index>-<reason>.parquet``): a
    replay that isolates the same batch again overwrites its own part.
    A later call for the same (batch, reason) merges with the part."""

    def __init__(self, directory: str, registry=None, recorder_fn=None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._seen: set = set()
        self._init_dlq_metrics(registry, recorder_fn)
        for rec in self.read_all():
            self._seen.add(int(rec["tx_id"]))
        self._m_gauge.set(len(self._seen))

    def put_rows(self, cols: dict, *, reason: str, error: str = "",
                 errors: Optional[List[str]] = None, batch_index: int = -1,
                 offsets=None, trace_id: str = "",
                 envelopes: Optional[List[bytes]] = None) -> int:
        import pyarrow as pa
        import pyarrow.parquet as pq

        n = len(cols["tx_id"])
        recs = []
        with self._lock:
            for i in range(n):
                tx = int(cols["tx_id"][i])
                if tx in self._seen:
                    continue
                recs.append(_dlq_row_record(
                    cols, i, reason=reason,
                    error=errors[i] if errors is not None else error,
                    batch_index=batch_index, offsets=offsets,
                    trace_id=trace_id,
                    envelope=envelopes[i] if envelopes is not None
                    else None))
            if recs:
                flat = [{
                    **{k: v for k, v in r.items()
                       if k not in ("columns", "offsets")},
                    "columns_json": json.dumps(r["columns"], default=str),
                    "offsets_json": json.dumps(r["offsets"]),
                } for r in recs]
                name = f"dlq-{max(int(batch_index), 0):08d}-{reason}.parquet"
                path = os.path.join(self.directory, name)
                if os.path.exists(path):
                    new_ids = {int(r["tx_id"]) for r in flat}
                    keys = list(flat[0])
                    flat = [{k: row.get(k) for k in keys}
                            for row in pq.read_table(path).to_pylist()
                            if int(row.get("tx_id", -1)) not in new_ids
                            ] + flat
                table = pa.table({
                    k: pa.array([r.get(k) for r in flat])
                    for k in flat[0]
                })
                tmp = path + ".tmp"
                pq.write_table(table, tmp)
                os.replace(tmp, path)
                for r in recs:
                    self._seen.add(int(r["tx_id"]))
        self._observe_put(len(recs), reason, batch_index, len(self._seen))
        return len(recs)

    def read_all(self) -> List[dict]:
        import pyarrow.parquet as pq

        by_tx = {}
        if not os.path.isdir(self.directory):
            return []
        for f in sorted(os.listdir(self.directory)):
            if not (f.startswith("dlq-") and f.endswith(".parquet")):
                continue
            table = pq.read_table(os.path.join(self.directory, f))
            for row in table.to_pylist():
                rec = dict(row)
                rec["columns"] = json.loads(rec.pop("columns_json", "{}"))
                off = rec.pop("offsets_json", "null")
                rec["offsets"] = json.loads(off) if off else None
                by_tx[int(rec["tx_id"])] = rec
        return sorted(by_tx.values(),
                      key=lambda r: (r.get("batch_index", -1), r["tx_id"]))

    def tx_ids(self) -> List[int]:
        return sorted(self._seen)

    def __len__(self) -> int:
        return len(self._seen)

    def close(self) -> None:
        pass


def make_dead_letter_sink(path: str, registry=None, recorder_fn=None):
    """``*.jsonl`` (or an existing plain file) → :class:`DeadLetterSink`;
    anything else → a :class:`ParquetDeadLetterSink` directory."""
    if path.endswith(".jsonl") or os.path.isfile(path):
        return DeadLetterSink(path, registry=registry,
                              recorder_fn=recorder_fn)
    return ParquetDeadLetterSink(path, registry=registry,
                                 recorder_fn=recorder_fn)


def read_dead_letter(path: str) -> List[dict]:
    """Read a dead-letter queue without creating it; raises
    ``FileNotFoundError`` when there is none."""
    if os.path.isfile(path):
        s = DeadLetterSink(path)
        try:
            return s.read_all()
        finally:
            s.close()
    if os.path.isdir(path):
        return ParquetDeadLetterSink(path).read_all()
    raise FileNotFoundError(f"no dead-letter queue at {path!r}")


def make_parquet_sink(path_or_url: str, **store_kwargs):
    """``s3://bucket/prefix`` → :class:`StoreParquetSink` (through
    :func:`~.store.make_store`, which honours ``RTFDS_S3_ENDPOINT``); a
    local directory → :class:`ParquetSink`."""
    if path_or_url.startswith("s3://"):
        from real_time_fraud_detection_system_tpu_torch.io.store import (
            make_store,
        )

        return StoreParquetSink(make_store(path_or_url, **store_kwargs))
    return ParquetSink(path_or_url)


class IcebergSink(_SinkTelemetry):
    """Append scored rows to an Iceberg ``analyzed_transactions`` table in
    the reference's column layout: timestamps as microsecond Arrow
    timestamps, amount and prediction as doubles, window counts as int32.

    ``catalog`` is duck-typed (``load_table``/``create_table``, optionally
    ``table_exists``), so tests run against a fake without pyiceberg;
    :func:`make_iceberg_sink` builds a real one."""

    TABLE_DEFAULT = "payment.analyzed_transactions"

    def __init__(self, catalog, table_name: str = TABLE_DEFAULT):
        self.catalog = catalog
        self.table_name = table_name
        self.table = self._load_or_create(catalog, table_name)
        self._init_sink_metrics("iceberg")

    @staticmethod
    def arrow_schema():
        import pyarrow as pa

        fields = [
            ("tx_id", pa.int64()),
            ("tx_datetime", pa.timestamp("us")),
            ("customer_id", pa.int64()),
            ("terminal_id", pa.int64()),
            ("tx_amount", pa.float64()),
        ]
        for name in FEATURE_NAMES:
            if name == "TX_AMOUNT":
                continue
            t = (pa.int32() if ("NB_TX" in name or "DURING" in name)
                 else pa.float64())
            fields.append((name.lower(), t))
        fields += [("processed_at", pa.timestamp("us")),
                   ("prediction", pa.float64())]
        return pa.schema(fields)

    def _load_or_create(self, catalog, name: str):
        exists = getattr(catalog, "table_exists", None)
        if exists is not None and not exists(name):
            return catalog.create_table(name, schema=self.arrow_schema())
        try:
            return catalog.load_table(name)
        except Exception as e:
            # only a missing table is created; a transient catalog error
            # (network, auth) surfaces
            if type(e).__name__ in ("NoSuchTableError", "KeyError"):
                return catalog.create_table(name, schema=self.arrow_schema())
            raise

    def _to_arrow(self, res):
        import pyarrow as pa

        cols = _result_to_columns(res)
        renamed = {"tx_datetime": "tx_datetime_us",
                   "processed_at": "processed_at_us"}
        return pa.table({
            field.name: pa.array(cols[renamed.get(field.name, field.name)])
            .cast(field.type)
            for field in self.arrow_schema()})

    def append(self, res) -> None:
        t0 = time.perf_counter()
        try:
            tbl = self._to_arrow(res)
            self.table.append(tbl)
        except Exception:
            self._m_failures.inc()
            raise
        self._observe_write(t0, len(res.tx_id), tbl.nbytes)


def make_iceberg_sink(table_name: str = IcebergSink.TABLE_DEFAULT,
                      catalog_name: str = "default",
                      catalog: Optional[object] = None,
                      **catalog_props) -> IcebergSink:
    """An :class:`IcebergSink` over ``catalog``, or over
    ``pyiceberg.catalog.load_catalog(catalog_name, **catalog_props)``
    (ImportError naming pyiceberg where it is missing)."""
    if catalog is None:
        try:
            from pyiceberg.catalog import load_catalog
        except ImportError as e:
            raise ImportError(
                "pyiceberg is not installed; ParquetSink output is Iceberg-"
                "compatible (add files to a table via any catalog), or "
                "install pyiceberg in production images."
            ) from e
        catalog = load_catalog(catalog_name, **catalog_props)
    return IcebergSink(catalog, table_name)
