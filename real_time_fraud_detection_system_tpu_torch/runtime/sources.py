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

:class:`ReplaySource` counts the rows it serves in
``rtfds_source_rows_total{source="replay"}`` (the overload ladder's
``scored + deferred == polled`` ledger reads it); the rest of the
per-source telemetry (poll histograms, the lag gauge), ``RawTableSource``,
``KafkaSource`` and the prefetch wrapper are still to port (A2).
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

TOPIC = "debezium.payment.transactions"


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


class ReplaySource:
    """Serves micro-batches from a transactions table as numpy column
    dicts.

    ``mode="columnar"`` slices the table in order, ``batch_rows`` rows per
    poll. ``mode="envelope"`` encodes the whole table to Debezium
    envelopes up front (Python, ~10 µs a row), produces them to an
    :class:`InProcBroker` keyed by customer, and polls the partitions
    round robin, ``batch_rows // n_partitions`` records from each, through
    the envelope decoder (``decode_workers`` threads, 0 = auto). With
    ``with_labels`` each columnar batch carries the table's fraud labels
    (an envelope carries none).
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
        self._m_ingested = get_registry().counter(
            "rtfds_source_rows_total", "rows ingested", source="replay")
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
        cols = self._poll()
        if cols is not None:
            self._m_ingested.inc(len(cols["tx_id"]))
        return cols

    def _poll(self) -> Optional[dict]:
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
        if self.mode == "columnar":
            self._pos = int(offsets[0])
        else:
            self._offsets = list(offsets)


class SyntheticSource:
    """Paced live generator — the ``datagen`` container analogue: batches
    at ``rate_tps`` transactions per second of wall clock (as fast as
    possible when 0), drawn from a pre-generated table."""

    def __init__(self, txs: Transactions, start_epoch_s: int,
                 rate_tps: float = 0.0, batch_rows: int = 4096):
        self._replay = ReplaySource(txs, start_epoch_s, batch_rows,
                                    "columnar")
        self.rate_tps = rate_tps

    def poll_batch(self) -> Optional[dict]:
        cols = self._replay.poll_batch()
        if cols is not None and self.rate_tps > 0:
            time.sleep(len(cols["tx_id"]) / self.rate_tps)
        return cols

    @property
    def offsets(self) -> List[int]:
        return self._replay.offsets

    def seek(self, offsets: Sequence[int]) -> None:
        self._replay.seek(offsets)
