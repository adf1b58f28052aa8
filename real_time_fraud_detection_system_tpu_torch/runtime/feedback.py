"""Labeled-feedback topic → risk windows and online SGD — port of the JAX
package's ``runtime/feedback.py``.

Fraud labels arrive days after the transaction (chargebacks,
investigations) on their own stream. The loop closes here:

1. the :class:`~.engine.ScoringEngine` caches each scored row's feature
   vector in a bounded :class:`FeatureCache` (tx_id → float32[15]), with
   the row's terminal and day;
2. label events ``{tx_id, label, ts_ms}`` arrive on a ``payment.feedback``
   topic (:func:`encode_feedback_envelopes` /
   :func:`decode_feedback_envelopes`, byte for byte the JAX package's);
3. :class:`FeedbackLoop` polls the topic between micro-batches, joins the
   labels to the cached rows, lands them in the terminal risk windows
   (:meth:`~.engine.ScoringEngine.apply_state_feedback`), takes one
   backtracking SGD step for kinds with a gradient path
   (:meth:`~.engine.ScoringEngine.apply_feedback`), and hands the rows to
   the streaming learner's tap.

Replays are safe: the cache marks each transaction whose label reached the
state (``mark_labeled``; in-band labels are marked at insert), so the
additive fraud scatter runs at most once per cached transaction, and a
poll's duplicates are dropped latest-wins by event time first.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from real_time_fraud_detection_system_tpu_torch.features.spec import N_FEATURES
from real_time_fraud_detection_system_tpu_torch.ops.dedup import (
    latest_wins_mask_np,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    raise_for_kafka_error,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    get_registry,
)

FEEDBACK_TOPIC = "payment.feedback"


def encode_feedback_envelopes(
    tx_ids: Sequence[int],
    labels: Sequence[int],
    ts_ms: int = 0,
) -> List[bytes]:
    """Label events as minimal JSON envelopes (the feedback stream is
    produced by the application, not CDC: no Debezium wrapper)."""
    return [
        json.dumps(
            {"tx_id": int(t), "label": int(y), "ts_ms": int(ts_ms)},
            separators=(",", ":"),
        ).encode()
        for t, y in zip(tx_ids, labels)
    ]


def decode_feedback_envelopes(
    messages: Iterable[bytes],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (tx_ids int64 [n], labels int32 [n], ts_ms int64 [n]); malformed
    events are dropped. A missing or bad ``ts_ms`` reads as 0 (only tx_id
    and label are required)."""
    ids: List[int] = []
    ys: List[int] = []
    ts: List[int] = []
    for m in messages:
        try:
            d = json.loads(m)
            # both required fields parse before either is appended, so a
            # bad label cannot misalign the lists
            t, y = int(d["tx_id"]), int(d["label"])
        except (ValueError, KeyError, TypeError):
            continue
        try:
            s = int(d.get("ts_ms", 0))
        except (ValueError, TypeError):
            s = 0
        ids.append(t)
        ys.append(y)
        ts.append(s)
    return (np.asarray(ids, dtype=np.int64),
            np.asarray(ys, dtype=np.int32),
            np.asarray(ts, dtype=np.int64))


class FeatureCache:
    """Bounded tx_id → feature-row cache, direct-mapped (slot = tx_id mod
    capacity), vectorized on the host.

    The engine inserts every row it scores; the feedback join looks rows
    up when their labels arrive. A colliding insert evicts the previous
    occupant: with sequential tx_ids that is a sliding window of the most
    recent ``capacity`` transactions, and labels for evicted rows miss.
    """

    def __init__(self, capacity: int = 1_000_000,
                 n_features: int = N_FEATURES):
        self.capacity = int(capacity)
        self._feat = np.zeros((self.capacity, n_features), dtype=np.float32)
        self._ids = np.full(self.capacity, -1, dtype=np.int64)
        reg = get_registry()
        reg.gauge("rtfds_feature_cache_capacity",
                  "feature cache slot capacity").set(self.capacity)
        self._g_occupancy = reg.gauge(
            "rtfds_feature_cache_occupancy",
            "feature cache slots currently holding a scored row")
        self._m_evictions = reg.counter(
            "rtfds_feature_cache_evictions_total",
            "cached rows overwritten by a colliding insert before their "
            "label arrived (labels for evicted rows are dropped)")
        self._m_lookups = {
            o: reg.counter(
                "rtfds_feature_cache_lookups_total",
                "feedback label → cache joins by outcome (a rising miss "
                "share means labels arrive after eviction: raise "
                "capacity)", outcome=o)
            for o in ("hit", "miss")
        }
        self._occupancy = 0
        # the original transaction's terminal and day, for the state
        # feedback (features/online.py::apply_feedback)
        self._terminal = np.zeros(self.capacity, dtype=np.int64)
        self._day = np.zeros(self.capacity, dtype=np.int32)
        # True once the label reached the risk state (in-band at scoring
        # or by a feedback event): the additive scatter's idempotence guard
        self._labeled = np.zeros(self.capacity, dtype=bool)

    def __len__(self) -> int:
        return int((self._ids >= 0).sum())

    def put_batch(
        self,
        tx_ids: np.ndarray,
        features: np.ndarray,
        terminal_ids: np.ndarray = None,
        days: np.ndarray = None,
        labeled: np.ndarray = None,
    ) -> None:
        """Insert scored rows; ``labeled`` marks rows whose label came
        in-band (already in the risk state). The terminal and day columns
        are always written, so an evicting insert never leaves the
        previous occupant's bound to the new tx_id."""
        tx_ids = np.asarray(tx_ids, dtype=np.int64)
        n = len(tx_ids)
        slots = tx_ids % self.capacity
        if n:
            # occupancy and evictions against the state before the insert,
            # per distinct slot (the assignment below is last-wins)
            uslots, first_rev = np.unique(slots[::-1], return_index=True)
            new_ids = tx_ids[n - 1 - first_rev]
            prev = self._ids[uslots]
            self._occupancy += int((prev < 0).sum())
            self._g_occupancy.set(self._occupancy)
            evicted = int(((prev >= 0) & (prev != new_ids)).sum())
            if evicted:
                self._m_evictions.inc(evicted)
        self._ids[slots] = tx_ids
        self._feat[slots] = features
        self._terminal[slots] = (
            np.zeros(n, np.int64) if terminal_ids is None else terminal_ids
        )
        self._day[slots] = np.zeros(n, np.int32) if days is None else days
        self._labeled[slots] = (
            np.zeros(n, bool) if labeled is None else labeled
        )

    def mark_labeled(self, tx_ids: np.ndarray) -> None:
        """Record that these transactions' labels reached the risk state."""
        tx_ids = np.asarray(tx_ids, dtype=np.int64)
        slots = tx_ids % self.capacity
        own = (self._ids[slots] == tx_ids) & (tx_ids >= 0)
        self._labeled[slots[own]] = True

    def get_batch(self, tx_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """→ (features [m, F], hit_mask [n]) for the cached subset."""
        feats, _, _, hit, _ = self.get_batch_full(tx_ids)
        return feats, hit

    def get_batch_full(
        self, tx_ids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """→ (features [m, F], terminal_ids [m], days [m], hit_mask [n],
        already_labeled [m])."""
        tx_ids = np.asarray(tx_ids, dtype=np.int64)
        slots = tx_ids % self.capacity
        # a negative tx_id would alias the empty-slot sentinel: a miss
        hit = (self._ids[slots] == tx_ids) & (tx_ids >= 0)
        n_hit = int(hit.sum())
        if n_hit:
            self._m_lookups["hit"].inc(n_hit)
        if len(tx_ids) - n_hit:
            self._m_lookups["miss"].inc(len(tx_ids) - n_hit)
        sel = slots[hit]
        return (self._feat[sel], self._terminal[sel], self._day[sel], hit,
                self._labeled[sel])


class KafkaFeedbackSource:
    """The production feedback topic (``confluent_kafka``, imported at
    construction: without it this raises ``ModuleNotFoundError`` naming
    it, as the JAX source does).

    ``poll_messages(max_events)`` over a consumer-group subscription,
    auto-commit off: :class:`FeedbackLoop` calls :meth:`commit` only after
    a drained batch was applied, so a crash in between replays the labels
    (at least once; the loop's idempotence absorbs the replays).
    """

    def __init__(self, bootstrap_servers: str, topic: str = FEEDBACK_TOPIC,
                 group_id: str = "rtfds-feedback",
                 poll_timeout_s: float = 0.2, config: dict = None,
                 consumer_factory=None):
        import confluent_kafka as ck

        self._ck = ck
        self.topic = topic
        conf = {
            "bootstrap.servers": bootstrap_servers,
            "group.id": group_id,
            "enable.auto.commit": False,
            "auto.offset.reset": "earliest",
            **(config or {}),
        }
        factory = consumer_factory or ck.Consumer
        self._consumer = factory(conf)
        self._consumer.subscribe([topic])
        self.poll_timeout_s = poll_timeout_s

    def poll_messages(self, max_events: int) -> List[bytes]:
        out: List[bytes] = []
        while len(out) < max_events:
            msg = self._consumer.poll(self.poll_timeout_s if not out else 0.0)
            if msg is None:
                break
            err = msg.error()
            if err is not None:
                raise_for_kafka_error(self._ck, err)  # EOF → skip
                continue
            if msg.value() is not None:
                out.append(msg.value())
        return out

    def commit(self) -> None:
        """Commit consumed positions (called by the loop AFTER apply)."""
        self._consumer.commit(asynchronous=False)

    def close(self) -> None:
        self._consumer.close()


class FeedbackLoop:
    """Polls the feedback topic and applies the labels to the engine.

    One per engine; :meth:`poll_and_apply` runs on the loop thread between
    micro-batches (``ScoringEngine.run(feedback=)`` calls it once per
    finished batch). Its state scatters and SGD steps are enqueued on the
    engine's stream behind every step launched so far.

    ``broker`` is an :class:`~.sources.InProcBroker` or any object with
    ``poll_messages(max_events) → list[bytes]`` (:class:`KafkaFeedbackSource`).
    ``cache`` defaults to the engine's ``feature_cache``.
    """

    def __init__(self, engine, broker, cache: FeatureCache = None,
                 topic: str = FEEDBACK_TOPIC, max_events: int = 65536,
                 auto_commit: bool = True):
        self.engine = engine
        self.broker = broker
        self.cache = cache if cache is not None else engine.feature_cache
        if self.cache is None:
            raise ValueError(
                "FeedbackLoop needs a FeatureCache: pass one here or "
                "construct the engine with feature_cache="
            )
        self.topic = topic
        self.max_events = max_events
        # False: commits wait for an outside caller (the serving loop with
        # a checkpointer), so committed feedback offsets trail the state
        # checkpoint
        self.auto_commit = auto_commit
        self._offsets = (
            [0] * broker.n_partitions
            if hasattr(broker, "n_partitions") else []
        )
        # events == duplicates + missed + cache hits; applied ⊆ hits
        self.stats = {"events": 0, "applied": 0, "missed": 0,
                      "duplicates": 0}
        reg = get_registry()
        self._m_stats = {
            k: reg.counter("rtfds_feedback_events_total",
                           "feedback label events by disjoint outcome",
                           outcome=k)
            for k in ("applied", "skipped", "missed", "duplicates")
        }

    def _drain(self) -> List[bytes]:
        poll_messages = getattr(self.broker, "poll_messages", None)
        if poll_messages is not None:
            return poll_messages(self.max_events)
        msgs: List[bytes] = []
        for p in range(self.broker.n_partitions):
            recs = self.broker.poll(self.topic, p, self._offsets[p],
                                    self.max_events)
            self._offsets[p] += len(recs)
            msgs += [r.value for r in recs]
        return msgs

    def poll_and_apply(self) -> int:
        """Drain the available label events; returns the rows applied."""
        msgs = self._drain()
        if not msgs:
            return 0
        applied = self._apply(msgs)
        # at-least-once transports commit only after the apply
        if self.auto_commit:
            self.commit()
        return applied

    def commit(self) -> None:
        """Commit consumed feedback offsets (transports that have them)."""
        commit = getattr(self.broker, "commit", None)
        if commit is not None:
            commit()

    def close(self) -> None:
        """Close the transport session (if it has one)."""
        close = getattr(self.broker, "close", None)
        if close is not None:
            close()

    def _apply(self, msgs: List[bytes]) -> int:
        tx_ids, labels, ts_ms = decode_feedback_envelopes(msgs)
        self.stats["events"] += len(tx_ids)
        if len(tx_ids):
            # within-poll dedup, latest-wins by event time (drain position
            # breaks ties): mark_labeled guards only across polls
            keep = latest_wins_mask_np(tx_ids, ts_ms)
            dup = int(len(tx_ids) - keep.sum())
            self.stats["duplicates"] += dup
            self._m_stats["duplicates"].inc(dup)
            tx_ids, labels = tx_ids[keep], labels[keep]
        shadow = getattr(self.engine, "shadow", None)
        if shadow is not None and len(tx_ids):
            # the labels join both models' cached decisions: the live
            # precision/recall windows (each entry consumed once)
            shadow.observe_labels(tx_ids, labels)
        feats, term_ids, days, hit, done = self.cache.get_batch_full(tx_ids)
        n_hit = int(hit.sum())
        self.stats["missed"] += len(tx_ids) - n_hit
        self._m_stats["missed"].inc(len(tx_ids) - n_hit)
        if n_hit == 0:
            return 0
        # rows whose label already reached the state are skipped
        fresh = (labels[hit] >= 0) & ~done
        self._m_stats["skipped"].inc(n_hit - int(fresh.sum()))
        if not fresh.any():
            return 0
        y = labels[hit][fresh]
        # 1) the labels into the terminal risk windows (every kind)
        self.engine.apply_state_feedback(term_ids[fresh], days[fresh], y)
        # 2) one backtracking SGD step (kinds with a gradient path)
        if self.engine.supports_online_sgd:
            self.engine.apply_feedback(feats[fresh], y)
        # 3) the streaming learner's tap: the same rows, one bounded
        #    enqueue
        tap = getattr(self.engine, "feedback_tap", None)
        if tap is not None:
            tap(feats[fresh], y)
        self.cache.mark_labeled(tx_ids[hit][fresh])
        n_labeled = int(len(y))
        self.stats["applied"] += n_labeled
        self._m_stats["applied"].inc(n_labeled)
        return n_labeled
