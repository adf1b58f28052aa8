"""Background source prefetch — port of the JAX package's
``runtime/prefetch.py``, the input-side mirror of ``io/sink.py::AsyncSink``.

:class:`PrefetchSource` wraps any ``poll_batch``/``offsets``/``seek``
source: a producer thread polls (and so decodes) ahead of the serving loop
into a bounded queue, so the loop thread's ``source_poll`` becomes a
dequeue while the decode overlaps the loop's host prep, dispatch and sink.
The producer does host work only — the inner source's poll and decode.
Pinned staging, the host-to-device copy and every CUDA call stay on the
loop thread; a ``seek`` fences the host queue and never touches device
state (CUDA graphs included).

Contracts, in the order people get them wrong:

- **Offsets commit on consumption, not on poll.** ``offsets`` reports
  the position after the last batch *returned from* ``poll_batch`` —
  never the producer's read-ahead position. A checkpoint therefore
  replays prefetched-but-unconsumed batches after a crash instead of
  skipping them; ``commit()`` forwards the consumed offsets to inner
  sources that take them (Kafka), so broker offsets can't lead the
  framework checkpoint either.
- **Errors propagate with their original type.** A producer-side
  failure (a flaky poll, a dead broker) is re-raised on the consumer
  thread at the next ``poll_batch`` — the supervisor's type-based
  ``recover_on`` policy sees exactly what a synchronous poll would have
  thrown.
- **Poison isolation runs unprefetched.** ``set_sync(True)`` stops the
  producer, rewinds the inner source to the consumed position (the
  queued read-ahead is discarded and re-served synchronously), and
  serves polls inline — the supervisor flips this around
  ``_run_poison_isolation`` so diagnosis sees the same batch boundaries
  a replay will.
- **``seek`` fences the producer.** Checkpoint resume stops the current
  producer generation, drops its queue, seeks the inner source, and
  starts a fresh generation; a producer wedged inside a hung poll is
  abandoned with its (orphaned) queue and cannot pollute the new
  generation — the same zombie-fencing stance as
  ``runtime/faults.py``. Prefer a fresh source per incarnation
  (``make_source``) for full fencing, exactly as documented there.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Sequence

from real_time_fraud_detection_system_tpu_torch.utils.metrics import get_registry


class _End:
    """Queue sentinel: the inner source returned None (exhausted)."""


class _Err:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchSource:
    """Poll-and-decode ahead of the serving loop into a bounded queue.

    ``max_batches`` bounds host memory (a stalled loop backpressures the
    producer, never the reverse); queue occupancy rides
    ``rtfds_prefetch_queue_depth`` and consumer blocked-time rides
    ``rtfds_prefetch_wait_seconds_total`` — a prefetcher that can't keep
    the loop fed is visible, not silent.
    """

    def __init__(self, inner, max_batches: int = 4, registry=None):
        if inner is None:
            raise ValueError("PrefetchSource needs an inner source")
        self.inner = inner
        self.depth = max(1, int(max_batches))
        reg = registry if registry is not None else get_registry()
        self._m_depth = reg.gauge(
            "rtfds_prefetch_queue_depth",
            "micro-batches decoded ahead of the serving loop")
        self._m_wait = reg.counter(
            "rtfds_prefetch_wait_seconds_total",
            "loop-thread seconds blocked waiting on the prefetch queue")
        # Consumed position (what checkpoints record). Initialized from
        # the inner source so a zero-batch run checkpoints honestly.
        self._offsets: List[int] = list(inner.offsets)
        self._sync = False
        self._exhausted = False
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start_producer()

    # -- producer (its own generation of stop-event + queue) ------------

    def _start_producer(self) -> None:
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self.depth)
        self._thread = threading.Thread(
            target=self._produce, args=(self._stop, self._q),
            daemon=True, name="source-prefetch")
        self._thread.start()

    def _produce(self, stop: threading.Event, q: "queue.Queue") -> None:
        def put(item) -> bool:
            # bounded put that a generation fence can interrupt
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    self._m_depth.set(q.qsize())
                    return True
                except queue.Full:
                    continue
            return False

        try:
            while not stop.is_set():
                cols = self.inner.poll_batch()
                if stop.is_set():
                    return  # fenced mid-poll: the new generation re-seeks
                if cols is None:
                    put(_End())
                    return
                # Offsets snapshot BELONGS to this batch: consuming it
                # advances the consumed position to exactly here.
                if not put((cols, list(self.inner.offsets))):
                    return
        # the thread boundary: the original exception is re-raised, with
        # its type, on the loop thread at its next poll
        except BaseException as e:  # noqa: BLE001
            put(_Err(e))

    def _stop_producer(self) -> None:
        """Fence the current producer generation: signal stop, orphan its
        queue (a producer blocked in ``put`` exits via the timeout loop;
        one wedged inside a hung inner poll is abandoned — its late put
        lands in the orphaned queue nothing reads). An abandoned zombie
        still SHARES the inner source: when its hung poll eventually
        releases it consumes (and discards) one batch from the inner
        cursor — the same at-most-one-batch double-fault race
        ``runtime/faults.py`` documents for shared sources, with the
        same fix: give each incarnation a fresh source (``make_source``)
        so a zombie owns a dead private session. Warn-logged so a
        lineage gap after a stall is attributable."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            if t.is_alive():
                from real_time_fraud_detection_system_tpu_torch.utils \
                    .logging import get_logger

                get_logger("prefetch").warning(
                    "prefetch producer did not exit within 5s (inner "
                    "poll wedged); abandoning it. If the hang releases, "
                    "its in-flight poll consumes one batch from the "
                    "shared inner source — prefer a fresh source per "
                    "incarnation (make_source) to fence this entirely")
        self._thread = None

    # -- source protocol (loop thread) ----------------------------------

    def poll_batch(self) -> Optional[dict]:
        if self._sync:
            cols = self.inner.poll_batch()
            if cols is not None:
                self._offsets = list(self.inner.offsets)
            return cols
        if self._exhausted:
            return None
        t0 = time.perf_counter()
        q, thread = self._q, self._thread
        while True:
            try:
                item = q.get(timeout=0.5)
                break
            except queue.Empty:
                if thread is None or not thread.is_alive():
                    # producer died without a sentinel (should not
                    # happen; belt under the braces) — honest end
                    self._exhausted = True
                    return None
        waited = time.perf_counter() - t0
        if waited > 1e-4:  # an uncontended get is ~µs; count only blocks
            self._m_wait.inc(waited)
        self._m_depth.set(q.qsize())
        if isinstance(item, _Err):
            # Original-typed re-raise; recovery seeks (resetting the
            # producer), so this generation stays dead afterwards.
            self._exhausted = True
            raise item.exc
        if isinstance(item, _End):
            self._exhausted = True
            return None
        cols, offs = item
        self._offsets = offs
        return cols

    @property
    def offsets(self) -> List[int]:
        """Position after the last CONSUMED batch (never the producer's
        read-ahead) — what checkpoints must record for replay-not-skip."""
        if self._sync:
            return list(self.inner.offsets)
        return list(self._offsets)

    def seek(self, offsets: Sequence[int]) -> None:
        """Checkpoint resume: fence the producer, seek the inner source,
        restart a fresh generation from the restored position."""
        self._stop_producer()
        self.inner.seek(offsets)
        self._offsets = list(self.inner.offsets)
        self._exhausted = False
        if not self._sync:
            self._start_producer()

    def set_sync(self, flag: bool) -> None:
        """Toggle synchronous (unprefetched) serving.

        ``True`` stops the producer and REWINDS the inner source to the
        consumed position — queued read-ahead is discarded and re-served
        inline, so the caller (poison isolation) sees every unconsumed
        row at the same batch boundaries a checkpoint replay would.
        ``False`` resumes prefetching from wherever consumption stands.
        """
        flag = bool(flag)
        if flag == self._sync:
            return
        if flag:
            self._stop_producer()
            self.inner.seek(self._offsets)
            self._sync = True
            self._exhausted = False
            self._m_depth.set(0)
        else:
            self._sync = False
            self._exhausted = False
            self._start_producer()

    def commit(self) -> None:
        """Forward a broker-side commit with the CONSUMED offsets (the
        producer's read-ahead must never reach the broker: committed
        offsets trail the framework checkpoint, which trails
        consumption). Inner sources without ``commit`` are a no-op; ones
        whose ``commit`` takes no offsets get a plain call only in sync
        mode, where polled == consumed."""
        commit = getattr(self.inner, "commit", None)
        if commit is None:
            return
        import inspect

        try:
            takes_offsets = "offsets" in inspect.signature(
                commit).parameters
        except (TypeError, ValueError):  # builtins/c-impls: be safe
            takes_offsets = False
        if takes_offsets:
            commit(offsets=self._offsets)
        elif self._sync:
            commit()
        # else: skipping the commit is the safe side — the framework
        # checkpoint already persisted the consumed offsets, and a
        # committed read-ahead position could SKIP rows on a replay.

    def close(self) -> None:
        self._stop_producer()
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()
