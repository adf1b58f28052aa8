"""Failure detection, retries, fault injection and supervised recovery —
port of the JAX package's ``runtime/faults.py``.

- :class:`RetryPolicy` / :func:`with_retries` — exponential backoff with
  optional jitter;
- :class:`Heartbeat` — stall detection for the micro-batch loop;
- the injectors: :class:`FlakySource`, :class:`HangingSource`,
  :class:`PoisonSource`, :class:`FlakyStore`, :class:`TornStore`,
  :func:`poison_messages` and :func:`corrupt_messages`;
- :func:`run_with_recovery` — the supervisor: on a crash or a stall it
  builds a fresh engine, restores the newest valid checkpoint into it,
  seeks the source and resumes, exactly once at micro-batch granularity.
  K consecutive crashes at one progress point reclassify the failure as
  poison: the batch is bisected against a pre-batch state snapshot down
  to its failing rows, they go to the dead-letter queue, and the stream
  goes on past them.

Only the listed exception types are recovered from (``recover_on``:
:class:`TransientError`, ``OSError``, ``ConnectionError``). PyTorch
raises a CUDA fault (a kernel that does not build or launch, an illegal
address) as a plain ``RuntimeError``, which is not among them: it
propagates out of the supervisor at once and is never retried, bisected
or quarantined.

The supervisor also carries the learning loop across incarnations:
``make_feedback`` builds each incarnation's :class:`~.feedback.FeedbackLoop`,
``make_model_reload`` a fresh reloader, and ``learning`` (one
:class:`~.learner.LearningLoop` for the session) re-attaches to every new
engine. A watched incarnation reaches them, its feature cache, the shadow
scorer and the learner's tap only through fences, so a zombie can change
none of them; poison isolation runs without feedback or reload, with the
learner paused, and unprefetched: a source with ``set_sync``
(``runtime/prefetch.py``) serves it synchronously.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Type

import numpy as np

from real_time_fraud_detection_system_tpu_torch.utils.logging import (
    get_logger,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    active_recorder,
    get_registry,
)

log = get_logger("faults")


def _record_fault(kind: str, count: int = 1, **fields) -> None:
    """Count an injected fault by kind and land it in the flight record."""
    get_registry().counter(
        "rtfds_faults_injected_total", "injected faults by kind",
        kind=kind).inc(count)
    rec = active_recorder()
    if rec is not None:
        rec.record_event("fault", fault_kind=kind, count=count, **fields)


class TransientError(RuntimeError):
    """An injected or genuinely transient failure — safe to retry."""


class StallError(TransientError):
    """The watchdog found no engine progress within the stall budget."""


class PoisonRowError(TransientError):
    """A batch holds rows that decoded but carry impossible content (a
    negative amount).

    A :class:`TransientError` on purpose: when it is raised the
    supervisor cannot tell a corrupt record from an infrastructure
    hiccup; the crash-loop breaker of :func:`run_with_recovery` decides,
    by whether the failure recurs at the same progress point."""


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff ``delay = base * multiplier**attempt`` (capped). The slept
    time is uniform in ``[(1 - jitter) * d, d]`` (``jitter=1.0`` is full
    jitter); :meth:`delay` stays deterministic."""

    max_attempts: int = 4
    base_delay_s: float = 5.0
    multiplier: float = 1.0
    max_delay_s: float = 60.0
    jitter: float = 0.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be a fraction in [0, 1]")

    def delay(self, attempt: int) -> float:
        return min(self.base_delay_s * self.multiplier**attempt,
                   self.max_delay_s)

    def sleep_s(self, attempt: int,
                rand: Callable[[], float] = random.random) -> float:
        """The (possibly jittered) time to sleep for ``attempt``."""
        d = self.delay(attempt)
        if self.jitter <= 0.0:
            return d
        return d * (1.0 - self.jitter * rand())


def with_retries(
    fn: Callable,
    policy: RetryPolicy = RetryPolicy(),
    retry_on: Tuple[Type[BaseException], ...] = (TransientError,),
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` up to ``max_attempts`` times; exceptions not in
    ``retry_on`` propagate at once. Each retry counts in
    ``rtfds_retry_attempts_total{outcome=retried}``, an exhausted budget
    once in ``{outcome=exhausted}`` before the last error is raised."""
    reg = get_registry()
    m_retried = reg.counter(
        "rtfds_retry_attempts_total", "with_retries attempts by outcome",
        outcome="retried")
    m_exhausted = reg.counter(
        "rtfds_retry_attempts_total", "with_retries attempts by outcome",
        outcome="exhausted")
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — a retry loop
            last = e
            if attempt + 1 < policy.max_attempts:
                d = policy.sleep_s(attempt)
                m_retried.inc()
                log.warning("attempt %d/%d failed (%s); retrying in %.1fs",
                            attempt + 1, policy.max_attempts, e, d)
                sleep(d)
    m_exhausted.inc()
    raise last  # type: ignore[misc]


class Heartbeat:
    """Progress detector: ``beat()`` on every engine loop pass;
    ``healthy()`` turns False once ``timeout_s`` passes without one."""

    def __init__(self, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last = clock()
        self.beats = 0

    def beat(self) -> None:
        self._last = self._clock()
        self.beats += 1

    def healthy(self) -> bool:
        return (self._clock() - self._last) <= self.timeout_s

    def seconds_since_beat(self) -> float:
        return self._clock() - self._last


class HangingSource:
    """Scripted poll indices block silently (until ``release`` is set or
    ``max_hang_s`` passes) instead of raising: the failure only a
    watchdog catches. Each scripted hang fires once."""

    def __init__(self, inner, hang_at: Sequence[int] = (),
                 max_hang_s: float = 60.0):
        self.inner = inner
        self.hang_at = set(int(i) for i in hang_at)
        self.max_hang_s = max_hang_s
        self.release = threading.Event()
        self._polls = 0

    def poll_batch(self):
        i = self._polls
        self._polls += 1
        if i in self.hang_at:
            self.hang_at.discard(i)
            _record_fault("hang", poll=i)
            self.release.wait(timeout=self.max_hang_s)  # silent stall
        return self.inner.poll_batch()

    @property
    def offsets(self):
        return self.inner.offsets

    def seek(self, offsets):
        self.inner.seek(offsets)


class FlakySource:
    """Scripted poll indices raise :class:`TransientError` instead of
    returning; the inner source advances only on success, so the retried
    poll returns the batch the failure swallowed."""

    def __init__(self, inner, fail_at: Sequence[int] = ()):
        self.inner = inner
        self.fail_at = set(int(i) for i in fail_at)
        self._polls = 0

    def poll_batch(self):
        i = self._polls
        self._polls += 1
        if i in self.fail_at:
            _record_fault("flaky_poll", poll=i)
            raise TransientError(f"injected poll failure #{i}")
        return self.inner.poll_batch()

    @property
    def offsets(self):
        return self.inner.offsets

    def seek(self, offsets):
        self.inner.seek(offsets)


class PoisonSource:
    """Scripted ``tx_id`` rows are served with a negated amount on every
    poll that holds them: they decode fine and fail the engine's ingest
    check (:class:`PoisonRowError`) on every replay."""

    def __init__(self, inner, poison_tx_ids: Sequence[int] = ()):
        self.inner = inner
        self.poison_tx_ids = frozenset(int(i) for i in poison_tx_ids)
        self._ids = np.fromiter(sorted(self.poison_tx_ids), dtype=np.int64,
                                count=len(self.poison_tx_ids))

    def poll_batch(self):
        cols = self.inner.poll_batch()
        if cols is None or not len(self.poison_tx_ids):
            return cols
        tx = cols.get("tx_id")
        if tx is None or len(tx) == 0:
            return cols
        mask = np.isin(np.asarray(tx), self._ids)
        if mask.any():
            cols = dict(cols)
            amt = np.array(cols["tx_amount_cents"], copy=True)
            amt[mask] = -np.abs(amt[mask]) - 1
            cols["tx_amount_cents"] = amt
            _record_fault("poison", count=int(mask.sum()))
        return cols

    @property
    def offsets(self):
        return self.inner.offsets

    def seek(self, offsets):
        self.inner.seek(offsets)

    def commit(self) -> None:
        commit = getattr(self.inner, "commit", None)
        if commit is not None:
            commit()

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


class FlakyStore:
    """Wraps a store; scripted PUT/GET op indices (0-based, per verb)
    raise ``ConnectionError`` without touching it."""

    def __init__(self, inner, fail_puts: Sequence[int] = (),
                 fail_gets: Sequence[int] = ()):
        self.inner = inner
        self.fail_puts = set(int(i) for i in fail_puts)
        self.fail_gets = set(int(i) for i in fail_gets)
        self._puts = 0
        self._gets = 0

    def put(self, key: str, data: bytes) -> None:
        i = self._puts
        self._puts += 1
        if i in self.fail_puts:
            _record_fault("flaky_store_put", op=i, key=key)
            raise ConnectionError(f"injected store PUT failure #{i}")
        self.inner.put(key, data)

    def get(self, key: str) -> bytes:
        i = self._gets
        self._gets += 1
        if i in self.fail_gets:
            _record_fault("flaky_store_get", op=i, key=key)
            raise ConnectionError(f"injected store GET failure #{i}")
        return self.inner.get(key)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class TornStore:
    """Wraps a store; PUT number ``tear_at`` stores only its first
    ``keep_bytes`` and reports success — the silent torn write that only
    restore-time verification catches."""

    def __init__(self, inner, tear_at: int = 0, keep_bytes: int = 64):
        self.inner = inner
        self.tear_at = int(tear_at)
        self.keep_bytes = int(keep_bytes)
        self._puts = 0

    def put(self, key: str, data: bytes) -> None:
        i = self._puts
        self._puts += 1
        if i == self.tear_at:
            _record_fault("torn_store_put", op=i, key=key,
                          kept=min(self.keep_bytes, len(data)),
                          dropped=max(0, len(data) - self.keep_bytes))
            self.inner.put(key, data[: self.keep_bytes])
            return
        self.inner.put(key, data)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def poison_messages(msgs: Sequence[bytes],
                    poison_at: Sequence[int] = ()) -> list:
    """Re-encode the scripted messages with a negated amount: they still
    parse, so the value reaches the engine's ingest check."""
    from real_time_fraud_detection_system_tpu_torch.core.envelope import (
        decode_transaction_envelopes_fast,
        encode_transaction_envelopes,
    )

    idxs = sorted(set(int(i) for i in poison_at) if poison_at else ())
    idxs = [i for i in idxs if 0 <= i < len(msgs)]
    out = list(msgs)
    if not idxs:
        return out
    cols, invalid = decode_transaction_envelopes_fast(
        [msgs[i] for i in idxs])
    poisoned = encode_transaction_envelopes(
        cols["tx_id"], cols["tx_datetime_us"], cols["customer_id"],
        cols["terminal_id"], -np.abs(cols["tx_amount_cents"]) - 1,
    )
    n = 0
    for j, i in enumerate(idxs):
        if invalid[j]:
            continue  # already corrupt: the decoder masks it
        out[i] = poisoned[j]
        n += 1
    if n:
        _record_fault("poison_envelope", count=n)
    return out


def corrupt_messages(msgs: Sequence[bytes],
                     corrupt_every: int = 17) -> list:
    """Truncate every k-th message: the decoder must mask it, never crash
    the batch."""
    k = max(int(corrupt_every), 1)
    out = [
        m[: max(len(m) // 2, 1)] if i % k == k - 1 else m
        for i, m in enumerate(msgs)
    ]
    n_corrupt = len(msgs) // k
    if n_corrupt:
        _record_fault("corrupt_envelope", count=n_corrupt)
    return out


class _FencedCheckpointer:
    """Restores only checkpoints saved through this wrapper (the
    ``resume=False`` fence). The checkpoints already there are moved
    aside (``stale-<token>-…``) at this run's first save, not before: a
    fresh run that dies before saving leaves them resumable."""

    def __init__(self, inner):
        self.inner = inner
        self._saved: list = []
        self._stale: list = list(inner.list_checkpoints())

    def save(self, engine_state):
        if self._stale:
            self.inner.quarantine(self._stale, uuid.uuid4().hex[:8])
            self._stale = []
        path = self.inner.save(engine_state)
        self._saved.append(path)
        return path

    def restore(self, engine_state, path=None):
        if path is None:
            mine = [p for p in self._saved if self.inner.exists(p)]
            if not mine:
                return None
            path = max(mine)
        return self.inner.restore(engine_state, path=path)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _AbandonFence:
    """Shared flag: flipped when the watchdog abandons an incarnation."""

    def __init__(self):
        self.abandoned = False

    def check(self) -> None:
        if self.abandoned:
            raise StallError("incarnation abandoned by the watchdog")


class _FenceGuard:
    """Proxy that cuts an abandoned (zombie) incarnation off from the
    shared source, sink, checkpointer and heartbeat: once the watchdog
    gives up on it, its next touch of any of them raises
    :class:`StallError` in the zombie's thread."""

    def __init__(self, inner, fence: _AbandonFence):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_fence", fence)

    def __getattr__(self, name):
        fence = object.__getattribute__(self, "_fence")
        inner = object.__getattribute__(self, "_inner")
        attr = getattr(inner, name)
        if callable(attr):
            def _guarded(*a, **k):
                fence.check()
                return attr(*a, **k)

            return _guarded
        fence.check()
        return attr

    def __setattr__(self, name, value):
        fence = object.__getattribute__(self, "_fence")
        fence.check()
        setattr(object.__getattribute__(self, "_inner"), name, value)


def _fence_model_reload(model_reload, fence: "_AbandonFence"):
    """Fence a reload poll, and keep the shared signature baseline honest:
    a poll whose incarnation was abandoned during the call may have
    committed the file's new signature (``poll.sig_state``) while its
    swap can never land; the pre-call signature is put back so the live
    incarnation's next poll still sees the change."""
    sig = getattr(model_reload, "sig_state", None)

    def _fenced_reload():
        fence.check()
        before = sig.get("sig") if sig is not None else None
        out = model_reload()
        try:
            fence.check()
        except StallError:
            if sig is not None:
                sig["sig"] = before
            raise
        return out

    return _fenced_reload


class _GuardedSource(_FenceGuard):
    """Source fence with a check after the poll as well: a poll in flight
    when the incarnation was abandoned drops its batch and kills the
    zombie (at most one batch lost in that double fault; pass
    ``make_source`` to :func:`run_with_recovery` to avoid sharing the
    cursor at all)."""

    def poll_batch(self):
        fence = object.__getattribute__(self, "_fence")
        inner = object.__getattribute__(self, "_inner")
        fence.check()
        cols = inner.poll_batch()
        fence.check()
        return cols


def _run_watched(engine, source, sink, checkpointer, run_batches: int,
                 heartbeat: Heartbeat, feedback=None, model_reload=None,
                 learning=None, target=None):
    """Run one incarnation in a worker thread under the stall watchdog.

    This (supervisor) thread polls ``heartbeat.healthy()``; on a stall the
    worker is abandoned (a thread blocked in a hung call cannot be
    killed), fenced off from the shared objects, and :class:`StallError`
    goes to the restart path. The abandoned thread keeps its engine — its
    own state tensors, pinned staging ring and side stream — until it
    wakes and dies at the fence; then the thread releases it.
    ``run_batches`` is ``engine.run``'s ``max_batches`` (this run's).
    ``target`` replaces ``engine.run``: ``target(source, sink,
    checkpointer, heartbeat)`` over the guarded objects (the poison
    isolation). ``feedback``, ``model_reload`` and ``learning`` are
    fenced the same way, and so are the objects that outlive incarnations
    on the engine: its feature cache, the shadow scorer and the learner's
    tap."""
    box: dict = {}
    fence = _AbandonFence()
    g_source = _GuardedSource(source, fence)
    g_sink = _FenceGuard(sink, fence) if sink is not None else None
    g_ckpt = _FenceGuard(checkpointer, fence) if checkpointer is not None \
        else None
    g_heartbeat = _FenceGuard(heartbeat, fence)
    g_feedback = _FenceGuard(feedback, fence) if feedback is not None \
        else None
    g_learning = _FenceGuard(learning, fence) if learning is not None \
        else None
    g_model_reload = (_fence_model_reload(model_reload, fence)
                      if model_reload is not None else None)
    if getattr(engine, "feature_cache", None) is not None:
        # the cache outlives incarnations (the feedback join finds rows
        # scored before a restart): a zombie must not overwrite rows or
        # reset their labeled marks
        engine.feature_cache = _FenceGuard(engine.feature_cache, fence)
    if learning is not None:
        # attach now (the run's attach is then a no-op for this engine)
        # and fence what it installed: the shared shadow cache and the
        # learner queue
        learning.attach(engine)
        if engine.shadow is not None:
            engine.shadow = _FenceGuard(engine.shadow, fence)
        if engine.feedback_tap is not None:
            _tap = engine.feedback_tap

            def _fenced_tap(*a, **k):
                fence.check()
                return _tap(*a, **k)

            engine.feedback_tap = _fenced_tap

    def _target():
        try:
            if target is not None:
                box["stats"] = target(g_source, g_sink, g_ckpt,
                                      g_heartbeat)
            else:
                box["stats"] = engine.run(
                    g_source, sink=g_sink, checkpointer=g_ckpt,
                    max_batches=run_batches, heartbeat=g_heartbeat,
                    feedback=g_feedback, model_reload=g_model_reload,
                    learning=g_learning)
        # the thread boundary: the original exception crosses to the
        # supervisor thread, which applies the recover_on policy
        except BaseException as e:  # noqa: BLE001
            box["err"] = e

    heartbeat.beat()  # an incarnation's start is progress
    worker = threading.Thread(target=_target, daemon=True,
                              name="engine-incarnation")
    worker.start()
    poll = min(max(heartbeat.timeout_s / 4.0, 0.01), 1.0)
    while worker.is_alive():
        worker.join(poll)
        if worker.is_alive() and not heartbeat.healthy():
            fence.abandoned = True
            _retire(engine)
            raise StallError(
                f"no engine progress for "
                f"{heartbeat.seconds_since_beat():.1f}s (stall budget "
                f"{heartbeat.timeout_s:.1f}s); abandoning hung incarnation"
            )
    if "err" in box:
        raise box["err"]
    return box["stats"]


def _retire(engine) -> None:
    """Fence a finished incarnation off the shared cold store: its
    promoter stops and its store handle refuses writes (the next
    incarnation opens the store afresh)."""
    fence_cold = getattr(engine, "fence_cold", None)
    if fence_cold is not None:
        fence_cold()


def _subset_cols(cols: dict, idx) -> dict:
    return {k: np.asarray(v)[idx] for k, v in cols.items()}


def _bisect_poison_rows(engine, snapshot: bytes, cols: dict,
                        recover_on,
                        heartbeat=None) -> Tuple[np.ndarray, dict]:
    """The minimal failing row set of a poison batch, by halving.

    Every probe first restores the engine's whole state from the
    pre-batch ``snapshot`` (in place), so probes never change the feature
    state, counters or offsets. A set that fails only as a whole (each
    half passes alone) is quarantined whole. Only ``recover_on`` failures
    count as failing; anything else (a CUDA fault) propagates. Returns
    ``(bad_row_indices, {row: exception})``, the engine left at the
    snapshot."""
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        bytes_to_state,
    )

    n = len(next(iter(cols.values())))
    bad: list = []
    errors: dict = {}

    def probe(idx) -> Optional[BaseException]:
        if heartbeat is not None:
            heartbeat.beat()  # a probe is progress
        bytes_to_state(snapshot, engine.state)
        try:
            engine.process_batch(_subset_cols(cols, idx))
            return None
        except recover_on as e:
            return e

    def rec(idx) -> None:
        e = probe(idx)
        if e is None:
            return
        if len(idx) == 1:
            i = int(idx[0])
            bad.append(i)
            errors[i] = e
            return
        before = len(bad)
        mid = len(idx) // 2
        rec(idx[:mid])
        rec(idx[mid:])
        if len(bad) == before:
            # fails only in combination: quarantine the whole subset
            for i in idx:
                bad.append(int(i))
                errors[int(i)] = e

    rec(np.arange(n))
    bytes_to_state(snapshot, engine.state)
    return np.asarray(sorted(set(bad)), dtype=np.int64), errors


def _run_poison_isolation(engine, source, sink, checkpointer, dead_letter,
                          max_batches: int, recover_on,
                          heartbeat: Optional[Heartbeat] = None) -> int:
    """One careful incarnation: step batch by batch, each from a
    pre-batch snapshot, until the crash-looping batch is found; bisect
    it, quarantine its failing rows, score and sink the survivors, and
    checkpoint past it. Returns control after the first quarantine, after
    a clean budget (the crash then was a same-point transient), at the
    end of the stream or at ``max_batches``. A poll that raises is not
    row poison and propagates. Returns the rows quarantined."""
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        state_to_bytes,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        empty_batch_result,
    )

    every = int(getattr(engine.cfg.runtime, "checkpoint_every_batches", 50)
                or 50)
    clean_budget = 2 * every + 8
    clean = 0
    quarantined = 0
    rec = active_recorder()
    log.warning("poison isolation: stepping batch-by-batch from batch %d",
                engine.state.batches_done)
    while True:
        if heartbeat is not None:
            heartbeat.beat()
        if max_batches and engine.state.batches_done >= max_batches:
            break
        if clean >= clean_budget:
            log.info("poison isolation: %d clean batches, no crash — "
                     "reclassifying as transient and resuming", clean)
            break
        snapshot = state_to_bytes(engine.state)
        cols = source.poll_batch()  # a poll crash is not row poison
        if cols is None:
            break
        if len(next(iter(cols.values()), ())) == 0:
            break  # an idle live source: back to the paced loop
        offsets = list(source.offsets)
        try:
            res = engine.process_batch(cols)
        except recover_on as e:
            bad_idx, errors = _bisect_poison_rows(
                engine, snapshot, cols, recover_on, heartbeat=heartbeat)
            batch_index = int(engine.state.batches_done) + 1
            if len(bad_idx) == 0:
                raise  # every probe passed: retry the batch whole
            dead_letter.put_rows(
                _subset_cols(cols, bad_idx), reason="crash",
                errors=[f"{type(errors[int(i)]).__name__}: "
                        f"{errors[int(i)]}"[:300] for i in bad_idx],
                batch_index=batch_index, offsets=offsets)
            quarantined += len(bad_idx)
            log.warning(
                "poison isolation: batch %d crashed (%s: %s); "
                "quarantined %d/%d rows to the dead-letter queue",
                batch_index, type(e).__name__, str(e)[:120],
                len(bad_idx), len(next(iter(cols.values()))))
            good = np.ones(len(next(iter(cols.values()))), dtype=bool)
            good[bad_idx] = False
            if good.any():
                # survivors score from the pre-batch snapshot: the state
                # never sees the quarantined rows
                res = engine.process_batch(_subset_cols(
                    cols, np.flatnonzero(good)))
            else:
                engine.state.batches_done += 1
                res = empty_batch_result(engine.state.batches_done)
            engine.state.offsets = offsets
            if sink is not None:
                sink.append(res)
            break  # the checkpoint below goes past the poison batch
        engine.state.offsets = offsets
        if sink is not None:
            sink.append(res)
        clean += 1
    drain = getattr(sink, "drain", None) if sink is not None else None
    if drain is not None:
        drain()
    checkpointer.save(engine.checkpoint_state())
    commit = getattr(source, "commit", None)
    if commit is not None:
        commit()
    if rec is not None:
        rec.record_event("poison", phase="isolated", rows=quarantined,
                         batches_done=int(engine.state.batches_done))
    return quarantined


def run_with_recovery(
    make_engine: Callable[[], object],
    source=None,
    checkpointer=None,
    sink=None,
    max_restarts: int = 3,
    max_batches: int = 0,
    heartbeat: Optional[Heartbeat] = None,
    stall_timeout_s: float = 0.0,
    resume: bool = True,
    make_source: Optional[Callable[[], object]] = None,
    make_feedback: Optional[Callable[[object], object]] = None,
    make_model_reload: Optional[Callable[[], object]] = None,
    learning=None,
    recover_on: Tuple[Type[BaseException], ...] = (
        TransientError, OSError, ConnectionError,
    ),
    crash_loop_k: int = 2,
    dead_letter=None,
    restart_backoff: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> dict:
    """Supervisor: run; on a crash or a stall, restore and resume.

    ``make_engine`` builds a fresh engine per incarnation; the
    checkpointer restores (offsets, feature state, params, scaler) into
    its tensors and the source seeks to the offsets, so every committed
    micro-batch is processed once and the rest replay. The sink must take
    replays (``ParquetSink`` overwrites by ``batch_index``); its
    ``truncate_after`` drops parts past the restored counter.
    ``make_engine`` runs outside the restarts: on the card it loads the
    kernels, and one that does not build or load propagates.

    - ``max_batches``: stop once the engine has finished that many
      batches in its lifetime, restored ones included (the JAX count).
    - Watchdog: ``stall_timeout_s`` (or a ``heartbeat``) runs each
      incarnation in a worker thread and turns a loop pass that never
      comes into a :class:`StallError` restart.
    - ``make_source``: a fresh source per incarnation (a zombie then owns
      a dead session); at least one of ``source``/``make_source``.
    - ``resume=False``: ignore checkpoints from before this run (the
      checkpointer is fenced).
    - ``make_feedback(engine)``: each incarnation's feedback loop (a fresh
      consumer session); ``make_model_reload()``: a fresh reloader per
      incarnation (a restore brings pre-swap weights, so the new one
      re-applies the newest artifact); ``learning``: the session's
      learning loop, attached to every incarnation's engine and paused
      during poison isolation, which runs without feedback or reload.
    - ``recover_on``: the recoverable types; anything else propagates at
      once (a CUDA fault is a ``RuntimeError``, never in this list).
    - Crash-loop breaker: ``crash_loop_k`` consecutive same-typed crashes
      at one progress point (batch counter and offsets at the failure)
      count once in ``rtfds_crash_loops_total``; with a ``dead_letter``
      sink the next incarnation isolates the poison rows and the restart
      budget is refunded; without one the budgeted retries go on.
    - ``restart_backoff``: sleep between crash restarts (not after
      stalls, nor before isolation), counted in
      ``rtfds_restart_backoff_seconds_total``.
    """
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        batches_left,
    )

    if source is None and make_source is None:
        raise ValueError("run_with_recovery needs a source or make_source")
    restarts = 0
    budget_used = 0  # like restarts, but refunded on poison isolation
    fail_key: Optional[tuple] = None  # progress point of the last crash
    fail_count = 0
    poison_pending = False
    if source is None:
        source = make_source()
    initial_offsets = list(source.offsets)
    if not resume:
        checkpointer = _FencedCheckpointer(checkpointer)
    if heartbeat is None and stall_timeout_s > 0:
        heartbeat = Heartbeat(timeout_s=stall_timeout_s)
    last_was_stall = False
    t_session = time.monotonic()
    while True:
        engine = make_engine()
        if restarts > 0 and make_source is not None:
            # a fresh session per incarnation; the old one is closed only
            # after a crash (after a stall a zombie may still be in it)
            close = getattr(source, "close", None)
            if close is not None and not last_was_stall:
                try:
                    close()
                # best effort: the crash being handled is the signal
                except Exception:  # noqa: BLE001
                    pass
            source = make_source()
        restored = None
        if resume or restarts > 0:
            restored = checkpointer.restore(engine.state)
        if restored is not None:
            source.seek(engine.state.offsets)
            log.info("restored checkpoint at batch %d",
                     engine.state.batches_done)
        else:
            # nothing saved yet: start from the very beginning
            source.seek(initial_offsets)
        truncate = getattr(sink, "truncate_after", None) if sink else None
        if truncate is not None:
            truncate(engine.state.batches_done)
        # max_batches counts the engine's lifetime, restored batches too
        run_batches = batches_left(engine.state, max_batches)
        # isolation incarnations diagnose one batch: no feedback, no reload
        feedback = (make_feedback(engine)
                    if make_feedback and not poison_pending else None)
        model_reload = (make_model_reload()
                        if make_model_reload and not poison_pending
                        else None)
        # isolation runs unprefetched: set_sync(True) stops a
        # PrefetchSource's producer and rewinds it to the consumed
        # position, so the bisection sees the batch boundaries a replay
        # sees; prefetching resumes once isolation got past the batch
        set_sync = getattr(source, "set_sync", None)
        if poison_pending and set_sync is not None:
            set_sync(True)
        try:
            if poison_pending:
                # no training overlaps a bisection in progress
                if learning is not None:
                    learning.pause()
                if heartbeat is not None:
                    _run_watched(
                        engine, source, sink, checkpointer, run_batches,
                        heartbeat,
                        target=lambda src, snk, ckpt, hb:
                        _run_poison_isolation(
                            engine, src, snk, ckpt, dead_letter,
                            max_batches, recover_on, heartbeat=hb),
                    )
                else:
                    _run_poison_isolation(
                        engine, source, sink, checkpointer, dead_letter,
                        max_batches, recover_on,
                    )
                # past the suspect point: clear the diagnosis and refund
                # the restart budget the loop consumed
                poison_pending = False
                fail_key, fail_count = None, 0
                budget_used = 0
                if set_sync is not None:
                    set_sync(False)
                if learning is not None:
                    learning.resume()
                _retire(engine)
                continue
            if heartbeat is not None:
                stats = _run_watched(
                    engine, source, sink, checkpointer, run_batches,
                    heartbeat, feedback=feedback, model_reload=model_reload,
                    learning=learning)
            else:
                stats = engine.run(
                    source, sink=sink, checkpointer=checkpointer,
                    max_batches=run_batches, feedback=feedback,
                    model_reload=model_reload, learning=learning)
            # a final checkpoint, so a clean exit never replays
            checkpointer.save(engine.checkpoint_state())
            commit = getattr(source, "commit", None)
            if commit is not None:
                commit()
            if feedback is not None:
                feedback.commit()
                feedback.close()
            stats["restarts"] = restarts
            # whole-session totals: the engine's lifetime counters
            # (restored + this incarnation) and the session's wall clock
            stats["rows"] = engine.state.rows_done
            stats["batches"] = engine.state.batches_done
            stats["wall_s"] = time.monotonic() - t_session
            stats["rows_per_s"] = (
                stats["rows"] / stats["wall_s"] if stats["wall_s"] > 0
                else 0.0
            )
            return stats
        except recover_on as e:
            _retire(engine)
            restarts += 1
            budget_used += 1
            last_was_stall = isinstance(e, StallError)
            if feedback is not None and not last_was_stall:
                # close the dead incarnation's session so its group
                # rebalances (a stalled zombie may still be inside it)
                try:
                    feedback.close()
                # best effort: the crash being handled is the signal
                except Exception:  # noqa: BLE001
                    pass
            log.warning("engine crashed (%s); restart %d/%d",
                        e, restarts, max_restarts)
            cause = "stall" if last_was_stall else "crash"
            err_s = f"{type(e).__name__}: {e}"[:200]
            rec = active_recorder()
            classified = False
            if not last_was_stall and not poison_pending:
                fail_sig = (
                    int(getattr(engine.state, "batches_done", -1)),
                    tuple(int(x) for x in
                          getattr(engine.state, "offsets", ()) or ()),
                    type(e).__name__,
                )
                if fail_sig == fail_key:
                    fail_count += 1
                else:
                    fail_key, fail_count = fail_sig, 1
                if fail_count == max(1, int(crash_loop_k)):
                    get_registry().counter(
                        "rtfds_crash_loops_total",
                        "crash loops reclassified from transient to "
                        "poison (K consecutive failures at one progress "
                        "point)").inc()
                    if rec is not None:
                        rec.record_event(
                            "poison", phase="detected",
                            resume_batch=fail_key[0],
                            failures=fail_count, error=err_s)
                    if dead_letter is None:
                        log.error(
                            "crash loop: %d consecutive failures at "
                            "progress point %s — likely poison input; "
                            "configure a dead-letter sink "
                            "(--dead-letter) to quarantine it instead "
                            "of retrying into the restart budget",
                            fail_count, fail_key)
                    else:
                        classified = True
            if classified:
                # bounded by construction: isolation advances or lands
                # back here with poison_pending set, where the budget
                # applies
                poison_pending = True
                fail_key, fail_count = None, 0
            elif budget_used > max_restarts:
                # the final failure is not a restart
                if rec is not None:
                    rec.record_event(
                        "gave_up", restarts=restarts - 1, cause=cause,
                        error=err_s)
                raise
            get_registry().counter(
                "rtfds_engine_restarts_total",
                "supervisor restarts by cause", cause=cause).inc()
            if rec is not None:
                rec.record_event(
                    "restart", restarts=restarts, cause=cause, error=err_s)
            if restart_backoff is not None and not last_was_stall \
                    and not classified:
                d = restart_backoff.sleep_s(budget_used - 1)
                if d > 0:
                    get_registry().counter(
                        "rtfds_restart_backoff_seconds_total",
                        "seconds slept backing off between restarts",
                    ).inc(d)
                    log.info("backing off %.2fs before restart %d",
                             d, restarts)
                    sleep(d)
