"""Overload survival — port of the JAX package's ``runtime/overload.py``:
a hysteresis-driven degradation ladder.

:class:`OverloadController` is an explicit state machine driven by the
registry's signals — windowed p50 batch latency vs
``runtime.latency_slo_ms``, the source's ``rtfds_source_lag_rows``
(component ``lag``), the prefetch queue's ``rtfds_prefetch_queue_depth``
over ``runtime.prefetch_batches`` (``prefetch_fill``), the async sinks'
``rtfds_sink_queue_depth`` over ``runtime.sink_queue_batches``
(``sink_fill``), the cold-tier promoter's backlog — normalized into one
scalar **pressure** (the max of the normalized components, so the worst
signal owns the verdict). The sources, the prefetcher and the sinks
publish those series live (``runtime/sources.py``,
``runtime/prefetch.py``, ``io/sink.py``). Distinct climb/descend
thresholds plus per-direction dwell counts make the ladder flap-proof:
one spike can neither climb nor descend it.

The rungs, each reversible:

1. **Shed optional work** — pause shadow scoring and learner training
   through their pause hooks, and sample the flight record (every
   ``overload.recorder_sample_every``-th batch record; events always
   land).
2. **Degrade the data plane** — force the adaptive batcher to the
   largest bucket and switch to alerts-only emission. Both switches are
   HOST-side only: every dispatch stays a signature of
   ``ScoringEngine.dispatch_inventory()`` (the captured graphs are
   untouched — the feature matrix simply stays on the device unfetched),
   so a full climb+descend cycle captures no graph again
   (``cuda_graph_recaptures_total`` stays 0).
3. **Admission control** — defer whole micro-batches to a durable
   overflow spill (the dead-letter machinery, ``reason=shed``,
   idempotent by tx_id) instead of dispatching them. Deferral is
   whole-batch and strictly FIFO; when pressure subsides the queue
   replays **in order through the normal scoring path before live
   traffic resumes**, so the feature state is bit-identical to a
   never-overloaded run that saw the same rows later. No row skips a
   state update and none is silently lost:
   ``scored + deferred-pending == polled`` (see :meth:`invariant`).

Every transition is a flight-record event (``overload_climb`` /
``overload_descend``; deferral and replay land as ``shed`` / ``replay``)
and rides ``rtfds_overload_rung`` /
``rtfds_overload_transitions_total{direction}`` /
``rtfds_shed_rows_total`` / ``rtfds_shed_replayed_rows_total`` /
``rtfds_shed_pending_rows``, the JAX package's series.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from real_time_fraud_detection_system_tpu_torch.utils.logging import get_logger
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
    get_registry,
)

log = get_logger("overload")

RUNG_MAX = 3


def _noop_flag(on: bool) -> None:
    return None


@dataclass
class LadderActions:
    """The engine-side effects of each rung, as injectable callables —
    the controller decides, the serving loop applies. Every action takes
    ``on`` and must be idempotent + reversible (the ladder descends).

    ``shed_optional`` (rung >= 1): pause shadow scoring + learner
    training via the existing pause hooks; sample the flight recorder.
    ``degrade_emission`` (rung >= 2): alerts-only emission, host-side
    only (the step and its graphs never change).
    ``force_max_batch`` (rung >= 2): pin autobatch to the largest
    bucket. Rung 3 has no action of its own — deferral is the serving
    loop consulting :meth:`OverloadController.should_defer`.
    """

    shed_optional: Callable[[bool], None] = _noop_flag
    degrade_emission: Callable[[bool], None] = _noop_flag
    force_max_batch: Callable[[bool], None] = _noop_flag


@dataclass
class DeferredBatch:
    """One rung-3 deferred micro-batch, exactly as assembled."""

    seq: int                 # monotone deferral sequence (spill part id)
    cols: dict               # the polled column dict, order preserved
    offsets: List[int]       # source offsets AFTER this batch's polls
    rows: int                # len(cols) at deferral time


class OverloadController:
    """The ladder state machine. One instance per ``engine.run``.

    The serving loop calls, in its own order: :meth:`want_replay` /
    :meth:`next_replay` before polling, :meth:`should_defer` +
    :meth:`defer` after assembling a batch, :meth:`observe_batch` (and
    :meth:`note_replayed`) per finished batch, and :meth:`deactivate`
    on the way out. Everything runs on the loop thread — no locks, no
    cross-thread state (the spill sink has its own lock).
    """

    def __init__(self, rcfg, registry: Optional[MetricsRegistry] = None,
                 actions: Optional[LadderActions] = None,
                 recorder_fn: Optional[Callable] = None):
        ocfg = rcfg.overload
        self.ocfg = ocfg
        self.rcfg = rcfg
        self.actions = actions if actions is not None else LadderActions()
        self._recorder_fn = recorder_fn if recorder_fn is not None else (
            lambda: None)
        self.reg = registry if registry is not None else get_registry()
        self.rung = 0
        self.slo_s = max(0.0, float(rcfg.latency_slo_ms)) / 1e3
        self._lat: deque = deque(
            maxlen=max(1, int(ocfg.latency_window_batches)))
        self._climb_streak = 0
        self._descend_streak = 0
        # rung-3 drain mode: descend dwell was met, the deferred queue
        # replays in order; the 3->2 transition lands when it EMPTIES
        self._draining = False
        self._outstanding_replays = 0
        self.max_deferred = int(ocfg.max_deferred_batches)
        # Bounded by max_deferred_batches: should_defer()/want_replay()
        # replay the head to make room at the cap, so membership never
        # exceeds it (the remaining backlog stays in the source/broker).
        # loop-thread-only FIFO, capped at max_deferred_batches by the
        # defer/replay admission below; deque(maxlen=) would DROP the head
        # on overflow, which a no-silent-loss spill must never do
        self._deferred: deque = deque()
        self._seq = 0
        # lag-trend EMA state (rows/s; negative = draining)
        self._last_lag: Optional[Tuple[float, float]] = None  # (t, lag)
        self._trend: Optional[float] = None
        self.spill = None
        if ocfg.spill_path:
            from real_time_fraud_detection_system_tpu_torch.io.sink import (
                make_dead_letter_sink,
            )

            # Private registry + muted recorder: the spill reuses the
            # dead-letter file machinery (durability, tx_id idempotence)
            # but shed rows are NOT a triage backlog — they must not
            # trip the DLQ degraded state, tile, or counters. The
            # controller emits its own shed/replay telemetry.
            self.spill = make_dead_letter_sink(
                ocfg.spill_path, registry=MetricsRegistry(),
                recorder_fn=lambda: None)
        else:
            log.warning(
                "overload ladder enabled without a spill path: rung-3 "
                "deferral is memory-only (a crash relies on checkpoint "
                "replay alone to recover deferred rows)")
        reg = self.reg
        self._m_rung = reg.gauge(
            "rtfds_overload_rung",
            "active overload-ladder rung (0 = normal serving; 1 = "
            "optional work shed; 2 = degraded data plane; 3 = admission "
            "control / deferral)")
        self._m_rung.set(0.0)
        self._m_trans = {
            d: reg.counter(
                "rtfds_overload_transitions_total",
                "overload-ladder rung transitions by direction",
                direction=d)
            for d in ("climb", "descend")
        }
        self._m_shed = reg.counter(
            "rtfds_shed_rows_total",
            "rows deferred to the overload spill (whole batches, "
            "replayed in order once pressure subsides)")
        self._m_replayed = reg.counter(
            "rtfds_shed_replayed_rows_total",
            "deferred rows replayed through the normal scoring path")
        self._m_pending = reg.gauge(
            "rtfds_shed_pending_rows",
            "deferred rows not yet replayed (healthz degrades while > 0)")
        self._m_lag_trend = reg.gauge(
            "rtfds_source_lag_trend_rows_per_s",
            "EMA slope of rtfds_source_lag_rows (negative = the backlog "
            "is draining)")
        # Raw normalized pressure (the max over components the ladder
        # judges), exported for the elastic autoscaler: the launcher's
        # policy watches the worst-process value alongside the rung —
        # the rung says what the ladder DID, the pressure says how far
        # past (or under) the thresholds the process is running.
        self._m_pressure = reg.gauge(
            "rtfds_overload_pressure",
            "normalized overload pressure (max component; >= "
            "climb threshold sustains a rung climb, autoscaler input)")

    # -- signals -----------------------------------------------------------

    def _pressure(self, include_latency: bool) -> Tuple[float, dict]:
        """Normalized pressure components; the max owns the verdict.

        ``include_latency=False`` while rung-3 deferral is the only
        activity: no batches finish there, so the latency window is
        stale-high by construction and would wedge the ladder at the
        top — descent is then judged on lag/queue signals alone.
        """
        comps = {}
        if include_latency and self.slo_s > 0 and len(self._lat) >= min(
                3, self._lat.maxlen):
            s = sorted(self._lat)
            comps["latency"] = s[len(s) // 2] / self.slo_s
        lag_high = int(self.ocfg.lag_high_rows)
        lag = self.reg.get("rtfds_source_lag_rows")
        if lag is not None:
            self._note_lag(lag.value)
            if lag_high > 0:
                comps["lag"] = lag.value / lag_high
        pf_cap = int(self.rcfg.prefetch_batches)
        if pf_cap > 0:
            depth = self.reg.get("rtfds_prefetch_queue_depth")
            if depth is not None:
                comps["prefetch_fill"] = depth.value / pf_cap
        sink_cap = int(self.rcfg.sink_queue_batches)
        if sink_cap > 0:
            depth_total = self.reg.family_total("rtfds_sink_queue_depth")
            if depth_total is not None:
                comps["sink_fill"] = depth_total / sink_cap
        # Cold-promotion storm (features.cold_store): a promoter backlog
        # pinned at its bounded queue depth means returning keys are
        # arriving faster than promotions can land — the sketch serves
        # them degraded meanwhile, and the host is doing segment reads at
        # full tilt. Same normalized fill shape as the queue signals.
        q_limit = self.reg.get("rtfds_feature_cold_promote_queue_limit")
        if q_limit is not None and q_limit.value > 0:
            backlog = self.reg.get("rtfds_feature_cold_promote_backlog")
            if backlog is not None:
                comps["cold_promote"] = backlog.value / q_limit.value
        return (max(comps.values()) if comps else 0.0), comps

    def _note_lag(self, lag: float) -> None:
        now = time.perf_counter()
        if self._last_lag is not None:
            t0, l0 = self._last_lag
            dt = now - t0
            if dt > 1e-6:
                slope = (lag - l0) / dt
                self._trend = slope if self._trend is None else (
                    0.5 * slope + 0.5 * self._trend)
                self._m_lag_trend.set(self._trend)
        self._last_lag = (now, lag)

    # -- hysteresis core ---------------------------------------------------

    def _evaluate(self, include_latency: bool) -> None:
        pressure, comps = self._pressure(include_latency)
        self._m_pressure.set(pressure)
        if pressure >= self.ocfg.climb_pressure:
            self._descend_streak = 0
            self._climb_streak += 1
            if self._climb_streak >= self.ocfg.climb_dwell_batches:
                self._climb_streak = 0
                if self.rung < RUNG_MAX:
                    self._transition(+1, pressure, comps)
                elif self._draining:
                    # pressure came back mid-drain: pause the replay
                    # (new polls defer again); NOT a rung transition
                    self._draining = False
                    log.info("overload: drain paused, pressure %.2f "
                             "re-climbed (%s)", pressure, comps)
        elif pressure <= self.ocfg.descend_pressure:
            self._climb_streak = 0
            self._descend_streak += 1
            if self._descend_streak >= self.ocfg.descend_dwell_batches:
                self._descend_streak = 0
                if self.rung == RUNG_MAX and (
                        self._deferred or self._outstanding_replays):
                    if not self._draining:
                        self._draining = True
                        log.info("overload: pressure %.2f subsided, "
                                 "replaying %d deferred batch(es) in "
                                 "order before live traffic", pressure,
                                 len(self._deferred))
                elif self.rung > 0:
                    self._transition(-1, pressure, comps)
        else:
            # hysteresis dead band: streaks reset, nothing moves
            self._climb_streak = 0
            self._descend_streak = 0

    def _transition(self, di: int, pressure: float, comps: dict) -> None:
        old, new = self.rung, self.rung + di
        self.rung = new
        direction = "climb" if di > 0 else "descend"
        self._m_trans[direction].inc()
        self._m_rung.set(new)
        # apply/revert the rung's actions (idempotent, reversible)
        if direction == "climb":
            if new == 1:
                self.actions.shed_optional(True)
            elif new == 2:
                self.actions.force_max_batch(True)
                self.actions.degrade_emission(True)
            # new == 3: behavioral — should_defer() turns True
        else:
            if old == 2:
                self.actions.degrade_emission(False)
                self.actions.force_max_batch(False)
            elif old == 1:
                self.actions.shed_optional(False)
            elif old == RUNG_MAX:
                self._draining = False
        rec = self._recorder_fn()
        if rec is not None:
            rec.record_event(
                f"overload_{direction}", rung=new, from_rung=old,
                pressure=round(pressure, 4),
                **{k: round(v, 4) for k, v in comps.items()})
        log.info("overload: %s to rung %d (pressure %.2f: %s)",
                 direction, new, pressure,
                 {k: round(v, 2) for k, v in comps.items()} or "idle")

    # -- serving-loop API --------------------------------------------------

    def observe_batch(self, rows: int, latency_s: float) -> None:
        """One finished (scored) batch — the ladder's main clock."""
        if latency_s > 0:
            self._lat.append(float(latency_s))
        self._evaluate(include_latency=True)

    def idle_tick(self) -> None:
        """A zero-row idle poll — the ladder's clock when the source
        goes quiet. Without this, a burst followed by silence would
        latch every degrade forever: no batches finish, so
        observe_batch never runs, descend dwell never accumulates, and
        deferred rows wait for traffic that may not return. The quiet
        period is exactly when the ladder should descend and replay —
        judged on lag/queue signals alone (the latency window is stale
        by definition when nothing is being scored)."""
        self._evaluate(include_latency=False)

    def should_defer(self) -> bool:
        """True while rung 3 admission control holds and the queue is
        not draining: the just-assembled batch must be deferred, not
        dispatched (dispatching it would reorder it past the deferred
        FIFO and diverge the feature state)."""
        return self.rung >= RUNG_MAX and not self._draining

    def defer(self, cols: dict, offsets: List[int]) -> DeferredBatch:
        """Defer one whole assembled micro-batch: durable spill write
        (idempotent by tx_id) + FIFO enqueue + counters + flight event.
        The batch consumes no batch_index and advances no offsets — the
        sink lineage stays gap-free and a crash replays these rows from
        the checkpoint."""
        n = len(cols["tx_id"])
        item = DeferredBatch(seq=self._seq, cols=cols,
                             offsets=list(offsets), rows=n)
        self._seq += 1
        if self.spill is not None:
            self.spill.put_rows(
                cols, reason="shed",
                error="deferred by overload admission control (rung 3); "
                      "replayed in order on descent",
                batch_index=item.seq)
        self._deferred.append(item)
        self._m_shed.inc(n)
        self._m_pending.set(self.pending_rows)
        rec = self._recorder_fn()
        if rec is not None:
            rec.record_event("shed", rows=n, seq=item.seq,
                             deferred_batches=len(self._deferred))
        # deferral is the only activity at rung 3: evaluate on its
        # cadence, latency signal excluded (no batches finish to feed it)
        self._evaluate(include_latency=False)
        return item

    def want_replay(self) -> bool:
        """True when the loop's next unit of work is a deferred batch:
        either the ladder is draining (descent from rung 3), or the
        spill hit its memory cap — the head then replays through
        scoring to make room (order preserved: head first, new polls
        keep deferring behind the tail)."""
        if not self._deferred:
            return False
        return self._draining or len(self._deferred) >= self.max_deferred

    def next_replay(self) -> Optional[DeferredBatch]:
        item = self._deferred.popleft() if self._deferred else None
        if item is None:
            return None
        self._outstanding_replays += 1
        rec = self._recorder_fn()
        if rec is not None:
            rec.record_event("replay", rows=item.rows, seq=item.seq,
                             deferred_batches=len(self._deferred))
        return item

    def note_replayed(self, rows: int) -> None:
        """A replayed batch FINISHED scoring (counters must reflect
        state updates that actually landed, not dispatches)."""
        self._outstanding_replays = max(0, self._outstanding_replays - 1)
        self._m_replayed.inc(rows)
        self._m_pending.set(self.pending_rows)
        if (self._draining and not self._deferred
                and self._outstanding_replays == 0):
            # queue fully drained and landed: the 3 -> 2 descent
            self._transition(-1, 0.0, {"drained": 1.0})

    def finish_stream(self) -> None:
        """Source exhausted with batches still deferred: force-drain —
        the stream is ending and every polled row must be scored
        (``scored == polled`` at quiescence). Rung descent still runs
        through note_replayed, so counters stay exact."""
        if self._deferred or self._outstanding_replays:
            self._draining = True

    def deactivate(self) -> None:
        """End-of-run cleanup: revert every engine-side action so a
        later ``run()`` on this engine starts undegraded. Rung/counters
        are left as they stand — a stream that ENDED while degraded
        should say so in the registry, not cosmetically reset."""
        if self.rung >= 2:
            self.actions.degrade_emission(False)
            self.actions.force_max_batch(False)
        if self.rung >= 1:
            self.actions.shed_optional(False)
        if self.rung != 0:
            log.warning(
                "overload: stream ended at rung %d with %d deferred "
                "batch(es) pending (%s)", self.rung, len(self._deferred),
                "spilled durably" if self.spill is not None
                else "memory only — rely on checkpoint replay")

    # -- accounting --------------------------------------------------------

    @property
    def pending_rows(self) -> int:
        return int(self._m_shed.value - self._m_replayed.value)

    @property
    def deferred_batches(self) -> int:
        return len(self._deferred)

    def invariant(self) -> dict:
        """The no-silent-loss ledger, read from the REGISTRY (the same
        series an operator scrapes): at any quiescent point (no batch in
        flight), ``scored + deferred-pending == polled`` up to dedup
        (``rtfds_rows_total`` counts post-dedup rows; with unique tx_ids
        the identity is exact). Single-incarnation semantics: a
        supervisor restart re-polls replayed rows and re-scores them,
        inflating both sides consistently."""
        polled = self.reg.family_total("rtfds_source_rows_total") or 0.0
        scored = self.reg.family_total("rtfds_rows_total") or 0.0
        pending = float(self.pending_rows)
        return {
            "polled_rows": polled,
            "scored_rows": scored,
            "deferred_pending_rows": pending,
            "shed_rows": float(self._m_shed.value),
            "replayed_rows": float(self._m_replayed.value),
            "balanced": bool(scored + pending == polled),
        }
