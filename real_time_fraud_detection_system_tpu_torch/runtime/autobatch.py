"""Adaptive micro-batch controller — port of the JAX package's
``runtime/autobatch.py``: the coalesce target as a feedback loop.

The engine feeds the controller each finished batch's rows and latency,
and the controller moves the coalesce target BETWEEN the configured
``runtime.batch_buckets`` — never to an unbucketed size, so every target
it can pick is a signature of ``ScoringEngine.dispatch_inventory()`` (a
captured CUDA graph under ``runtime.precompile``).

Two objectives, picked by configuration:

- **Latency SLO** (``latency_slo_ms > 0``): hold the windowed p50
  micro-batch latency at or under the target. Above the SLO → step down
  one bucket; comfortably under (``headroom`` × SLO) → step up one.
- **Throughput** (no SLO): hill-climb rows/s over the bucket ladder.
  Each bucket's observed rows/s is tracked as an EMA; unexplored
  neighbors are tried first, then the controller moves only for a
  meaningfully better estimate (``improve`` factor).

Decisions happen every ``decide_every`` observed ON-TARGET batches: each
observation is attributed to the bucket its rows actually padded to, so
in-flight stragglers assembled at a previous target (pipeline depth > 1)
and undersized tail polls update THEIR bucket's EMA and never count
toward the decision window. The current target rides
``rtfds_autobatch_target_rows``; every move counts in
``rtfds_autobatch_adjustments_total{direction}``. The decisions are the
JAX controller's on the same inputs (``tests/test_torch_overload.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
    get_registry,
)


def _p50(values) -> float:
    s = sorted(values)
    return s[len(s) // 2] if s else 0.0


class AutoBatchController:
    """Feedback controller over the bucket ladder.

    The engine calls :meth:`observe` once per finished batch and
    :meth:`target_rows` once per assembly pass; both are O(1) (one deque
    append / one list index) — hot-loop safe.
    """

    def __init__(
        self,
        buckets: Sequence[int],
        latency_slo_ms: float = 0.0,
        decide_every: int = 8,
        headroom: float = 0.6,
        improve: float = 1.05,
        ema_alpha: float = 0.5,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.buckets = sorted({int(b) for b in buckets})
        if not self.buckets:
            raise ValueError("autobatch needs at least one batch bucket")
        self.slo_s = max(0.0, float(latency_slo_ms)) / 1e3
        self.decide_every = max(1, int(decide_every))
        self.headroom = float(headroom)
        self.improve = float(improve)
        self.ema_alpha = float(ema_alpha)
        # SLO mode starts at the smallest bucket (meet the target first,
        # then grow into the budget); throughput mode starts at the
        # largest (per-batch fixed costs amortize best there, and the
        # climb explores downward if the estimate disagrees).
        self._i = 0 if self.slo_s > 0 else len(self.buckets) - 1
        self._window: list = []  # (rows, latency_s) at the CURRENT target
        self._rate_ema = {}  # bucket -> EMA rows/s
        self.adjustments = 0
        # Overload rung-2 override (runtime/overload.py): while forced,
        # the target is pinned to the largest bucket and the decision
        # loop is suspended — the ladder, not the SLO follower, owns the
        # batching policy under overload (the SLO is already blown; the
        # follower would fight the ladder by stepping DOWN).
        self._forced = False
        reg = registry if registry is not None else get_registry()
        self._m_target = reg.gauge(
            "rtfds_autobatch_target_rows",
            "current adaptive coalesce target (rows)")
        self._m_adjust = {
            d: reg.counter(
                "rtfds_autobatch_adjustments_total",
                "bucket-ladder moves by the adaptive batch controller",
                direction=d)
            for d in ("up", "down")
        }
        self._m_target.set(self.target_rows())

    # -- engine-facing API -------------------------------------------------

    def target_rows(self) -> int:
        """The coalesce target the next assembly pass should aim for."""
        return self.buckets[self._i]

    def force_max(self) -> None:
        """Pin the target to the LARGEST bucket (overload rung 2): the
        per-batch fixed costs amortize best there, and every dispatch
        stays inside the precompiled inventory. The move counts in
        the adjustment metrics like any other; decisions stay suspended
        until :meth:`release_force`."""
        if self._forced:
            return
        self._forced = True
        self._window = []
        self._move(len(self.buckets) - 1 - self._i)

    def release_force(self) -> None:
        """Resume adaptive control from the largest bucket (the ladder
        descends one rung at a time, so the follower re-explores from
        where overload left it rather than snapping back)."""
        self._forced = False
        self._window = []

    def _bucket_for(self, rows: int) -> int:
        """The bucket ``rows`` actually padded to (smallest bucket
        that fits; largest when none does) — the batch's OWN bucket, not
        the current target."""
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def observe(self, rows: int, latency_s: float) -> None:
        """Feed one finished batch; may move the target (every
        ``decide_every`` on-target observations).

        Observations are attributed to the batch's OWN bucket: with
        ``pipeline_depth`` > 1, batches assembled at the PREVIOUS target
        are still landing after a move (and tail polls run smaller than
        any target) — crediting them to the current target would pollute
        its EMA and re-trigger SLO moves off stale latencies."""
        if rows <= 0:
            return
        b = self._bucket_for(int(rows))
        if latency_s > 0:
            rate = rows / latency_s
            prev = self._rate_ema.get(b)
            self._rate_ema[b] = rate if prev is None else (
                self.ema_alpha * rate + (1 - self.ema_alpha) * prev)
        if self._forced:
            return  # overload rung 2 owns the target; EMAs stay fresh
        if b != self.target_rows():
            return  # in-flight stragglers from an older target / tails
        self._window.append((int(rows), float(latency_s)))
        if len(self._window) >= self.decide_every:
            self._decide()
            self._window = []

    # -- decision logic ----------------------------------------------------

    def _move(self, di: int) -> None:
        j = min(max(self._i + di, 0), len(self.buckets) - 1)
        if j == self._i:
            return
        self._m_adjust["up" if j > self._i else "down"].inc()
        self.adjustments += 1
        self._i = j
        self._m_target.set(self.target_rows())

    def _decide(self) -> None:
        if self.slo_s > 0:
            p50 = _p50([lat for _, lat in self._window])
            if p50 > self.slo_s:
                self._move(-1)
            elif p50 < self.headroom * self.slo_s:
                self._move(+1)
            return
        # throughput mode: explore unmeasured neighbors first, then move
        # only for a meaningfully better rows/s estimate
        cur = self._rate_ema.get(self.target_rows(), 0.0)
        for di in (+1, -1):
            j = self._i + di
            if 0 <= j < len(self.buckets) \
                    and self.buckets[j] not in self._rate_ema:
                self._move(di)
                return
        best_di, best_rate = 0, cur * self.improve
        for di in (+1, -1):
            j = self._i + di
            if 0 <= j < len(self.buckets):
                r = self._rate_ema.get(self.buckets[j], 0.0)
                if r > best_rate:
                    best_di, best_rate = di, r
        if best_di:
            self._move(best_di)
