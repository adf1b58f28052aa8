"""The elastic fleet's policy plane — port of the JAX package's
``runtime/elastic.py``: the autoscaler's decision logic, the resize state
machine and the committed-topology manifest, everything the launcher's
resize loop (``tools/multihost_launcher.py --autoscale``) needs, testable
without spawning a process.

- :class:`ElasticPolicy` decides WHETHER to resize from the fleet's
  signals (the worst process's overload rung, the lag trend, the shed
  backlog), with the overload ladder's discipline: a condition must hold
  for its dwell, a cooldown follows every resize, and a dead band
  separates grow from shrink.
- :class:`ResizeFsm` walks every resize ``steady → draining →
  retopologizing → committing → relaunching → steady``; any fault in the
  window rolls back through ``rolling_back`` to the pre-resize topology.
  Transitions are validated: a half-resized fleet is a programming
  error, never a state.
- :func:`store_topology` / :func:`load_topology` keep the committed
  topology as one atomically replaced manifest; a torn write quarantines
  itself and reads as None.

The fleet series (:func:`fleet_metrics`) take the names the JAX package
registers.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    get_registry,
)

# -- resize state machine ---------------------------------------------------

STEADY = "steady"
DRAINING = "draining"
RETOPOLOGIZING = "retopologizing"
COMMITTING = "committing"
RELAUNCHING = "relaunching"
ROLLING_BACK = "rolling_back"

# Every legal phase edge. Any mid-resize phase may divert to
# ROLLING_BACK (the chaos path); completion closes back to STEADY.
_TRANSITIONS = {
    STEADY: {DRAINING},
    DRAINING: {RETOPOLOGIZING, ROLLING_BACK},
    RETOPOLOGIZING: {COMMITTING, ROLLING_BACK},
    COMMITTING: {RELAUNCHING, ROLLING_BACK},
    RELAUNCHING: {STEADY, ROLLING_BACK},
    ROLLING_BACK: {STEADY},
}


class ResizeFsmError(RuntimeError):
    """An illegal resize-phase transition was attempted — the launcher
    logic, not the fleet, is broken; fail loudly instead of serving a
    half-resized topology."""


class ResizeFsm:
    """The resize window's explicit state machine. One instance per
    launcher; phases advance via :meth:`to` (validated), faults divert
    via :meth:`rollback`, and every transition lands in the journal
    callback so a crashed launcher's recovery can read how far the
    resize got."""

    def __init__(self, journal=None):
        self.phase = STEADY
        self._journal = journal  # callable(phase_record: dict) | None

    def to(self, phase: str, **info) -> None:
        if phase not in _TRANSITIONS.get(self.phase, ()):
            raise ResizeFsmError(
                f"illegal resize transition {self.phase} -> {phase}")
        self.phase = phase
        if self._journal is not None:
            self._journal({"phase": phase, **info})

    def rollback(self, **info) -> None:
        """Divert to ROLLING_BACK from any mid-resize phase."""
        if self.phase in (STEADY, ROLLING_BACK):
            raise ResizeFsmError(
                f"rollback from {self.phase} is not a resize fault")
        self.to(ROLLING_BACK, **info)

    @property
    def mid_resize(self) -> bool:
        return self.phase != STEADY


# -- policy -----------------------------------------------------------------


@dataclass
class ElasticConfig:
    """Autoscaler policy knobs (the launcher's ``--autoscale-*`` flags).

    Grow fires after the worst process has held rung >= ``grow_rung``
    for ``grow_dwell_s`` seconds; shrink after the fleet has been fully
    idle (rung 0, non-positive lag trend, zero shed backlog) for
    ``shrink_dwell_s``. ``cooldown_s`` blocks BOTH directions after any
    resize (completed or rolled back) so a rollback cannot flap straight
    into a retry storm. Targets double/halve, clamped to
    [min_processes, max_processes] — the resize itself is expensive
    (drain + merge + relaunch), so each one should buy a capacity
    octave."""

    min_processes: int = 1
    max_processes: int = 4
    grow_rung: int = 2
    grow_dwell_s: float = 2.0
    shrink_dwell_s: float = 10.0
    cooldown_s: float = 5.0

    def __post_init__(self):
        if self.min_processes < 1:
            raise ValueError(
                f"min_processes must be >= 1, got {self.min_processes}")
        if self.max_processes < self.min_processes:
            raise ValueError(
                f"max_processes {self.max_processes} < min_processes "
                f"{self.min_processes}")
        if not 1 <= self.grow_rung <= 3:
            raise ValueError(
                f"grow_rung must be in [1, 3], got {self.grow_rung}")
        if min(self.grow_dwell_s, self.shrink_dwell_s,
               self.cooldown_s) < 0:
            raise ValueError("dwell/cooldown seconds must be >= 0")


@dataclass
class ClusterSignals:
    """One poll of the aggregated fleet view (``/cluster`` + merged
    worker registries) — the policy's entire input."""

    worst_rung: int = 0
    lag_trend_rows_per_s: float = 0.0
    shed_pending_rows: float = 0.0
    worst_pressure: float = 0.0
    alive: int = 0


@dataclass
class ResizeDecision:
    direction: str  # "grow" | "shrink"
    target: int
    reason: str


class ElasticPolicy:
    """Sustained-pressure grow / sustained-idle shrink, with the overload
    ladder's flap-proofing: a condition must HOLD for its dwell (any
    contrary observation resets the streak), a dead band separates the
    two conditions (rung 1, or draining backlogs, arms neither), and a
    cooldown after every resize absorbs the relaunch transient."""

    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg
        self._grow_since: Optional[float] = None
        self._shrink_since: Optional[float] = None
        self._cooldown_until = 0.0

    def note_resized(self, now: float) -> None:
        """A resize just finished (completed OR rolled back): reset the
        streaks and start the cooldown."""
        self._grow_since = None
        self._shrink_since = None
        self._cooldown_until = now + self.cfg.cooldown_s

    def observe(self, sig: ClusterSignals, n_processes: int,
                now: float) -> Optional[ResizeDecision]:
        """Feed one signals poll; returns a decision when a dwell
        completes, else None. ``now`` is caller-supplied monotonic time
        so tests drive the clock."""
        cfg = self.cfg
        grow_cond = sig.worst_rung >= cfg.grow_rung
        # Idle means nothing is owed AND every process says so: rung 0
        # everywhere, the backlog is not growing, no shed rows await
        # replay, and every worker's registry was actually scraped — a
        # worker that is still warming up (or unreachable) is not
        # provably idle, and shrinking on blindness would drain a fleet
        # that never got to serve. Shrinking while rows are deferred
        # would merge them into a smaller fleet that just proved it
        # cannot keep up.
        shrink_cond = (sig.alive >= n_processes
                       and sig.worst_rung == 0
                       and sig.lag_trend_rows_per_s <= 0.0
                       and sig.shed_pending_rows <= 0.0)
        if not grow_cond:
            self._grow_since = None
        if not shrink_cond:
            self._shrink_since = None
        if now < self._cooldown_until:
            return None
        if grow_cond and n_processes < cfg.max_processes:
            if self._grow_since is None:
                self._grow_since = now
            if now - self._grow_since >= cfg.grow_dwell_s:
                target = min(cfg.max_processes, n_processes * 2)
                return ResizeDecision(
                    "grow", target,
                    f"rung {sig.worst_rung} sustained "
                    f"{cfg.grow_dwell_s:g}s (pressure "
                    f"{sig.worst_pressure:.2f}, lag trend "
                    f"{sig.lag_trend_rows_per_s:+.0f} rows/s)")
        if shrink_cond and n_processes > cfg.min_processes:
            if self._shrink_since is None:
                self._shrink_since = now
            if now - self._shrink_since >= cfg.shrink_dwell_s:
                target = max(cfg.min_processes, n_processes // 2)
                return ResizeDecision(
                    "shrink", target,
                    f"idle {cfg.shrink_dwell_s:g}s (rung 0, lag trend "
                    f"{sig.lag_trend_rows_per_s:+.0f} rows/s, no shed "
                    "backlog)")
        return None


# -- signal extraction ------------------------------------------------------


def _series_values(snap: dict, name: str):
    fam = (snap or {}).get(name)
    if not fam:
        return
    for row in fam.get("series", []):
        v = row.get("value")
        if v is not None:
            yield float(v)


def signals_from_snapshots(snaps: Dict[str, dict]) -> ClusterSignals:
    """Distill per-worker registry snapshots (``/metrics.json`` payloads
    keyed by process id) into the policy's :class:`ClusterSignals`.
    Worst-process semantics for rung/pressure (the slowest process gates
    the fleet), max for the lag trend (the worst backlog slope), sum for
    the shed backlog (rows owed are owed by the FLEET)."""

    sig = ClusterSignals(alive=len(snaps))
    for snap in snaps.values():
        sig.worst_rung = max(sig.worst_rung, int(max(
            _series_values(snap, "rtfds_overload_rung"), default=0)))
        sig.worst_pressure = max(sig.worst_pressure, max(
            _series_values(snap, "rtfds_overload_pressure"), default=0.0))
        sig.lag_trend_rows_per_s = max(
            sig.lag_trend_rows_per_s,
            max(_series_values(snap,
                               "rtfds_source_lag_trend_rows_per_s"),
                default=0.0))
        sig.shed_pending_rows += sum(
            _series_values(snap, "rtfds_shed_pending_rows"))
    return sig


# -- committed topology manifest --------------------------------------------


def store_topology(path: str, manifest: dict) -> None:
    """Atomically commit the fleet's topology manifest: tmp + fsync +
    rename, then a read-back verify. Until the rename lands, readers see
    the previous committed topology — the commit point of every resize.
    Raises ``OSError``/``ValueError`` when the write cannot be proven
    durable (the caller rolls back)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    data = json.dumps(manifest, sort_keys=True).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    back = load_topology(path)
    if back != manifest:
        raise ValueError(
            f"topology manifest at {path} failed read-back verification")


def load_topology(path: str) -> Optional[dict]:
    """Read the committed topology. A torn/unparsable manifest is
    QUARANTINED (renamed aside as evidence, like a corrupt checkpoint)
    and reads as None — the caller falls back to its previous known
    topology instead of trusting garbage."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    try:
        man = json.loads(raw.decode("utf-8"))
        if not isinstance(man, dict):
            raise ValueError("topology manifest is not an object")
        return man
    except (ValueError, UnicodeDecodeError):
        try:
            os.replace(path, path + f".torn-{int(time.time() * 1e3)}")
        except OSError:
            pass
        return None


# -- fleet metrics ----------------------------------------------------------


@dataclass
class FleetMetrics:
    """Handles for the elastic-fleet registry family — registered in the
    LAUNCHER's registry (merged into the ``/cluster`` aggregation view
    as the ``launcher`` process), and in tests' registries directly."""

    fleet_size: object = field(default=None)
    resize_pending: object = field(default=None)
    resize_seconds: object = field(default=None)
    spike_absorb: object = field(default=None)
    _registry: object = field(default=None)

    def resizes_total(self, direction: str, outcome: str):
        return self._registry.counter(
            "rtfds_fleet_resizes_total",
            "fleet resizes by direction and outcome (completed = new "
            "topology committed and serving; rolled_back = a resize-"
            "window fault restored the pre-resize fleet)",
            direction=direction, outcome=outcome)


def fleet_metrics(registry=None) -> FleetMetrics:
    reg = registry if registry is not None else get_registry()
    m = FleetMetrics(_registry=reg)
    m.fleet_size = reg.gauge(
        "rtfds_fleet_size",
        "serving processes in the current committed topology")
    m.resize_pending = reg.gauge(
        "rtfds_resize_pending",
        "1 while a resize is in flight (drain -> retopologize -> "
        "commit -> relaunch window); 0 in steady state")
    m.resize_seconds = reg.histogram(
        "rtfds_resize_seconds",
        "wall time of one fleet resize, drain start to new fleet "
        "serving (or rollback landed)")
    m.spike_absorb = reg.gauge(
        "rtfds_spike_absorb_seconds",
        "time from spike detection (worst rung first >= grow rung) to "
        "the worst rung back <= 1 on the resized fleet")
    return m
