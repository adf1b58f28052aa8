"""Metrics registry and flight recorder — the port's own copy of the core
of the JAX package's ``utils/metrics.py``.

- :class:`MetricsRegistry` — process-wide, thread-safe Counter / Gauge /
  Histogram registry (histograms on a fixed log-spaced latency ladder);
  :meth:`~MetricsRegistry.snapshot` renders it as JSON-able dicts.
- :class:`FlightRecorder` — an append-only JSONL record: one record per
  micro-batch plus events (checkpoints, faults, restarts, dead-letter
  writes) under a run manifest.

The layers that have no engine handle (the checkpointer, the fault
injectors, the recovery supervisor, the dead-letter sinks) report through
:func:`get_registry` and :func:`active_recorder`, under the metric names
the JAX package registers, so one dashboard reads either package. The
HTTP server and the Prometheus text rendering come with the serving extras
(ROADMAP A4b).
"""

from __future__ import annotations

import json
import os
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

# Fixed log-spaced latency ladder (1-2.5-5 per decade, 10µs .. 60s), so
# series from different runs line up bucket for bucket.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0,
)


class Counter:
    """Monotone float counter."""

    __slots__ = ("labels", "_v", "_lock")

    def __init__(self, labels: Dict[str, str]):
        self.labels = labels
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("labels", "_v", "_lock")

    def __init__(self, labels: Dict[str, str]):
        self.labels = labels
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._v += v

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed-bucket histogram (cumulative-``le`` semantics); percentiles
    interpolate linearly inside the owning bucket."""

    __slots__ = ("labels", "bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, labels: Dict[str, str],
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS_S):
        self.labels = labels
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le_bound, cumulative_count)] including (+Inf, total)."""
        out = []
        acc = 0
        with self._lock:
            counts = list(self._counts)
        for b, c in zip(self.bounds, counts):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]) in observed units."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        target = total * min(max(q, 0.0), 100.0) / 100.0
        acc = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo_acc = acc
            acc += c
            if acc >= target:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i] if i < len(self.bounds) else lo
                return lo + (hi - lo) * (target - lo_acc) / c
        return self.bounds[-1]


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe name → typed family → labeled series store.

    ``counter/gauge/histogram(name, help, **labels)`` is get-or-create;
    registering a name again as another type raises, and so does a
    histogram ladder that disagrees with its family's.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._meta: Dict[str, Tuple[str, str]] = {}  # name -> (type, help)
        self._series: Dict[str, Dict[Tuple, object]] = {}
        self._hist_buckets: Dict[str, Tuple[float, ...]] = {}

    def _get(self, typ: str, name: str, help_: str, labels: Dict[str, str],
             **kwargs):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            meta = self._meta.get(name)
            if meta is None:
                self._meta[name] = (typ, help_)
                self._series[name] = {}
            elif meta[0] != typ:
                raise ValueError(
                    f"metric {name!r} already registered as {meta[0]}, "
                    f"requested {typ}")
            elif help_ and not meta[1]:
                self._meta[name] = (typ, help_)
            if typ == "histogram":
                want = kwargs.pop("buckets", None)
                have = self._hist_buckets.get(name)
                if want is not None:
                    want = tuple(sorted(float(b) for b in want))
                    if have is not None and want != have:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {have}, requested {want}")
                kwargs["buckets"] = want or have or LATENCY_BUCKETS_S
                self._hist_buckets.setdefault(name, kwargs["buckets"])
            fam = self._series[name]
            m = fam.get(key)
            if m is None:
                m = _TYPES[typ]({k: str(v) for k, v in labels.items()},
                                **kwargs)
                fam[key] = m
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    def get(self, name: str, **labels):
        """An existing series or None (never creates)."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            return self._series.get(name, {}).get(key)

    def family_total(self, name: str) -> Optional[float]:
        """Sum of a counter or gauge family over all its label sets; None
        when the family was never registered (or is a histogram)."""
        with self._lock:
            fam = self._series.get(name)
            if fam is None:
                return None
            vals = [m.value for m in fam.values()
                    if not isinstance(m, Histogram)]
        if not vals:
            return None
        return float(sum(vals))

    def family_series(self, name: str) -> List[Tuple[Dict[str, str],
                                                     float]]:
        """``[(labels, value)]`` of a counter or gauge family."""
        with self._lock:
            fam = self._series.get(name)
            if fam is None:
                return []
            return [(dict(m.labels), m.value) for m in fam.values()
                    if not isinstance(m, Histogram)]

    def clear(self) -> None:
        """Drop every registered family (test isolation)."""
        with self._lock:
            self._meta.clear()
            self._series.clear()
            self._hist_buckets.clear()

    def snapshot(self) -> dict:
        """JSON-able snapshot of every family and series."""
        with self._lock:
            fams = [(name, *self._meta[name], list(fam.values()))
                    for name, fam in sorted(self._series.items())]
        out: Dict[str, dict] = {}
        for name, typ, help_, series in fams:
            rows = []
            for m in series:
                if isinstance(m, Histogram):
                    rows.append({
                        "labels": m.labels, "count": m.count, "sum": m.sum,
                        "buckets": [[b if b != float("inf") else "+Inf", c]
                                    for b, c in m.cumulative()],
                        "p50": m.percentile(50), "p99": m.percentile(99),
                    })
                else:
                    rows.append({"labels": m.labels, "value": m.value})
            out[name] = {"type": typ, "help": help_, "series": rows}
        return out


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every layer of the port reports into."""
    return _default_registry


class FlightRecorder:
    """Append-only JSONL log: a manifest line at every open (a segment
    marker), then ``{"kind": "batch", ...}`` records and ``{"kind":
    "event", "event": name, ...}`` records. Thread-safe; each write is a
    flushed line, so a crash loses at most the line being written.
    ``max_bytes`` rotates the file to ``<path>.1`` (one generation) when
    an append passes it; 0/None = unbounded."""

    def __init__(self, path: str, manifest: Optional[dict] = None,
                 max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = int(max_bytes) if max_bytes else 0
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")
        self.manifest = dict(manifest or {})
        self.manifest.setdefault("start_unix_s", time.time())
        if self._f.tell() > 0:
            # a previous writer died mid-line: start on a fresh line so
            # the torn tail spoils one record, not two
            with open(path, "rb") as rf:
                rf.seek(-1, 2)
                if rf.read(1) != b"\n":
                    self._f.write("\n")
                    self._f.flush()
        self._write({"kind": "manifest", **self.manifest})

    def _write(self, obj: dict) -> None:
        line = json.dumps(obj, separators=(",", ":"), default=str)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            if self.max_bytes and self._f.tell() > self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        rotated_bytes = self._f.tell()
        self._f.close()
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "a", encoding="utf-8")
        for obj in (
            {"kind": "manifest", **self.manifest},
            {"kind": "event", "t": time.time(), "event": "rotated",
             "previous": self.path + ".1",
             "previous_bytes": rotated_bytes},
        ):
            self._f.write(json.dumps(obj, separators=(",", ":"),
                                     default=str) + "\n")
        self._f.flush()

    def record_batch(self, batch_index: int, rows: int,
                     phases: Dict[str, float], queue_depth: int = 0,
                     **extra) -> None:
        self._write({
            "kind": "batch", "t": time.time(), "batch": int(batch_index),
            "rows": int(rows),
            "phases": {k: float(v) for k, v in phases.items()},
            "queue_depth": int(queue_depth), **extra,
        })

    def record_event(self, event: str, **fields) -> None:
        self._write({"kind": "event", "t": time.time(), "event": event,
                     **fields})

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    @staticmethod
    def read_segments(path: str) -> List[Tuple[Optional[dict], List[dict]]]:
        """The record as run segments ``[(manifest, records), ...]``;
        unparseable lines (a torn final write) are skipped."""
        segments: List[Tuple[Optional[dict], List[dict]]] = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if obj.get("kind") == "manifest":
                    segments.append((obj, []))
                else:
                    if not segments:
                        segments.append((None, []))
                    segments[-1][1].append(obj)
        return segments

    @staticmethod
    def read(path: str) -> Tuple[Optional[dict], List[dict]]:
        """The last run segment's (manifest, records)."""
        segments = FlightRecorder.read_segments(path)
        return segments[-1] if segments else (None, [])


_active_recorder: Optional[FlightRecorder] = None


def set_active_recorder(rec: Optional[FlightRecorder]) -> None:
    """Install the process-wide flight recorder (None removes it)."""
    global _active_recorder
    _active_recorder = rec


def active_recorder() -> Optional[FlightRecorder]:
    return _active_recorder
