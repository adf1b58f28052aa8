"""Metrics registry, flight recorder and HTTP endpoints — the port's own
copy of the JAX package's ``utils/metrics.py``.

- :class:`MetricsRegistry` — process-wide, thread-safe Counter / Gauge /
  Histogram registry (histograms on a fixed log-spaced latency ladder);
  :meth:`~MetricsRegistry.snapshot` renders it as JSON-able dicts and
  :meth:`~MetricsRegistry.render_prometheus` as the Prometheus text
  exposition format (:func:`render_snapshot_prometheus` does the same for
  a snapshot dict).
- :class:`FlightRecorder` — an append-only JSONL record: one record per
  micro-batch plus events (checkpoints, faults, restarts, dead-letter
  writes) under a run manifest (:func:`run_manifest`); the overload
  ladder's rung 1 samples the batch records
  (:meth:`~FlightRecorder.set_sample_every`).
- :class:`MetricsServer` — a stdlib background HTTP server: ``/metrics``,
  ``/metrics.json``, ``/healthz`` and ``/trace``.

The layers that have no engine handle (the checkpointer, the fault
injectors, the recovery supervisor, the dead-letter sinks) report through
:func:`get_registry` and :func:`active_recorder`, under the metric names
the JAX package registers, so one dashboard reads either package. The
sharded engine's per-shard ``/healthz`` fields are here (a fleet process
labels its shards with global ids, so the fleet's fields read as one
engine's), and :func:`merge_process_snapshots` merges the fleet's
per-process snapshots into the launcher's aggregated view.
"""

from __future__ import annotations

import dataclasses
import hashlib
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


def _fmt_num(v: float) -> str:
    """Prometheus sample and ``le`` formatting: the shortest exact repr."""
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


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

    def _families(self):
        with self._lock:
            return [(name, *self._meta[name], list(fam.values()))
                    for name, fam in sorted(self._series.items())]

    def snapshot(self) -> dict:
        """JSON-able snapshot of every family and series."""
        out: Dict[str, dict] = {}
        for name, typ, help_, series in self._families():
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

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name, typ, help_, series in self._families():
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            for m in series:
                if isinstance(m, Histogram):
                    for b, c in m.cumulative():
                        lab = dict(m.labels)
                        lab["le"] = _fmt_num(b)
                        lines.append(f"{name}_bucket{_label_str(lab)} {c}")
                    ls = _label_str(m.labels)
                    lines.append(f"{name}_sum{ls} {_fmt_num(m.sum)}")
                    lines.append(f"{name}_count{ls} {m.count}")
                else:
                    lines.append(
                        f"{name}{_label_str(m.labels)} {_fmt_num(m.value)}")
        return "\n".join(lines) + "\n"


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every layer of the port reports into."""
    return _default_registry


def merge_process_snapshots(snaps: Dict[str, dict]) -> dict:
    """Per-process registry snapshots (``/metrics.json`` payloads, keyed
    by process id) → one fleet snapshot, the launcher's ``/metrics``
    view. Every series gains a ``process=<pid>`` label unless the worker
    stamped one (the sharded engine labels its per-shard series itself,
    with global shard ids). Values are never summed: the view only makes
    the per-process series distinguishable."""
    out: Dict[str, dict] = {}
    for pid, snap in sorted(snaps.items(), key=lambda kv: str(kv[0])):
        for name, fam in (snap or {}).items():
            dst = out.setdefault(name, {
                "type": fam.get("type"), "help": fam.get("help"),
                "series": []})
            for row in fam.get("series", []):
                labels = dict(row.get("labels") or {})
                labels.setdefault("process", str(pid))
                dst["series"].append({**row, "labels": labels})
    return out


def render_snapshot_prometheus(snap: dict) -> str:
    """Prometheus text for a snapshot dict (``/metrics.json``'s content),
    in :meth:`MetricsRegistry.render_prometheus`'s format: histograms are
    expanded again from their snapshot bucket rows."""
    lines: List[str] = []
    for name in sorted(snap):
        fam = snap[name]
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam.get('type', 'gauge')}")
        for row in fam.get("series", []):
            labels = dict(row.get("labels") or {})
            if "buckets" in row:
                for b, c in row["buckets"]:
                    lab = dict(labels)
                    lab["le"] = (str(b) if isinstance(b, str)
                                 else _fmt_num(float(b)))
                    lines.append(f"{name}_bucket{_label_str(lab)} {c}")
                ls = _label_str(labels)
                lines.append(f"{name}_sum{ls} {_fmt_num(float(row['sum']))}")
                lines.append(f"{name}_count{ls} {row['count']}")
            else:
                lines.append(f"{name}{_label_str(labels)} "
                             f"{_fmt_num(float(row['value']))}")
    return "\n".join(lines) + "\n"


def run_manifest(cfg=None, model_kind: str = "", **extra) -> dict:
    """The flight record's manifest: what a reader needs to interpret the
    batch records later (the model kind, the start time, a hash of the
    config, the backend and its device count). ``backend`` is ``cuda``
    when the process sees a card, else ``cpu``; a caller that serves on
    another device than that passes ``backend=`` itself. torch is imported
    here, so the module itself stays stdlib-only."""
    man = {"model_kind": model_kind, "start_unix_s": time.time(), **extra}
    if cfg is not None:
        try:
            blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True,
                              default=str)
        except TypeError:
            blob = repr(cfg)
        man["config_hash"] = hashlib.sha256(blob.encode()).hexdigest()[:16]
    import torch

    cuda = torch.cuda.is_available()
    man.setdefault("backend", "cuda" if cuda else "cpu")
    man.setdefault("n_devices", torch.cuda.device_count() if cuda else 1)
    return man


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
        # overload rung 1 records every k-th batch (events always land)
        self._sample_every = 1
        self._batch_tick = 0
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

    def set_sample_every(self, k: int) -> None:
        """Record every ``k``-th batch record from now on (1 = every
        batch): overload rung 1 thins the per-batch bulk. Events (rung
        transitions, shed and replay, faults) are never sampled out."""
        with self._lock:
            self._sample_every = max(1, int(k))
            self._batch_tick = 0

    def record_batch(self, batch_index: int, rows: int,
                     phases: Dict[str, float], queue_depth: int = 0,
                     **extra) -> None:
        with self._lock:
            self._batch_tick += 1
            if self._sample_every > 1 \
                    and self._batch_tick % self._sample_every != 1:
                return
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


class MetricsServer:
    """A stdlib background HTTP server: ``/metrics`` (Prometheus text),
    ``/metrics.json`` (the snapshot), ``/healthz`` and ``/trace`` (the
    process tracer's span ring as Chrome-trace JSON, for ui.perfetto.dev).

    ``/healthz`` answers 200 while the serving loop makes progress: the
    age of the last finished batch (now − ``rtfds_last_batch_unix_seconds``)
    is within ``max_batch_age_s`` (before the first batch the check
    passes), and the source backlog (``rtfds_source_lag_rows``) is within
    ``max_source_lag_rows`` when one is set; else 503. The body carries the
    JAX package's blocks for every subsystem the port has — restarts,
    crash loops and dead letters, the checkpoint plane, the feature cache,
    the tiered store and its cold tier, the device plane, the learning
    plane, the overload ladder — each only once its series exist, and a
    ``status``: ``ok``, ``unhealthy`` (503) or ``degraded`` (200: rows
    wait in the dead-letter queue or the overload spill, a rung is
    active, or serving runs off a fallback restore).

    ``port=0`` binds an ephemeral port; :meth:`start` sets ``self.port``.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 max_batch_age_s: float = 300.0,
                 max_source_lag_rows: Optional[float] = None):
        self.host = host
        self.port = int(port)
        self.registry = registry if registry is not None else get_registry()
        self.max_batch_age_s = float(max_batch_age_s)
        self.max_source_lag_rows = max_source_lag_rows
        self._httpd = None
        self._thread = None

    def health(self) -> Tuple[bool, dict]:
        reg = self.registry
        checks: Dict[str, dict] = {}
        ok = True
        last = reg.get("rtfds_last_batch_unix_seconds")
        if last is not None and last.value > 0:
            # wall clock on both ends: any process may ask
            age = time.time() - last.value
            good = age <= self.max_batch_age_s
            checks["last_batch_age_s"] = {
                "value": round(age, 3), "max": self.max_batch_age_s,
                "ok": good}
            ok = ok and good
        else:
            checks["last_batch_age_s"] = {"value": None, "ok": True,
                                          "note": "no batches yet"}
        lag = reg.get("rtfds_source_lag_rows")
        if lag is not None and self.max_source_lag_rows is not None:
            good = lag.value <= self.max_source_lag_rows
            checks["source_lag_rows"] = {
                "value": lag.value, "max": self.max_source_lag_rows,
                "ok": good}
            ok = ok and good
        elif lag is not None:
            checks["source_lag_rows"] = {"value": lag.value, "ok": True,
                                         "note": "no threshold set"}
        last_ck = reg.get("rtfds_last_checkpoint_unix_seconds")
        if last_ck is not None and last_ck.value > 0:
            checks["last_checkpoint_age_s"] = {
                "value": round(time.time() - last_ck.value, 3), "ok": True}
        extras: Dict[str, object] = {}
        for fam, key in (("rtfds_engine_restarts_total", "restarts"),
                         ("rtfds_crash_loops_total", "crash_loops"),
                         ("rtfds_dead_letter_rows", "dead_letter_rows"),
                         ("rtfds_checkpoint_corrupt_total",
                          "checkpoint_corrupt_total"),
                         ("rtfds_checkpoint_fallbacks_total",
                          "checkpoint_fallbacks"),
                         ("rtfds_checkpoint_lineage_depth",
                          "checkpoint_lineage_depth")):
            v = reg.family_total(fam)
            if v is not None:
                extras[key] = v
        cache = self._feature_cache()
        if cache is not None:
            extras["feature_cache"] = cache
        fstate = self._feature_state()
        if fstate is not None:
            extras["feature_state"] = fstate
        active_z = None
        for mode in ("f32", "bf16", "int8"):
            g = reg.get("rtfds_z_mode", mode=mode)
            if g is not None and g.value > 0:
                active_z = mode
        if active_z is not None:
            device_plane: Dict[str, object] = {"z_mode": active_z}
            up = reg.get("rtfds_use_pallas")
            if up is not None:
                device_plane["use_pallas"] = bool(up.value)
            extras["device_plane"] = device_plane
        learning = self._learning()
        if learning is not None:
            extras["learning"] = learning
        rung = reg.get("rtfds_overload_rung")
        if rung is not None:
            overload: Dict[str, float] = {"rung": rung.value}
            pend = reg.get("rtfds_shed_pending_rows")
            if pend is not None:
                overload["shed_rows_pending_replay"] = pend.value
            for fam, key in (("rtfds_shed_rows_total", "shed_rows"),
                             ("rtfds_shed_replayed_rows_total",
                              "replayed_rows"),
                             ("rtfds_overload_transitions_total",
                              "transitions")):
                v = reg.family_total(fam)
                if v is not None:
                    overload[key] = v
            trend = reg.get("rtfds_source_lag_trend_rows_per_s")
            if trend is not None:
                overload["lag_trend_rows_per_s"] = trend.value
            extras["overload"] = overload
        status = "ok" if ok else "unhealthy"
        if ok and rung is not None and (
                rung.value > 0
                or extras["overload"].get("shed_rows_pending_replay", 0) > 0):
            status = "degraded"
        if ok and extras.get("dead_letter_rows", 0) > 0:
            status = "degraded"
        fb = reg.get("rtfds_checkpoint_serving_fallback")
        if ok and fb is not None and fb.value > 0:
            status = "degraded"
            extras["serving_off_fallback_restore"] = True
        return ok, {"healthy": ok, "status": status, "checks": checks,
                    **extras}

    def _feature_cache(self) -> Optional[dict]:
        """The feedback feature cache's hit rate: labels whose rows missed
        the cache are dropped, so an operator must see it."""
        reg = self.registry
        c_hit = reg.get("rtfds_feature_cache_lookups_total", outcome="hit")
        c_miss = reg.get("rtfds_feature_cache_lookups_total",
                         outcome="miss")
        if c_hit is None and c_miss is None:
            return None
        hits = c_hit.value if c_hit is not None else 0.0
        misses = c_miss.value if c_miss is not None else 0.0
        total = hits + misses
        cache: Dict[str, float] = {
            "hit_rate": round(hits / total, 4) if total else 1.0,
            "lookups": total}
        occ = reg.get("rtfds_feature_cache_occupancy")
        cap = reg.get("rtfds_feature_cache_capacity")
        if occ is not None:
            cache["occupancy"] = occ.value
        if cap is not None:
            cache["capacity"] = cap.value
        ev = reg.family_total("rtfds_feature_cache_evictions_total")
        if ev is not None:
            cache["evictions"] = ev
        return cache

    def _feature_state(self) -> Optional[dict]:
        """The tiered store (``key_mode="exact"``): occupancy, reclaims,
        the dense hit rate, bytes against the budget, the cold tier."""
        reg = self.registry
        occ_tables: Dict[str, float] = {}
        for table in ("customer", "terminal"):
            g = reg.get("rtfds_feature_slots_occupied", table=table)
            if g is not None:
                occ_tables[table] = g.value
        if not occ_tables:
            return None
        fstate: Dict[str, object] = {"slots_occupied": occ_tables}
        # the table-level series only: the sharded engine's shard-labelled
        # rows break the same totals down
        rec_rows = [v for labels, v in reg.family_series(
            "rtfds_feature_slots_reclaimed_total") if "shard" not in labels]
        if rec_rows:
            fstate["slots_reclaimed"] = float(sum(rec_rows))
        # per shard (the sharded engine): occupancy summed over tables,
        # the worst shard, and each shard's tier reads
        shard_occ: Dict[str, float] = {}
        for labels, v in reg.family_series("rtfds_feature_slots_occupied"):
            if "shard" in labels:
                shard_occ[labels["shard"]] = (
                    shard_occ.get(labels["shard"], 0.0) + v)
        if shard_occ:
            fstate["slots_occupied_per_shard"] = {
                sh: shard_occ[sh] for sh in sorted(shard_occ, key=int)}
            worst = max(shard_occ, key=lambda sh: shard_occ[sh])
            fstate["worst_shard"] = {"shard": int(worst),
                                     "occupied": shard_occ[worst]}
            shard_tiers: Dict[str, Dict[str, float]] = {}
            for labels, v in reg.family_series(
                    "rtfds_feature_tier_rows_total"):
                if "shard" in labels:
                    shard_tiers.setdefault(labels["shard"], {})[
                        labels.get("tier", "?")] = v
            if shard_tiers:
                fstate["tier_rows_per_shard"] = {
                    sh: shard_tiers[sh] for sh in sorted(shard_tiers,
                                                         key=int)}
        dense = reg.get("rtfds_feature_tier_rows_total", tier="dense")
        cms_t = reg.get("rtfds_feature_tier_rows_total", tier="cms")
        if dense is not None or cms_t is not None:
            d = dense.value if dense is not None else 0.0
            c = cms_t.value if cms_t is not None else 0.0
            fstate["tier_rows"] = {"dense": d, "cms": c}
            total = d + c
            fstate["dense_hit_rate"] = round(d / total, 4) if total else 1.0
        sb = reg.get("rtfds_feature_state_bytes", tier="total")
        if sb is not None:
            fstate["state_bytes"] = sb.value
            budget = reg.get("rtfds_feature_state_budget_bytes")
            if budget is not None and budget.value > 0:
                fstate["budget_bytes"] = budget.value
                fstate["budget_used"] = round(sb.value / budget.value, 4)
        ck = reg.get("rtfds_feature_cold_keys")
        if ck is not None:
            cold: Dict[str, float] = {"keys": ck.value}
            for name, key in (
                    ("rtfds_feature_cold_bytes", "bytes"),
                    ("rtfds_feature_cold_promotions_total", "promotions"),
                    ("rtfds_feature_cold_demotions_total", "demotions"),
                    ("rtfds_feature_cold_promote_wait_seconds_total",
                     "promote_wait_seconds"),
                    ("rtfds_feature_cold_promote_backlog",
                     "promote_backlog"),
                    ("rtfds_feature_cold_promote_queue_limit",
                     "promote_queue_limit")):
                m = reg.get(name)
                if m is not None:
                    cold[key] = m.value
            fstate["cold"] = cold
        return fstate

    def _learning(self) -> Optional[dict]:
        """Which versions serve and shadow, promotions and rollbacks."""
        reg = self.registry
        champ = reg.get("rtfds_model_version", role="champion")
        if champ is None:
            return None
        learning: Dict[str, float] = {"champion_version": champ.value}
        cand = reg.get("rtfds_model_version", role="candidate")
        if cand is not None:
            learning["candidate_version"] = cand.value
        # promotions and refusals are outcomes of one family: never summed
        for outcome, key in (("promoted", "promotions"),
                             ("refused_corrupt", "refusals")):
            m = reg.get("rtfds_model_promotions_total", outcome=outcome)
            if m is not None:
                learning[key] = m.value
        for fam, key in (("rtfds_model_rollbacks_total", "rollbacks"),
                         ("rtfds_shadow_divergence_total",
                          "shadow_divergence"),
                         ("rtfds_model_artifact_corrupt_total",
                          "model_artifact_corrupt")):
            v = reg.family_total(fam)
            if v is not None:
                learning[key] = v
        return learning

    def start(self) -> "MetricsServer":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler's name)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(
                            200, server.registry.render_prometheus().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/metrics.json":
                        self._send(
                            200,
                            json.dumps(server.registry.snapshot()).encode(),
                            "application/json")
                    elif path == "/healthz":
                        ok, body = server.health()
                        self._send(200 if ok else 503,
                                   json.dumps(body).encode(),
                                   "application/json")
                    elif path == "/trace":
                        # imported here: the trace module imports this one
                        from real_time_fraud_detection_system_tpu_torch \
                            .utils.trace import get_tracer

                        self._send(
                            200,
                            json.dumps(get_tracer().export_chrome()).encode(),
                            "application/json")
                    else:
                        self._send(404, b'{"error":"not found"}',
                                   "application/json")
                except BrokenPipeError:  # the client went away mid-write
                    pass

            def log_message(self, *a):  # scrapes are not log news
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="metrics-server")
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
