"""Per-batch trace spans with Chrome-trace export — port of the JAX
package's ``utils/trace.py``.

The metrics registry answers how long each phase takes in aggregate; this
module answers what happened inside one batch. Every phase of a
micro-batch becomes a named span under that batch's trace id, completed
spans land in a bounded ring buffer, and the buffer exports as
Chrome-trace JSON (Perfetto, ``chrome://tracing``).

**Parents.** The tracer keeps a stack of open spans per thread: a span
records the span open on its thread when it began as its parent (a span
with no batch of its own takes its parent's). The engine's five stages
are the roots; their parts are children named ``<stage>/<part>``
(``host_prep/dedup``, ``dispatch/replay``, ``result_wait/fetch_wait``,
``sink_write/convert``, ...). A span opened on a thread with no open
span and no batch of its own takes the current batch; a caller off the
loop's thread (an async sink's writer) passes ``batch=""`` instead, as
the current batch is a later one. A span's self time is its duration minus
what its children cover. The export gives every span an ``args.id`` and
a child its parent's id in ``args.parent``.

**Device track.** :meth:`Tracer.add_device_span` records an interval the
card spent on one replay (``device/step``, ``device/compact``,
``device/promote``), already put on the host's clock by its caller (the
engine: CUDA timing events read back without a sync, against one anchor
per run; a replayed graph's interval starts at an event the graph
records as its first node, so it holds no launch wait). It exports on its own track (``tid`` 0, ``cat`` ``device``),
with ``args.launched_by`` naming the host span that launched it.

**Clock.** Spans are timed with ``time.perf_counter``; the export writes
them on the clock of ``torch.profiler``'s Kineto events, nanoseconds of
``CLOCK_REALTIME`` (what ``time.time_ns`` reads), so a ``score
--trace-out`` export lays over a ``--trace-dir`` profiler trace of the
same run. The offset between the two clocks is pinned each time the
tracer is enabled (``otherData.perf_counter_offset_us``).

**Aggregates.** :meth:`Tracer.open_scope` starts a :class:`SpanScope`,
which every span completed while it is open updates: per name the count,
the median of its newest 4,096 durations and the total self time; per
device signature its count, median and mean. ``ScoringEngine.run``
opens one for its run (its stats' ``trace`` entry). They do not read the
ring, which a long window overruns.

Where the JAX package wraps a live span in ``jax.profiler.TraceAnnotation``,
a span opened with ``nvtx=True`` pushes an NVTX range for its duration,
named ``rtfds.<name>#<batch>``, so an Nsight Systems capture shows the
host phases beside the kernels; ``torch.profiler`` does not record NVTX
ranges, so while a profiler records, every root span also opens a
profiler annotation of the same name (children open none: on an H100
their annotations slowed the profiled host enough to leave the card idle
half of the benchmark's traced forest window, against a quarter without
them). The engine passes ``nvtx=True`` only when its device is CUDA
(decided once, at its construction); NVTX ranges and the span stack
belong to a thread, and a span enters and exits on the thread that
opened it.

1. **Disabled is free**: :meth:`Tracer.span` is one attribute check and a
   shared no-op context manager.
2. **Enabled is cheap**: two ``perf_counter`` reads, one small object and a
   deque append per span, and each open scope's update.
3. **Bounded**: the ring keeps the newest ``capacity`` spans; a scope
   keeps a fixed window per name.

Usage::

    tracer = get_tracer().configure(enabled=True)
    tracer.begin_batch(42)                  # trace id "b00000042"
    with tracer.span("host_prep", rows=4096):
        with tracer.span("host_prep/pack"):  # a child of host_prep
            ...
    tracer.export("trace.json")             # load in ui.perfetto.dev
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from real_time_fraud_detection_system_tpu_torch.utils.timing import (
    LatencyTracker,
)

__all__ = ["Span", "SpanScope", "Tracer", "get_tracer", "current_ids",
           "summarize_chrome", "DEVICE_TID"]

# the device track's thread id in the export (no Python thread has it)
DEVICE_TID = 0


class Span:
    """One completed span: name, trace id, [t0, t1) in tracer-relative
    seconds, the owning thread (:data:`DEVICE_TID` for the device track),
    free-form args, its id and its parent's (None for a root)."""

    __slots__ = ("name", "trace_id", "batch", "t0", "t1", "tid", "args",
                 "sid", "parent")

    def __init__(self, name: str, trace_id: str, batch: int,
                 t0: float, t1: float, tid: int, args: Optional[dict],
                 sid: int = 0, parent: Optional[int] = None):
        self.name = name
        self.trace_id = trace_id
        self.batch = batch
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.args = args
        self.sid = sid
        self.parent = parent

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0


class _NoopSpan:
    """The disabled path's shared context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process; on its first
    call it replaces itself by ``torch.autograd._profiler_enabled`` (this
    module's import never imports torch)."""
    global _profiling
    import torch

    _profiling = torch.autograd._profiler_enabled
    return _profiling()


class _LiveSpan:
    """Records the span on exit; with ``nvtx`` keeps an NVTX range open
    for its duration, and for a root while a profiler records, a profiler
    annotation, on this thread."""

    __slots__ = ("_tracer", "_name", "_trace_id", "_batch", "_args", "_t0",
                 "_nvtx", "_annotation", "_parent", "_sid", "_child_s",
                 "_stack")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[str], batch: int,
                 args: Optional[dict], nvtx: bool):
        self._tracer = tracer
        self._name = name
        self._trace_id = trace_id
        self._batch = batch
        self._args = args
        self._nvtx = nvtx
        self._annotation = None

    def __enter__(self):
        tr = self._tracer
        self._stack = stack = tr._stack()
        parent = stack[-1] if stack else None
        self._parent = parent
        if self._trace_id is None:
            # no batch of its own: the parent's, else the current one
            if parent is not None:
                self._trace_id, self._batch = parent._trace_id, parent._batch
            else:
                self._trace_id, self._batch = tr._cur_id, tr._cur_batch
        self._sid = next(tr._ids)
        self._child_s = 0.0
        # a root's annotation only: under the profiler each child's
        # would slow the host's stages and starve the device
        profiling = parent is None and _profiling()
        if self._nvtx or profiling:
            import torch

            # name#batch keeps repeated phases apart on the timeline
            label = f"rtfds.{self._name}#{self._batch}"
            if self._nvtx:
                torch.cuda.nvtx.range_push(label)
            if profiling:
                self._annotation = torch.profiler.record_function(label)
                self._annotation.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        stack = self._stack
        stack.pop()
        dur = t1 - self._t0
        parent = self._parent
        if parent is not None:
            # a thread's children run one after another: their durations
            # add up to what they cover of the parent
            parent._child_s += dur
        # recorded once the root closes, so that the recording's own cost
        # falls outside every span of the tree
        done = self._tracer._done()
        done.append((self, t1))
        if not stack:
            self._tracer._record_tree(done)
        return False


def _batch_of(trace_id: str) -> int:
    try:
        return int(trace_id.lstrip("b")) if trace_id else 0
    except ValueError:
        return 0


class SpanScope:
    """Aggregates of the spans completed while it is open (see the
    module's docstring); :meth:`summary` reads them."""

    def __init__(self):
        self._host: Dict[str, list] = {}  # name -> [tracker, self_s]
        self._device: Dict[str, list] = {}  # name -> [tracker, sum_s]

    def _add(self, span: Span, self_s: float) -> None:
        dur = span.t1 - span.t0
        if span.tid == DEVICE_TID:
            agg = self._device.get(span.name)
            if agg is None:
                agg = self._device[span.name] = [LatencyTracker(), 0.0]
            agg[1] += dur
        else:
            agg = self._host.get(span.name)
            if agg is None:
                agg = self._host[span.name] = [LatencyTracker(), 0.0]
            agg[1] += self_s
        agg[0].record(dur)

    def summary(self) -> dict:
        """``spans``: per host span name ``count``, ``median_ms`` and
        ``self_ms`` (the total); ``device``: per device signature
        ``count``, ``median_ms`` and ``mean_ms``."""
        spans, device = {}, {}
        for name, (tr, self_s) in sorted(self._host.items()):
            snap = tr.snapshot()
            spans[name] = {"count": snap["count"],
                           "median_ms": snap["p50_ms"],
                           "self_ms": self_s * 1e3}
        for name, (tr, sum_s) in sorted(self._device.items()):
            snap = tr.snapshot()
            device[name] = {"count": snap["count"],
                            "median_ms": snap["p50_ms"],
                            "mean_ms": sum_s * 1e3 / snap["count"]}
        return {"spans": spans, "device": device}


class Tracer:
    """Span collector with per-batch trace ids and a bounded ring buffer.

    The serving loop is one thread, so the current batch is a plain
    attribute; spans may name their batch (``span(..., batch=tid)``), as
    the pipelined engine does for ``result_wait`` and ``sink_write``,
    which finish batch N while batch N+k is current.
    """

    def __init__(self, capacity: int = 16384, enabled: bool = False):
        self.enabled = False
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()  # buffer swaps and exports only
        self._t0 = time.perf_counter()
        self._epoch_unix_s = time.time()
        self._offset_us = 0.0  # the export clock minus perf_counter, µs
        self._cur_id = ""
        self._cur_batch = 0
        self._seq = 0
        self._m_spans = None  # rtfds_trace_spans_total, resolved lazily
        self._local = threading.local()  # each thread's open spans
        self._ids = itertools.count(1)
        self._scopes: List[SpanScope] = []
        self._scope_lock = threading.Lock()
        self.configure(enabled=enabled)

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None) -> "Tracer":
        """Enable or disable, and resize the ring. Enabling pins the
        offset from ``perf_counter`` to the export's clock."""
        if capacity is not None and capacity != self._buf.maxlen:
            with self._lock:
                self._buf = deque(self._buf, maxlen=int(capacity))
        if enabled and not self.enabled:
            # the two readings bracket no work: their gap is under a µs
            self._offset_us = (time.time_ns()
                               - time.perf_counter_ns()) / 1e3
        if enabled is not None:
            self.enabled = bool(enabled)
        if self.enabled and self._m_spans is None:
            from real_time_fraud_detection_system_tpu_torch.utils.metrics \
                import get_registry

            self._m_spans = get_registry().counter(
                "rtfds_trace_spans_total", "completed trace spans recorded")
        return self

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def __len__(self) -> int:
        return len(self._buf)

    def _stack(self) -> list:
        """This thread's open spans, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            self._local.done = []
            return self._local.stack

    def _done(self) -> list:
        """This thread's closed spans whose root is still open."""
        return self._local.done

    def _record_tree(self, done: list) -> None:
        tid, t0 = threading.get_ident(), self._t0
        for live, t1 in done:
            parent = live._parent
            self._record(Span(
                live._name, live._trace_id, live._batch, live._t0 - t0,
                t1 - t0, tid, live._args, live._sid,
                None if parent is None else parent._sid),
                t1 - live._t0 - live._child_s)
        done.clear()

    def begin_batch(self, batch_index: Optional[int] = None) -> str:
        """Start a batch's trace id; later spans attribute to it. Returns
        the id ("" when disabled)."""
        if not self.enabled:
            return ""
        if batch_index is None:
            self._seq += 1
            batch_index = self._seq
        self._cur_batch = int(batch_index)
        self._cur_id = f"b{int(batch_index):08d}"
        return self._cur_id

    def current_ids(self) -> Tuple[str, int]:
        """(trace_id, batch_index) of the current batch; ("", 0) when
        disabled or before the first batch."""
        return (self._cur_id, self._cur_batch) if self.enabled else ("", 0)

    def open_span(self) -> Optional[Tuple[int, str]]:
        """(id, trace id) of the innermost span open on this thread, or
        None (and None when disabled)."""
        if not self.enabled:
            return None
        stack = self._stack()
        return (stack[-1]._sid, stack[-1]._trace_id) if stack else None

    def span(self, name: str, batch: Optional[str] = None,
             nvtx: bool = False, **args):
        """A live span's context manager. ``batch`` overrides the trace
        id (else the parent's, else the current batch's); ``nvtx`` opens
        an NVTX range beside it (CUDA only: the caller decides); other
        kwargs land in the event's ``args``."""
        if not self.enabled:
            return _NOOP
        bidx = 0 if batch is None else _batch_of(batch)
        return _LiveSpan(self, name, batch, bidx, args or None, nvtx)

    def add_span(self, name: str, t0_perf: float, t1_perf: float,
                 batch: Optional[str] = None, **args) -> None:
        """Record a span already timed by the caller (raw
        ``perf_counter`` readings): source polls, sink writes. It takes
        no parent."""
        if not self.enabled:
            return
        trace_id = self._cur_id if batch is None else batch
        bidx = self._cur_batch if batch is None else _batch_of(batch)
        self._record(Span(name, trace_id, bidx, t0_perf - self._t0,
                          t1_perf - self._t0, threading.get_ident(),
                          args or None, next(self._ids)),
                     t1_perf - t0_perf)

    def add_device_span(self, name: str, t0_perf: float, t1_perf: float,
                        batch: str = "",
                        launched_by: Optional[int] = None) -> None:
        """Record an interval of the device track, on the host's
        ``perf_counter`` clock; ``launched_by`` is the id of the host span
        that launched the work."""
        if not self.enabled:
            return
        args = None if launched_by is None else {"launched_by": launched_by}
        self._record(Span(name, batch, _batch_of(batch),
                          t0_perf - self._t0, t1_perf - self._t0,
                          DEVICE_TID, args, next(self._ids)),
                     t1_perf - t0_perf)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (a model reload, a recapture)."""
        if not self.enabled:
            return
        t = time.perf_counter() - self._t0
        self._record(Span(name, self._cur_id, self._cur_batch, t, t,
                          threading.get_ident(), args or None,
                          next(self._ids)), 0.0)

    def _record(self, span: Span, self_s: float) -> None:
        self._buf.append(span)  # atomic, evicts the oldest
        if self._m_spans is not None:
            self._m_spans.inc()
        if self._scopes:
            with self._scope_lock:
                for scope in self._scopes:
                    scope._add(span, self_s)

    def open_scope(self) -> SpanScope:
        """Start aggregating the spans completed from now on."""
        scope = SpanScope()
        with self._scope_lock:
            self._scopes.append(scope)
        return scope

    def close_scope(self, scope: SpanScope) -> dict:
        """Stop ``scope`` (closing it again is a no-op) and return its
        :meth:`SpanScope.summary`."""
        with self._scope_lock:
            if scope in self._scopes:
                self._scopes.remove(scope)
        return scope.summary()

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def reset(self) -> None:
        """Back to a fresh tracer: disabled (so the next enable pins the
        export clock anew), no scope aggregating, no span open on this
        thread, the ring empty."""
        self.configure(enabled=False)
        with self._scope_lock:
            self._scopes.clear()
        self._stack().clear()
        self._done().clear()
        self.clear()

    def export_chrome(self) -> dict:
        """The ring as a Chrome-trace object: complete (``"ph": "X"``)
        events in µs on the Kineto clock, sorted by start, the trace id,
        the span's id and its parent's in ``args``."""
        pid = os.getpid()
        spans = self.snapshot()
        events: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": "rtfds"},
        }]
        if any(s.tid == DEVICE_TID for s in spans):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": DEVICE_TID, "ts": 0,
                           "args": {"name": "device"}})
        base_us = self._t0 * 1e6 + self._offset_us
        for s in sorted(spans, key=lambda s: s.t0):
            ev = {
                "ph": "X", "name": s.name,
                "cat": "device" if s.tid == DEVICE_TID else "rtfds",
                "ts": round(base_us + s.t0 * 1e6, 3),
                "dur": round((s.t1 - s.t0) * 1e6, 3),
                "pid": pid, "tid": s.tid,
                "args": {"trace_id": s.trace_id, "batch": s.batch,
                         "id": s.sid},
            }
            if s.parent is not None:
                ev["args"]["parent"] = s.parent
            if s.args:
                ev["args"].update(s.args)
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "rtfds",
                # an empty /trace must say why it is empty
                "tracing_enabled": self.enabled,
                "epoch_unix_s": self._epoch_unix_s,
                "clock": "unix_ns_realtime",
                "perf_counter_offset_us": self._offset_us,
                "spans_dropped_by_ring": max(
                    0, (self._m_spans.value if self._m_spans else 0)
                    - len(spans)),
            },
        }

    def export(self, path: str) -> dict:
        """Write the Chrome trace to ``path``; returns (path, events)."""
        trace = self.export_chrome()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f, separators=(",", ":"))
        return {"trace": path, "events": len(trace["traceEvents"])}


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer (disabled until ``configure(enabled=True)``;
    ``score --trace-out`` and ``--metrics-port`` enable it)."""
    return _default_tracer


def current_ids() -> Tuple[str, int]:
    """(trace_id, batch_index) of the default tracer's current batch."""
    return _default_tracer.current_ids()


def _batch_events(events: List[dict]) -> Dict[str, List[dict]]:
    """Duration events grouped by their trace id ("" for none)."""
    by: Dict[str, List[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        tid = str((ev.get("args") or {}).get("trace_id", ""))
        by.setdefault(tid, []).append(ev)
    return by


def _cover_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``intervals``."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _device_idle(host: List[dict], device: List[dict]) -> dict:
    """Each gap between the device track's intervals, credited to the
    innermost host span that covers at least half of it (else to the one
    covering the most; ``other`` where none covers any), in ms; and the
    track's window and busy ms."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                for e in device)
    busy, gaps, end = 0.0, [], iv[0][0]
    for a, b in iv:
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    ids = {(e.get("args") or {}).get("id"): e for e in host}
    depth: Dict[int, int] = {}

    def depth_of(e: dict) -> int:
        key = id(e)
        if key not in depth:
            parent = ids.get((e.get("args") or {}).get("parent"))
            depth[key] = 0 if parent is None or parent is e \
                else depth_of(parent) + 1
        return depth[key]

    hs = np.array([float(e["ts"]) for e in host], dtype=np.float64)
    he = hs + np.array([float(e.get("dur", 0.0)) for e in host],
                       dtype=np.float64)
    hd = np.array([depth_of(e) for e in host], dtype=np.int64)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        name = "other"
        if len(host):
            cover = np.clip(np.minimum(he, b) - np.maximum(hs, a), 0.0, None)
            top = cover.max()
            if top > 0:
                best = np.flatnonzero((cover > 0) & (cover >= (b - a) / 2))
                if not len(best):
                    best = np.flatnonzero(cover == top)
                # the deepest, then the one covering more
                pick = best[np.lexsort((cover[best], hd[best]))[-1]]
                name = host[int(pick)]["name"]
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e3
    return {"device_idle_by_span": {k: round(v, 3) for k, v in
                                    sorted(idle.items())},
            "device_window_ms": round((end - iv[0][0]) / 1e3, 3),
            "device_busy_ms": round(busy / 1e3, 3)}


def summarize_chrome(trace: dict, top_k: int = 10) -> dict:
    """Digest a Chrome trace into each batch's phases and critical phase
    (its longest span), the ``top_k`` slowest spans, and the compile
    events (``xla_compile``/``xla_recompile``: the JAX package's; the
    port compiles nothing while it serves, so its own traces have none).

    A batch's phases and total are its root spans'. Where the trace has
    parents (``args.parent``), each batch also gets ``children_ms`` (the
    child spans' durations by name) and ``self_ms`` (each span name's
    duration minus what its children cover). Where it has a device track
    (``cat`` ``device``), the digest gets ``device_idle_by_span``: each
    gap between device intervals, credited to the innermost host span
    covering most of it, in ms, with the track's ``device_window_ms`` and
    ``device_busy_ms``. A trace without either, as the JAX package writes
    them, digests as the JAX package's function digests it."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") != "device"]
    device = [e for e in events if e.get("cat") == "device"]
    parented = any("parent" in (e.get("args") or {}) for e in host)
    covered: Dict[object, list] = {}
    if parented:
        for e in host:
            p = (e.get("args") or {}).get("parent")
            if p is not None:
                ts = float(e.get("ts", 0.0))
                covered.setdefault(p, []).append(
                    (ts, ts + float(e.get("dur", 0.0))))
    batches = []
    for tid, evs in sorted(_batch_events(host).items()):
        if not tid:
            continue
        phases: Dict[str, float] = {}
        children: Dict[str, float] = {}
        selfs: Dict[str, float] = {}
        for e in evs:
            args = e.get("args") or {}
            dur = float(e.get("dur", 0.0))
            into = children if "parent" in args else phases
            into[e["name"]] = into.get(e["name"], 0.0) + dur
            if parented:
                own = dur - _cover_us(covered.get(args.get("id"), []))
                selfs[e["name"]] = selfs.get(e["name"], 0.0) + own
        crit = max(phases.items(), key=lambda kv: kv[1]) \
            if phases else ("", 0.0)
        batch = {
            "trace_id": tid,
            "batch": (evs[0].get("args") or {}).get("batch"),
            "total_ms": round(sum(phases.values()) / 1e3, 3),
            "critical_phase": crit[0],
            "critical_ms": round(crit[1] / 1e3, 3),
            "phases_ms": {k: round(v / 1e3, 3)
                          for k, v in sorted(phases.items())},
        }
        if parented:
            batch["children_ms"] = {k: round(v / 1e3, 3)
                                    for k, v in sorted(children.items())}
            batch["self_ms"] = {k: round(v / 1e3, 3)
                                for k, v in sorted(selfs.items())}
        batches.append(batch)
    slowest = sorted(events, key=lambda e: -float(e.get("dur", 0.0)))
    top = [{
        "name": e["name"],
        "dur_ms": round(float(e.get("dur", 0.0)) / 1e3, 3),
        "trace_id": (e.get("args") or {}).get("trace_id", ""),
        "ts_ms": round(float(e.get("ts", 0.0)) / 1e3, 3),
    } for e in slowest[:top_k]]
    compiles = [{
        "name": e["name"],
        "dur_ms": round(float(e.get("dur", 0.0)) / 1e3, 3),
        "trace_id": (e.get("args") or {}).get("trace_id", ""),
        "args": {k: v for k, v in (e.get("args") or {}).items()
                 if k not in ("trace_id", "batch")},
    } for e in events if e["name"] in ("xla_compile", "xla_recompile")]
    out = {
        "batches": batches,
        "slowest_spans": top,
        "compile_events": compiles,
        "n_events": len(events),
    }
    if device:
        out.update(_device_idle(host, device))
    return out
