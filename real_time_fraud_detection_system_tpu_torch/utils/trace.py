"""Per-batch trace spans with Chrome-trace export — port of the JAX
package's ``utils/trace.py``.

The metrics registry answers how long each phase takes in aggregate; this
module answers what happened inside one batch. Every phase of a
micro-batch becomes a named span under that batch's trace id, completed
spans land in a bounded ring buffer, and the buffer exports as
Chrome-trace JSON (Perfetto, ``chrome://tracing``).

Where the JAX package wraps a live span in ``jax.profiler.TraceAnnotation``,
a span opened with ``nvtx=True`` pushes an NVTX range for its duration,
named ``rtfds.<name>#<batch>``, so an Nsight Systems capture shows the
host phases beside the kernels; ``torch.profiler`` does not record NVTX
ranges, so the span also opens a profiler annotation of the same name.
The engine passes ``nvtx=True`` only when its device is CUDA (decided
once, at its construction); NVTX ranges belong to a thread, and a span
enters and exits on the thread that opened it.

1. **Disabled is free**: :meth:`Tracer.span` is one attribute check and a
   shared no-op context manager.
2. **Enabled is cheap**: two ``perf_counter`` reads, one small object and a
   deque append per span.
3. **Bounded**: the ring keeps the newest ``capacity`` spans.

Usage::

    tracer = get_tracer().configure(enabled=True)
    tracer.begin_batch(42)                  # trace id "b00000042"
    with tracer.span("host_prep", rows=4096):
        ...
    tracer.export("trace.json")             # load in ui.perfetto.dev
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["Span", "Tracer", "get_tracer", "current_ids",
           "summarize_chrome"]


class Span:
    """One completed span: name, trace id, [t0, t1) in tracer-relative
    seconds, the owning thread, and free-form args."""

    __slots__ = ("name", "trace_id", "batch", "t0", "t1", "tid", "args")

    def __init__(self, name: str, trace_id: str, batch: int,
                 t0: float, t1: float, tid: int, args: Optional[dict]):
        self.name = name
        self.trace_id = trace_id
        self.batch = batch
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.args = args

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


class _LiveSpan:
    """Records the span on exit; with ``nvtx`` keeps an NVTX range and a
    profiler annotation open for its duration, on this thread."""

    __slots__ = ("_tracer", "_name", "_trace_id", "_batch", "_args", "_t0",
                 "_nvtx", "_annotation")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 batch: int, args: Optional[dict], nvtx: bool):
        self._tracer = tracer
        self._name = name
        self._trace_id = trace_id
        self._batch = batch
        self._args = args
        self._nvtx = nvtx
        self._annotation = None

    def __enter__(self):
        if self._nvtx:
            import torch

            # name#batch keeps repeated phases apart on the timeline
            label = f"rtfds.{self._name}#{self._batch}"
            torch.cuda.nvtx.range_push(label)
            self._annotation = torch.profiler.record_function(label)
            self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._nvtx:
            import torch

            self._annotation.__exit__(*exc)
            torch.cuda.nvtx.range_pop()
        self._tracer._record(Span(
            self._name, self._trace_id, self._batch,
            self._t0 - self._tracer._t0, t1 - self._tracer._t0,
            threading.get_ident(), self._args))
        return False


def _batch_of(trace_id: str) -> int:
    try:
        return int(trace_id.lstrip("b")) if trace_id else 0
    except ValueError:
        return 0


class Tracer:
    """Span collector with per-batch trace ids and a bounded ring buffer.

    The serving loop is one thread, so the current batch is a plain
    attribute; spans may name their batch (``span(..., batch=tid)``), as
    the pipelined engine does for ``result_wait`` and ``sink_write``,
    which finish batch N while batch N+k is current.
    """

    def __init__(self, capacity: int = 16384, enabled: bool = False):
        self.enabled = bool(enabled)
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()  # buffer swaps and exports only
        self._t0 = time.perf_counter()
        self._epoch_unix_s = time.time()
        self._cur_id = ""
        self._cur_batch = 0
        self._seq = 0
        self._m_spans = None  # rtfds_trace_spans_total, resolved lazily

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None) -> "Tracer":
        """Enable or disable, and resize the ring."""
        if capacity is not None and capacity != self._buf.maxlen:
            with self._lock:
                self._buf = deque(self._buf, maxlen=int(capacity))
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

    def span(self, name: str, batch: Optional[str] = None,
             nvtx: bool = False, **args):
        """A live span's context manager. ``batch`` overrides the current
        trace id; ``nvtx`` opens an NVTX range beside it (CUDA only: the
        caller decides); other kwargs land in the event's ``args``."""
        if not self.enabled:
            return _NOOP
        if batch is None:
            trace_id, bidx = self._cur_id, self._cur_batch
        else:
            trace_id, bidx = batch, _batch_of(batch)
        return _LiveSpan(self, name, trace_id, bidx, args or None, nvtx)

    def add_span(self, name: str, t0_perf: float, t1_perf: float,
                 batch: Optional[str] = None, **args) -> None:
        """Record a span already timed by the caller (raw
        ``perf_counter`` readings): source polls, sink writes."""
        if not self.enabled:
            return
        trace_id = self._cur_id if batch is None else batch
        bidx = self._cur_batch if batch is None else _batch_of(batch)
        self._record(Span(name, trace_id, bidx, t0_perf - self._t0,
                          t1_perf - self._t0, threading.get_ident(),
                          args or None))

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (a model reload, a recapture)."""
        if not self.enabled:
            return
        t = time.perf_counter() - self._t0
        self._record(Span(name, self._cur_id, self._cur_batch, t, t,
                          threading.get_ident(), args or None))

    def _record(self, span: Span) -> None:
        self._buf.append(span)  # atomic, evicts the oldest
        if self._m_spans is not None:
            self._m_spans.inc()

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def export_chrome(self) -> dict:
        """The ring as a Chrome-trace object: complete (``"ph": "X"``)
        events in µs, sorted by start, the trace id in ``args``."""
        pid = os.getpid()
        spans = self.snapshot()
        events: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": "rtfds"},
        }]
        for s in sorted(spans, key=lambda s: s.t0):
            ev = {
                "ph": "X", "name": s.name, "cat": "rtfds",
                "ts": round(s.t0 * 1e6, 3),
                "dur": round((s.t1 - s.t0) * 1e6, 3),
                "pid": pid, "tid": s.tid,
                "args": {"trace_id": s.trace_id, "batch": s.batch},
            }
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


def summarize_chrome(trace: dict, top_k: int = 10) -> dict:
    """Digest a Chrome trace into each batch's phases and critical phase
    (its longest span), the ``top_k`` slowest spans, and the compile
    events (``xla_compile``/``xla_recompile``: the JAX package's; the
    port compiles nothing while it serves, so its own traces have none).
    The JAX package's function, so a trace of either package digests the
    same."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X"]
    batches = []
    for tid, evs in sorted(_batch_events(events).items()):
        if not tid:
            continue
        phases: Dict[str, float] = {}
        for e in evs:
            phases[e["name"]] = phases.get(e["name"], 0.0) \
                + float(e.get("dur", 0.0))
        crit = max(phases.items(), key=lambda kv: kv[1]) \
            if phases else ("", 0.0)
        batches.append({
            "trace_id": tid,
            "batch": (evs[0].get("args") or {}).get("batch"),
            "total_ms": round(sum(phases.values()) / 1e3, 3),
            "critical_phase": crit[0],
            "critical_ms": round(crit[1] / 1e3, 3),
            "phases_ms": {k: round(v / 1e3, 3)
                          for k, v in sorted(phases.items())},
        })
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
    return {
        "batches": batches,
        "slowest_spans": top,
        "compile_events": compiles,
        "n_events": len(events),
    }
