"""Micro-batch scoring engine — port of the JAX package's
``runtime/engine.py`` for the logreg, tree, forest and gbt serving paths.

Per micro-batch (:meth:`ScoringEngine._start_batch`, ``_finish_batch``):
latest-wins dedup and the pack into one int32 ``[7, B]`` array on the host
(``native/hostprep.cc`` through ``core/native.py`` where it builds, NumPy
otherwise), written straight into a pinned staging buffer on CUDA; one
non-blocking host-to-device copy; the device step; the copies of the
results back into pinned host memory on a side stream that waits on an
event recorded after the step; then the sink. :meth:`ScoringEngine.run`
keeps ``runtime.pipeline_depth`` batches in flight, so batch N+1's host
prep, copy and launches overlap batch N's device work, and can coalesce
small polls (``runtime.coalesce_rows``) and pace batch starts
(``runtime.trigger_seconds``). With a checkpointer (``io/checkpoint.py``)
it saves every ``runtime.checkpoint_every_batches`` finished batches, as
the JAX engine orders it: an async sink drains, the state is saved, then
the source commits; and it drains the pipeline before launching a batch
while a queued one will checkpoint, so a save never records a batch's
offsets with a later batch's state. ``runtime/faults.py`` supervises it.

The step takes the JAX step's branches in its order: unpack the batch,
scatter it into the feature state (in place), then

- logreg with ``customer_source="table"``: the fused featurize→logreg
  kernel (``ops/score_kernels.py::fused_featurize_score``), which reads
  both tables' rows by slot;
- tree and forest with ``customer_source="table"``, when the forest
  kernels' static admission predicate holds
  (``ops/forest_kernels.py::admit_tables``): the fused featurize→forest
  kernel, which reads them the same way, and ``leaf / n_trees``;
- otherwise: ``update_and_featurize`` → ``transform`` → the predict. Where
  the same predicate holds, that predict is the leaf-sum kernel
  (``ops/forest_kernels.py::leaf_sum``): ``sigmoid(base + leaf)`` for gbt,
  ``leaf / n_trees`` for tree and forest under ``customer_source="cms"``
  (the fused kernels read the customer table, which the sketch replaces);
  the plain predict serves logreg under the sketch and the shapes the
  predicate does not admit.

Every branch ends in ``probs = where(valid, probs, 0)``. Every step is
enqueued on the current stream, which is what chains the in-place state
updates from one batch to the next. On the CPU each kernel wrapper runs
its plain version; on the card the kernels the step launches are built
and loaded when the engine is built, and a kernel that does not build,
load or launch raises ``RuntimeError``, which no branch catches.

A restore (``io/checkpoint.py``) writes into the engine's own tensors in
place; when it brings other params than the live ones it advances
``state.params_epoch``, and the next step re-derives the kernel tables
from them.

Not ported yet: selective and bf16 emission, the nan-guard, CUDA-graph
precompile, autobatch and the overload ladder (A4); feedback, online SGD
and model reload (A6); the mlp, autoencoder and sequence kinds (A8).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.config import Config
from real_time_fraud_detection_system_tpu_torch.core import native
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    bucket_size,
    make_batch,
    pack_batch,
    unpack_batch,
)
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.online import (
    FeatureState,
    init_feature_state,
    update_and_featurize,
    update_and_score_fused_forest,
    update_and_score_fused_logreg,
)
from real_time_fraud_detection_system_tpu_torch.features.spec import N_FEATURES
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    GemmEnsemble,
    TreeEnsemble,
    for_device,
    predict_proba,
    resolve_z_mode,
)
from real_time_fraud_detection_system_tpu_torch.models.gbt import (
    GBTModel,
    gbt_for_device,
    gbt_predict_proba,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    logreg_predict_proba,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    Scaler,
    transform,
)
from real_time_fraud_detection_system_tpu_torch.ops import (
    forest_kernels,
    score_kernels,
)
from real_time_fraud_detection_system_tpu_torch.ops.dedup import (
    latest_wins_mask_host,
)
from real_time_fraud_detection_system_tpu_torch.ops.forest_kernels import (
    ForestTables,
    admit_tables,
    leaf_sum,
    to_kernel_tables,
)
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    PoisonRowError,
)
from real_time_fraud_detection_system_tpu_torch.utils.timing import (
    LatencyTracker,
)

_KINDS = ("logreg", "tree", "forest", "gbt")


def _require_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(
            f"model kind {kind!r} is not ported yet: the port serves "
            f"{_KINDS} (the rest of the zoo waits for ROADMAP A8)")


def device_params_for(kind: str, params):
    """Engine-ready params: tree ensembles (a gbt's trees too) convert to
    the GEMM form once, where their depth allows it."""
    _require_kind(kind)
    if kind == "gbt":
        return gbt_for_device(params, N_FEATURES)
    if isinstance(params, TreeEnsemble):
        return for_device(params, N_FEATURES)
    return params


def predict_fn_for(kind: str, z_mode: Optional[str] = None) -> Callable:
    """Plain device predict for ``kind`` with a RESOLVED ``z_mode`` (the
    logreg kind has no contraction and ignores it)."""
    _require_kind(kind)
    if kind == "logreg":
        return logreg_predict_proba
    if kind == "gbt":
        return lambda p, x: gbt_predict_proba(p, x, z_mode)
    return lambda p, x: predict_proba(p, x, z_mode)


@dataclass
class EngineState:
    """Host-visible engine state (device tensors + offsets + counters)."""

    feature_state: FeatureState
    params: object
    scaler: Scaler
    offsets: List[int] = field(default_factory=list)
    batches_done: int = 0
    rows_done: int = 0
    # CUDA event recorded behind the last step that wrote the state; a
    # checkpoint save waits for it before reading (None on the CPU).
    ready: Optional[object] = None
    # CRC32 of each params leaf as a restore last wrote them (None: not
    # known yet), and a counter a restore advances when it brings other
    # params, so the engine re-derives its kernel tables.
    params_crcs: Optional[dict] = None
    params_epoch: int = 0


@dataclass
class BatchResult:
    tx_id: np.ndarray
    tx_datetime_us: np.ndarray
    customer_id: np.ndarray
    terminal_id: np.ndarray
    amount_cents: np.ndarray
    features: np.ndarray  # [n, 15]
    probs: np.ndarray  # [n]
    latency_s: float
    # Monotone engine batch counter: a replayed batch carries the SAME
    # index, so idempotent sinks can overwrite instead of duplicating.
    batch_index: int = -1


def empty_batch_result(batch_index: int) -> BatchResult:
    """A zero-row result claiming ``batch_index``: what a batch whose every
    row went to the dead-letter queue leaves, so the sink's
    ``batch_index`` lineage has no gap."""
    return BatchResult(
        tx_id=np.empty(0, np.int64),
        tx_datetime_us=np.empty(0, np.int64),
        customer_id=np.empty(0, np.int64),
        terminal_id=np.empty(0, np.int64),
        amount_cents=np.empty(0, np.int64),
        features=np.zeros((0, N_FEATURES), np.float32),
        probs=np.empty(0, np.float32),
        latency_s=0.0,
        batch_index=int(batch_index),
    )


def validate_ingest_rows(cols: dict) -> None:
    """Refuse a batch with negative amounts — garbage must never scatter
    into the feature state."""
    amounts = np.asarray(cols["tx_amount_cents"])
    bad = amounts < 0
    if bad.any():
        ids = np.asarray(cols["tx_id"])[bad]
        raise PoisonRowError(
            f"corrupt row(s): negative amount_cents for "
            f"{int(bad.sum())} row(s), tx_id(s) {ids[:5].tolist()}")


def _owned(tree):
    """A copy of a NamedTuple of tensors (and Python scalars) that shares
    no storage with the caller's: a restore writes into it in place."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_owned(getattr(tree, n)) for n in tree._fields))
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def batches_left(state: EngineState, lifetime_max: int) -> int:
    """``ScoringEngine.run``'s ``max_batches`` for a cap on the engine's
    lifetime batch count, restored batches included, which is how the
    JAX engine counts ``max_batches`` (the supervisor's and a resumed
    ``score``'s): 0 (no cap) for 0, else the batches still to go, or -1
    (none) once the count is reached."""
    if not lifetime_max:
        return 0
    return max(lifetime_max - state.batches_done, 0) or -1


class _StagingRing:
    """Pinned int32 ``[7, pad]`` host buffers for the packed batch, a ring
    of ``slots`` per bucket size. A buffer is handed out again only after
    the event recorded behind its last host-to-device copy has completed,
    so a batch never packs into memory a pending copy still reads."""

    def __init__(self, slots: int):
        self.slots = slots
        self._rings: Dict[int, list] = {}
        self._next: Dict[int, int] = {}

    def acquire(self, pad: int) -> list:
        """A ``[buffer, event]`` entry; the caller records the event after
        the copy that reads the buffer."""
        ring = self._rings.setdefault(pad, [])
        i = self._next.get(pad, 0)
        self._next[pad] = (i + 1) % self.slots
        if i == len(ring):
            ring.append([torch.empty((7, pad), dtype=torch.int32,
                                     pin_memory=True), None])
        entry = ring[i]
        if entry[1] is not None:
            entry[1].synchronize()
        return entry


class ScoringEngine:
    """Drives source → device step → sink for a logreg, tree, forest or
    gbt model.

    ``device=None`` means CUDA (raises without a card); ``device="cpu"``
    runs the plain PyTorch path. The feature state is updated in place;
    the params and the scaler are the engine's own copies (a restore
    writes into them). ``host_prep`` names the host-prep route:
    ``"native"`` (the C++ unit built) or ``"numpy"``.
    """

    def __init__(
        self,
        cfg: Config,
        kind: str,
        params,
        scaler: Scaler,
        feature_state: Optional[FeatureState] = None,
        device=None,
    ):
        _require_kind(kind)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kind = kind
        self.z_mode = resolve_z_mode(cfg.runtime.z_mode, self.device)
        params = _owned(device_params_for(kind, params.to(self.device)))
        self.state = EngineState(
            feature_state=feature_state
            or init_feature_state(cfg.features, self.device),
            params=params,
            scaler=_owned(scaler.to(self.device)),
        )
        self._predict = predict_fn_for(kind, self.z_mode)
        self._table_source = cfg.features.customer_source == "table"
        self._derive_tables()
        self.host_prep = ("native" if native.hostprep_available()
                          else "numpy")
        cuda = self.device.type == "cuda"
        self._staging = (_StagingRing(max(1, cfg.runtime.pipeline_depth) + 1)
                         if cuda else None)
        self._d2h_stream = (torch.cuda.Stream(self.device)
                            if cuda and cfg.runtime.fetch_overlap else None)

    def _derive_tables(self) -> None:
        """The kernels' tables, from the live params' shapes where
        ``admit_tables`` admits a GEMM-form ensemble: ``tables`` for the
        fused forest kernel (tree and forest kinds on the customer
        table), ``leaf_tables`` for the leaf-sum kernel (gbt, and tree
        and forest on the sketch); both None otherwise. Derived at build
        and again after a restore that brought other params."""
        self.tables: Optional[ForestTables] = None
        self.leaf_tables: Optional[ForestTables] = None
        params = self.state.params
        trees = params.trees if isinstance(params, GBTModel) else params
        if isinstance(trees, GemmEnsemble) and admit_tables(trees).fits:
            if self.kind == "gbt" or not self._table_source:
                self.leaf_tables = to_kernel_tables(trees, self.z_mode)
            else:
                self.tables = to_kernel_tables(trees, self.z_mode)
        self._tables_epoch = self.state.params_epoch
        if self.device.type == "cuda":
            self._load_kernels()

    def _load_kernels(self) -> None:
        """Build and load the kernel libraries the step launches (once per
        process), so one that does not build or load raises here: from
        the constructor, outside the recovery supervisor's restarts, and
        never from a supervised step."""
        if self.kind == "logreg" and self._table_source:
            score_kernels._library()
        if self.tables is not None:
            forest_kernels._library()
        if self.leaf_tables is not None:
            forest_kernels._leaf_sum_library()

    def checkpoint_state(self) -> EngineState:
        """The state a checkpoint save persists (the engine's own)."""
        return self.state

    def _unfused_predict(self, x: torch.Tensor) -> torch.Tensor:
        """The predict of the unfused step on scaled features ``x``."""
        tables = self.leaf_tables
        if tables is None:
            return self._predict(self.state.params, x)
        leaf = leaf_sum(tables, x)
        if self.kind == "gbt":
            return torch.sigmoid(self.state.params.base_score + leaf)
        return leaf / tables.n_trees

    def _step(self, packed: torch.Tensor):
        """One device step on a packed batch; returns (probs, features)."""
        if self._tables_epoch != self.state.params_epoch:
            self._derive_tables()
        batch = unpack_batch(packed)
        fcfg = self.cfg.features
        scaler = self.state.scaler
        params = self.state.params
        tables = self.tables
        if self.kind == "logreg" and self._table_source:
            fstate, probs, feats = update_and_score_fused_logreg(
                self.state.feature_state, batch, fcfg, scaler.mean,
                scaler.scale, params.w, params.b)
        elif tables is not None:
            fstate, leaf, feats = update_and_score_fused_forest(
                self.state.feature_state, batch, fcfg, scaler.mean,
                scaler.scale, tables)
            probs = leaf / tables.n_trees
        else:
            fstate, feats = update_and_featurize(
                self.state.feature_state, batch, fcfg)
            probs = self._unfused_predict(transform(scaler, feats))
        self.state.feature_state = fstate
        return torch.where(batch.valid, probs, torch.zeros_like(probs)), feats

    def _pack(self, cols: dict, n: int, pad: int):
        """The packed ``[7, pad]`` batch on the host: a pinned staging
        entry ``[buffer, event]`` on CUDA, else an int32 tensor."""
        entry = self._staging.acquire(pad) if self._staging else None
        out = entry[0].numpy() if entry is not None else None
        if self.host_prep == "native":
            packed = native.pack_rows(
                cols["tx_datetime_us"], cols["customer_id"],
                cols["terminal_id"], cols["tx_amount_cents"],
                cols.get("label"), pad, out=out)
        else:
            packed = pack_batch(make_batch(
                customer_id=cols["customer_id"],
                terminal_id=cols["terminal_id"],
                tx_datetime_us=cols["tx_datetime_us"],
                amount_cents=cols["tx_amount_cents"],
                label=cols.get("label"),
                pad_to=pad,
            ))
            if out is not None:
                out[...] = packed
        return entry if entry is not None else torch.from_numpy(packed)

    def _issue_host_fetch(self, probs: torch.Tensor, feats: torch.Tensor,
                          n: int, step_done) -> Optional[dict]:
        """Start the device-to-host copies of the ``n`` real rows'
        probabilities (and features, when emitted) on the side stream,
        after ``step_done`` (the event recorded behind the step), into
        pinned blocks of the caching host allocator: each batch gets its
        own, so a result never shares memory with a later batch's. None
        without the side stream (the CPU, or ``fetch_overlap`` off)."""
        side = self._d2h_stream
        if side is None:
            return None
        side.wait_event(step_done)
        host = {"probs": torch.empty(n, dtype=torch.float32,
                                     pin_memory=True)}
        if self.cfg.runtime.emit_features:
            host["feats"] = torch.empty((n, N_FEATURES), dtype=torch.float32,
                                        pin_memory=True)
        with torch.cuda.stream(side):
            host["probs"].copy_(probs[:n], non_blocking=True)
            if "feats" in host:
                host["feats"].copy_(feats[:n], non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
        host["done"] = done
        return host

    def _start_batch(self, cols: dict) -> dict:
        """Host prep (dedup, validate, pad, pack), the host-to-device copy,
        the device step, and the start of the result copies. Does not wait for
        the device. The handle keeps the step's ``probs`` and ``feats``
        until :meth:`_finish_batch` has waited for the copies that read
        them, so the caching allocator cannot hand their memory out
        while the side stream reads it."""
        t0 = time.perf_counter()
        keep = latest_wins_mask_host(cols["tx_id"], cols["kafka_ts_ms"])
        cols = {k: v[keep] for k, v in cols.items()}
        validate_ingest_rows(cols)
        n = len(cols["tx_id"])
        pad = bucket_size(n, self.cfg.runtime.batch_buckets)
        host = self._pack(cols, n, pad)
        t1 = time.perf_counter()
        if isinstance(host, list):
            packed = host[0].to(self.device, non_blocking=True)
            host[1] = torch.cuda.Event()
            host[1].record()
        else:
            packed = host.to(self.device)
        probs, feats = self._step(packed)
        step_done = None
        if self.device.type == "cuda":
            # behind the step that wrote the state: the side-stream copies
            # and a checkpoint save wait for it
            step_done = torch.cuda.Event()
            step_done.record()
            self.state.ready = step_done
        fetch = self._issue_host_fetch(probs, feats, n, step_done)
        return {"cols": cols, "n": n, "probs": probs, "feats": feats,
                "fetch": fetch, "t0": t0, "prep_s": t1 - t0,
                "dispatch_s": time.perf_counter() - t1}

    def _finish_batch(self, handle: dict) -> BatchResult:
        """Wait for this batch's result copies (the event behind them on
        the side stream, never the whole device) and build its result."""
        n = handle["n"]
        emit = self.cfg.runtime.emit_features
        fetch = handle["fetch"]
        if fetch is not None:
            fetch["done"].synchronize()
            probs_np = fetch["probs"].numpy()
            feats_np = fetch["feats"].numpy() if emit else None
        else:
            probs_np = handle["probs"][:n].cpu().numpy()
            feats_np = handle["feats"][:n].cpu().numpy() if emit else None
        if feats_np is None:
            feats_np = np.zeros((n, N_FEATURES), np.float32)
        cols = handle["cols"]
        self.state.batches_done += 1
        self.state.rows_done += n
        return BatchResult(
            tx_id=cols["tx_id"],
            tx_datetime_us=cols["tx_datetime_us"],
            customer_id=cols["customer_id"],
            terminal_id=cols["terminal_id"],
            amount_cents=cols["tx_amount_cents"],
            features=feats_np,
            probs=probs_np,
            latency_s=(time.perf_counter() - handle["t0"]
                       - handle.get("waited", 0.0)),
            batch_index=self.state.batches_done,
        )

    def process_batch(self, cols: dict) -> BatchResult:
        """One micro-batch: dedup → pad → device step → host result."""
        return self._finish_batch(self._start_batch(cols))

    def run(self, source, sink=None, max_batches: int = 0,
            checkpointer=None, trigger_seconds: Optional[float] = None,
            heartbeat=None) -> dict:
        """Stream until the source is exhausted or ``max_batches`` batches
        of this run have started (0: no cap; a negative count starts
        none). :func:`batches_left` turns a cap on the engine's lifetime
        batches, as the JAX engine counts them, into this one.

        Up to ``runtime.pipeline_depth`` batches are in flight: a batch is
        finished (results waited for, sink appended) once ``depth``
        handles are queued, and the rest drain at the end.
        ``runtime.coalesce_rows`` merges consecutive polls into one batch
        of up to that many rows, never past the largest bucket (a poll
        that would overflow it is carried into the next batch).
        ``trigger_seconds`` (default ``runtime.trigger_seconds``) spaces
        batch starts at least that far apart, once per loop pass on the
        poll side; the time slept, like source polls, is credited as wait
        so latencies measure the pipeline. An empty poll (an idle live
        source) drains the pipeline and waits one trigger.

        ``checkpointer``: after every ``runtime.checkpoint_every_batches``
        finished batches an async sink drains, the state is saved and the
        source commits (where it can), in that order, so offsets trail
        durable output and broker commits trail the checkpoint. A batch
        launches only once no queued batch will checkpoint (the pipeline
        drains first), so a save never holds a later batch's state.
        ``heartbeat`` is beaten once per loop pass (the stall watchdog's
        progress signal).

        Returns this run's stats: rows, batches, wall and CPU seconds,
        rows/s, the per-batch latency p50/p99 (host prep through the
        results' arrival on the host, minus waits), the median ms of each
        loop stage (``stage_ms_p50``: source poll, per poll; host prep;
        dispatch — the host-to-device copy, the step's launches and the
        start of the result copies; result wait; sink write), the same four
        medians as ``*_p50_ms`` keys, ``pipeline_depth``,
        ``host_prep_route`` and ``z_mode``.
        """
        rt = self.cfg.runtime
        trigger = rt.trigger_seconds if trigger_seconds is None \
            else trigger_seconds
        depth = max(1, rt.pipeline_depth)
        coalesce = rt.coalesce_rows
        cap = max(rt.batch_buckets)
        trackers = {k: LatencyTracker() for k in (
            "latency", "source_poll", "host_prep", "dispatch",
            "result_wait", "sink_write")}
        t_start = time.perf_counter()
        t_cpu0 = time.process_time()
        rows0 = self.state.rows_done
        batches0 = self.state.batches_done
        every = rt.checkpoint_every_batches
        q: deque = deque()  # in-flight handles, FIFO, at most ``depth``

        def _finish(handle: dict) -> None:
            t_block = time.perf_counter()
            res = self._finish_batch(handle)
            trackers["result_wait"].record(time.perf_counter() - t_block)
            trackers["host_prep"].record(handle["prep_s"])
            trackers["dispatch"].record(handle["dispatch_s"])
            trackers["latency"].record(res.latency_s, rows=len(res.tx_id))
            self.state.offsets = handle["source_offsets"]
            if sink is not None:
                t = time.perf_counter()
                sink.append(res)
                trackers["sink_write"].record(time.perf_counter() - t)
            if checkpointer is not None \
                    and self.state.batches_done % every == 0:
                # offsets trail durable sink output: drain an async sink
                # first; a broker commits only after the save landed
                drain = getattr(sink, "drain", None)
                if drain is not None:
                    drain()
                checkpointer.save(self.checkpoint_state())
                commit = getattr(source, "commit", None)
                if commit is not None:
                    commit()

        def _add_wait(dt: float) -> None:
            for h in q:
                h["waited"] = h.get("waited", 0.0) + dt

        def _drain() -> None:
            while q:
                _finish(q.popleft())

        def _poll() -> Optional[dict]:
            t = time.perf_counter()
            cols = source.poll_batch()
            dt = time.perf_counter() - t
            _add_wait(dt)
            if cols is not None:
                trackers["source_poll"].record(dt)
            return cols

        def _rows(cols: dict) -> int:
            return len(next(iter(cols.values()), ()))

        exhausted = False
        carry = None  # (cols, offsets): a poll beyond the coalesce cap
        t_last_start = None
        while not exhausted:
            if heartbeat is not None:
                heartbeat.beat()
            started = self.state.batches_done + len(q)
            if max_batches and started - batches0 >= max_batches:
                break
            if trigger > 0 and t_last_start is not None:
                dt = trigger - (time.perf_counter() - t_last_start)
                if dt > 0:
                    time.sleep(dt)
                    _add_wait(dt)
            if carry is not None:
                cols, offs = carry
                carry = None
            else:
                cols = _poll()
                if cols is None:
                    break
                if _rows(cols) == 0:
                    _drain()
                    if trigger > 0:
                        time.sleep(trigger)
                    continue
                offs = list(source.offsets)
            if coalesce > 0:
                target = min(coalesce, cap)
                parts = [cols]
                total = _rows(cols)
                while total < target:
                    more = _poll()
                    if more is None:
                        exhausted = True  # serve the tail, then stop
                        break
                    m = _rows(more)
                    if m == 0:
                        break
                    if total + m > cap:
                        carry = (more, list(source.offsets))
                        break
                    parts.append(more)
                    total += m
                    offs = list(source.offsets)
                if len(parts) > 1:
                    cols = {k: np.concatenate([p[k] for p in parts])
                            for k in parts[0]}
            if checkpointer is not None and any(
                    h["index"] % every == 0 for h in q):
                _drain()  # a queued batch will checkpoint: nothing newer
            handle = self._start_batch(cols)
            t_last_start = time.perf_counter()
            handle["index"] = self.state.batches_done + len(q) + 1
            handle["source_offsets"] = offs
            q.append(handle)
            while len(q) >= depth:
                _finish(q.popleft())
        _drain()
        sink_drain = getattr(sink, "drain", None)
        if sink_drain is not None:
            sink_drain()
        wall = time.perf_counter() - t_start
        snaps = {k: t.snapshot() for k, t in trackers.items()}
        p50 = {k: snaps[k].get("p50_ms", 0.0) for k in trackers}
        rows = self.state.rows_done - rows0
        return {
            "rows": rows,
            "batches": self.state.batches_done - batches0,
            "wall_s": wall,
            "cpu_s": time.process_time() - t_cpu0,
            "rows_per_s": rows / wall if wall > 0 else 0.0,
            "latency_p50_ms": p50["latency"],
            "latency_p99_ms": snaps["latency"].get("p99_ms", 0.0),
            "stage_ms_p50": {k: p50[k] for k in (
                "source_poll", "host_prep", "dispatch", "result_wait",
                "sink_write")},
            "host_prep_p50_ms": p50["host_prep"],
            "dispatch_p50_ms": p50["dispatch"],
            "result_wait_p50_ms": p50["result_wait"],
            "sink_write_p50_ms": p50["sink_write"],
            "pipeline_depth": depth,
            "host_prep_route": self.host_prep,
            "z_mode": self.z_mode,
        }
