"""Micro-batch scoring engine — port of the JAX package's
``runtime/engine.py``: every kind of its model zoo (logreg, mlp, tree,
forest, gbt, autoencoder, sequence) on one device.

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
  the plain predict serves logreg under the sketch, the mlp and the
  autoencoder (whose products the JAX package computes outside any Pallas
  kernel too), and the shapes the predicate does not admit.

The sequence kind has its own state and step (:meth:`_init_sequence`):
the per-customer event rings of ``features/history.py`` and
``update_and_score``, which writes the rings in place and scores each row
with the causal transformer. Its feature matrix is zeros by definition,
made on the host and never copied from the device. It refuses what the
JAX engine refuses for it (:func:`check_sequence_serving`):
``key_mode="exact"``, online SGD, a feature cache and shadow scoring.

Under ``key_mode="exact"`` (the tiered store) the step is
``update_and_featurize_exact`` → ``transform`` → the predict, as the JAX
engine keeps both fused kernels off that path: tree, forest and gbt take
the leaf-sum kernel, logreg its plain predict. The step also returns the
batch's tier counts ``[dense, cms]``, which ride the result copies to the
host. Between steps, on the step's stream, ``_maybe_compact`` runs the
recency compaction every ``features.compact_every`` batches, and with a
``features.cold_store`` demotes the oldest keys to the host cold tier
(``io/coldstore.py``); ``_maybe_promote`` lands the rows the promoter
thread has read back for returning keys. The compaction's counts reach
the metrics through a side-stream copy, never a sync; the cold tier's
payloads and promotion stats come to the host when a compaction demotes
or a promotion lands, as in the JAX engine.

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

The learning hooks (``runtime/feedback.py``, ``runtime/learner.py``):

- ``online_lr > 0`` (logreg, mlp, autoencoder): after every branch the
  step takes one SGD step on the batch's in-band labels,
  ``p -= lr·has·∇loss`` in place on the step's stream for every leaf of
  the params tree (``utils/tree.py``), with ``has = any(labeled)`` kept on
  the device (no host sync); the gradient is ``torch.autograd`` on the
  plain loss over the step's features, as the JAX step takes
  ``jax.grad`` outside its kernels;
- a ``feature_cache`` keeps every emitted row for the feedback join;
  :meth:`ScoringEngine.apply_state_feedback` lands delayed labels in the
  terminal risk windows and :meth:`ScoringEngine.apply_feedback` takes a
  backtracking SGD step (one host read of ``l1 <= l0`` per halving, as
  in JAX), both enqueued on the serving stream between steps;
- :meth:`ScoringEngine.swap_params` is the one way params change
  wholesale (hot reload, promotion, rollback, resync): leaves of the same
  shape and dtype are copied in place (the fused kernel reads ``w`` and
  ``b`` by pointer), others rebound; either way ``params_epoch``
  advances, so the next step re-derives the kernel tables;
- ``run(feedback=, model_reload=, learning=)`` polls feedback, then the
  reloader, then the learning loop once per finished batch, and commits
  feedback offsets after the checkpoint, in the JAX engine's order.

The precompiled step (the JAX engine's per-bucket AOT executables):
:meth:`ScoringEngine.dispatch_inventory` enumerates every signature the
engine can dispatch — ``("step", 7, bucket)`` per batch bucket,
``("compact",)`` with a compaction cadence, ``("promote",)`` with a cold
tier — and on the card :meth:`ScoringEngine.precompile` captures one CUDA
graph per signature, all in one memory pool, after warming the step up on
scratch copies of the state (the live state, params and counters stay
bit-identical). A batch then copies its packed rows into its bucket's
static input and replays (:meth:`_dispatch_step`); the outputs are cloned
out of the graph's static tensors at once, so a result in flight never
shares memory with a later replay. What the step does on the host runs
around the replay every batch: the kernel tables' re-derive after a
params change (copied into the tables the graphs read, in place, where
their form is the same; a change of form recaptures, counted in
``cuda_graph_recaptures_total``), ``params_crcs`` after the in-step SGD,
the ``ready`` event. Each kernel wrapper counts the launches a graph
recorded at every replay. On the CPU nothing is captured.

Serving extras, as in the JAX engine: ``emit_dtype="bfloat16"`` casts
the emitted matrix after the classifier read the float32 features;
``emit_threshold > 0`` packs ``[probs | count | idx(cap) |
feats(cap·15)]`` into one float32 transfer (the compaction is a cumsum and
a scatter, fixed-shape and free of host syncs, so it is captured too) and
fetches the full matrix only when a batch flags more than ``cap`` rows;
``nan_guard`` copies what the step writes into preallocated twins before
each step and, on a non-finite row, copies them back, quarantines the row
(``reason="nonfinite"``) and re-scores the batch without it;
``runtime/autobatch.py`` moves the coalesce target between the buckets;
``runtime/overload.py``'s ladder sheds optional work, degrades emission on
the host only, and defers whole batches to a spill that replays in order
before live traffic.

Observability, as in the JAX engine: the engine registers its series
(``rtfds_batches_total``, ``rtfds_batch_latency_seconds``,
``rtfds_phase_seconds{phase}``, ``rtfds_last_batch_unix_seconds``,
``rtfds_queue_depth`` and the rest, :meth:`_init_telemetry`), opens a span
(``utils/trace.py``) at every phase of a batch under the batch's trace id
— ``source_poll``, ``host_prep``, ``dispatch``, ``result_wait``,
``sink_write``, and ``shadow_score``, ``state_compact``,
``state_promote``, ``precompile`` — each with an NVTX range when the
device is CUDA, and :meth:`run` writes one flight record per finished
batch (its phases, queue depth, latency and trace id). ``scorer="cpu"``
runs the same step, then rescores the fetched features on the host with
``predict_proba_np`` (the oracle), refused where the JAX engine refuses
it.

A checkpoint written at another shard width (``state.layout_devices``)
is converted before the next step (:meth:`ScoringEngine._ensure_layout`),
as the JAX engine does. The sharded engine (N shards in one process,
``runtime/sharded_engine.py``) subclasses this one. The fleet's seams,
armed by the CLI and None elsewhere: ``stop_event`` (a
``threading.Event`` that a SIGTERM sets; :meth:`run` stops at the next
batch boundary with its offsets resumable) and ``cms_exchange``
(``runtime/cms_exchange.py::SketchExchange``, a round at every
checkpoint; :meth:`checkpoint_state` saves the locals-only terminal
sketch). Under a fleet topology a restored cold lineage is re-homed to
the process's residue block. Not ported yet: the sharded sequence step
(A7d).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.config import Config
from real_time_fraud_detection_system_tpu_torch.core import native
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    US_PER_DAY,
    bucket_size,
    fold_key,
    make_batch,
    pack_batch,
    unpack_batch,
)
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.history import (
    init_history_state,
    update_and_score,
)
from real_time_fraud_detection_system_tpu_torch.features.online import (
    FeatureState,
    compact_feature_state,
    init_feature_state,
    promote_rows,
    state_bytes,
    update_and_featurize,
    update_and_featurize_exact,
    update_and_score_fused_forest,
    update_and_score_fused_logreg,
)
from real_time_fraud_detection_system_tpu_torch.features.online import (
    apply_feedback as state_feedback,
)
from real_time_fraud_detection_system_tpu_torch.features.spec import N_FEATURES
from real_time_fraud_detection_system_tpu_torch.models.autoencoder import (
    autoencoder_loss,
    autoencoder_predict_proba,
)
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
    logreg_loss,
    logreg_predict_proba,
    loss_grad,
)
from real_time_fraud_detection_system_tpu_torch.models.mlp import (
    mlp_loss,
    mlp_predict_proba,
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
    leaf_sum_proba,
    to_kernel_tables,
)
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    PoisonRowError,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from real_time_fraud_detection_system_tpu_torch.utils.graph_telemetry import (
    CaptureTelemetry,
    DeviceMemoryTelemetry,
)
from real_time_fraud_detection_system_tpu_torch.utils.logging import (
    get_logger,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    active_recorder,
    get_registry,
)
from real_time_fraud_detection_system_tpu_torch.utils.timing import (
    LatencyTracker,
)
from real_time_fraud_detection_system_tpu_torch.utils.trace import get_tracer

_KINDS = ("logreg", "mlp", "tree", "forest", "gbt", "autoencoder",
          "sequence")
# The serving loop's phases, in order: rtfds_phase_seconds{phase} and the
# flight record's "phases" (the JAX engine's PHASES).
PHASES = ("source_poll", "host_prep", "dispatch", "result_wait",
          "sink_write")
# The kernel wrappers whose launches a captured graph replays.
_WRAPPERS = (forest_kernels.fused_forest_leaf_sum, forest_kernels.leaf_sum,
             score_kernels.fused_featurize_score)
# Side-stream runs of each signature before its capture (lazy inits:
# cuBLAS handles, the autograd engine, the kernels' modules).
WARMUP_RUNS = 2
log = get_logger("engine")


def _require_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown model kind {kind!r} (one of {_KINDS})")


def device_params_for(kind: str, params):
    """Engine-ready params: tree ensembles (a gbt's trees too) convert to
    the GEMM form once, where their depth allows it; the other kinds
    serve their params as they are."""
    _require_kind(kind)
    if kind == "gbt":
        return gbt_for_device(params, N_FEATURES)
    if isinstance(params, TreeEnsemble):
        return for_device(params, N_FEATURES)
    return params


def predict_fn_for(kind: str, z_mode: Optional[str] = None) -> Callable:
    """Plain device predict on scaled feature rows for ``kind``, with a
    RESOLVED ``z_mode`` (only tree ensembles have the contraction it
    selects). The sequence kind has none: it scores from its history
    state (``features/history.py``)."""
    _require_kind(kind)
    if kind == "logreg":
        return logreg_predict_proba
    if kind == "mlp":
        return mlp_predict_proba
    if kind == "autoencoder":
        return autoencoder_predict_proba
    if kind == "gbt":
        return lambda p, x: gbt_predict_proba(p, x, z_mode)
    if kind in ("tree", "forest"):
        return lambda p, x: predict_proba(p, x, z_mode)
    raise ValueError(
        f"model kind {kind!r} has no feature-row predict: it scores from "
        "its per-customer history state")


def loss_fn_for(kind: str) -> Optional[Callable]:
    """The training loss of ``kind``, called ``loss(params, x, y,
    valid)``, or None: tree ensembles and the sequence kind have no
    gradient path here."""
    _require_kind(kind)
    return {"logreg": logreg_loss, "mlp": mlp_loss,
            "autoencoder": autoencoder_loss}.get(kind)


def check_sequence_serving(cfg: Config, online_lr: float = 0.0,
                           feedback: bool = False,
                           shadow: bool = False,
                           scorer: str = "tpu") -> None:
    """The sequence kind's refusals, the JAX engine's with its messages:
    the tiered store, the host scorer, online SGD, bf16 and selective
    emission, the labeled-feedback loop and shadow scoring all need the
    windows plane or a feature matrix, which a history state does not
    have. Raises ValueError."""
    if cfg.features.key_mode == "exact":
        raise ValueError(
            "key_mode='exact' is the windows-plane tiered feature "
            "store; kind='sequence' serves from its own history state "
            "(keep key_mode direct/hash)")
    if scorer == "cpu":
        raise ValueError(
            "kind='sequence' has no sklearn oracle — --scorer cpu does not "
            "apply")
    if online_lr > 0.0:
        raise ValueError("online SGD is not wired for kind='sequence'")
    if cfg.runtime.emit_dtype != "float32":
        raise ValueError(
            "emit_dtype='bfloat16' has no effect for kind='sequence' (no "
            "feature matrix leaves the device); keep float32")
    if cfg.runtime.emit_threshold > 0.0:
        raise ValueError(
            "emit_threshold has no effect for kind='sequence' (no feature "
            "matrix leaves the device); keep 0")
    if feedback:
        raise ValueError(
            "the labeled-feedback loop is not wired for kind='sequence'")
    if shadow:
        raise ValueError(
            "shadow scoring is not wired for kind='sequence' "
            "(no host-side feature matrix to dual-score)")


def feedback_step(loss, params, scaler: Scaler, x_raw: torch.Tensor,
                  y: torch.Tensor, valid: torch.Tensor, lr: float):
    """One trial SGD step on raw feature rows: (new params, loss before,
    loss after), the params out of place. The caller keeps the step only
    when it contracts (``l1 <= l0``), halving ``lr`` otherwise."""
    x = transform(scaler, x_raw)
    l0, g = loss_grad(loss, params, x, y, valid)
    with torch.no_grad():
        new = tree.map(lambda p, gi: p - lr * gi, params, g)
        l1 = loss(new, x, y, valid)
    return new, l0, l1


def host_to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: on CUDA through pinned memory and a
    non-blocking copy on the current stream, so the copy is ordered behind
    the work already enqueued there without the host waiting for it."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def copy_into(dst, src) -> bool:
    """Copy ``src`` into ``dst`` in place when both are the same form
    (tree structure, every tensor leaf's shape, dtype and device, every
    scalar leaf's value); False, copying nothing, otherwise."""
    if tree.structure(dst) != tree.structure(src):
        return False
    a, b = tree.leaves(dst), tree.leaves(src)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor):
            if x.shape != y.shape or x.dtype != y.dtype \
                    or x.device != y.device:
                return False
        elif x != y:
            return False
    with torch.no_grad():
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                x.copy_(y)
    return True


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
    # The live cold-tier segments this state pairs with (io/coldstore.py
    # ColdStore.lineage; None without a cold tier): a checkpoint carries
    # it, and a restore prunes the store to it.
    cold_lineage: Optional[dict] = None
    # Registry version the params descend from (runtime/learner.py); it
    # travels with the checkpoint, so the learning loop can tell restored
    # params from the current champion.
    model_version: Optional[int] = None
    # The shard count the feature state is laid out for (the JAX
    # package's stamp): 1 for this engine, the width for the sharded one.
    # A restore of another width sets it to the checkpoint's and leaves
    # the checkpoint's feature state, as host arrays, in
    # ``layout_pending``; the engine converts it before its next step
    # (``ScoringEngine._ensure_layout``).
    layout_devices: int = 1
    layout_pending: Optional[object] = None
    # The writer's fleet topology (the JAX package's stamps): a fleet
    # process's state holds only its residue block's keys, so a restore
    # refuses a topology change but the 1→P adoption of a global state.
    process_count: int = 1
    process_id: int = 0
    # One record per fleet resize this state has lived through (from/to
    # process counts, reason, the per-old-owner resume floors).
    resize_epochs: Optional[list] = None


@dataclass(frozen=True)
class DispatchSignature:
    """One (shape × static facts) combination the engine can dispatch:
    ``key`` is both the key :meth:`ScoringEngine.precompile` captures a
    graph under and the key :meth:`ScoringEngine._dispatch_step` looks up
    at serve time, so the two cannot drift (the JAX engine's
    ``DispatchSignature`` without its donation and Pallas facts: the
    port updates in place, and its kernels serve whenever admitted)."""

    key: tuple           # graph key == runtime dispatch key
    variant: str         # "step" | "compact" | "promote"
    kind: str            # model kind the step serves
    z_mode: Optional[str]  # resolved z mode (tree-ensemble kinds)
    bucket: int          # padded batch rows (0: not a batch step)
    selective: bool      # selective-emission packing in the step
    emit_dtype: str      # emitted feature matrix dtype


class StepOut(NamedTuple):
    """What one step leaves on the device: ``probs`` float32 [B] (0 on
    padded rows); ``feats`` the emitted [B, 15] matrix (bfloat16 under
    ``emit_dtype="bfloat16"``; None for the sequence kind, whose features
    are zeros made on the host); ``tier`` the exact path's ``[dense,
    cms]`` counts; ``packed`` selective emission's one float32 transfer
    ``[probs(B) | count | idx(cap) | feats(cap·15)]``."""

    probs: torch.Tensor
    feats: Optional[torch.Tensor] = None
    tier: Optional[torch.Tensor] = None
    packed: Optional[torch.Tensor] = None


def pack_selective(probs: torch.Tensor, feats: torch.Tensor,
                   valid: torch.Tensor, threshold: float,
                   cap_fraction: float) -> torch.Tensor:
    """The JAX step's selective-emission packing, fixed-shape and free of
    host syncs (``torch.nonzero`` would read the count back): each
    flagged row's rank is a cumsum, and a scatter into a ``cap + 1``
    buffer of zeros (lane ``cap`` takes the rest) gives
    ``jnp.nonzero(flagged, size=cap, fill_value=0)`` — the first ``cap``
    flagged indices in ascending order, 0 after them."""
    pad = probs.shape[0]
    cap = max(8, int(pad * cap_fraction))
    flagged = valid & (probs >= threshold)
    rank = torch.cumsum(flagged.to(torch.int64), 0) - 1
    lane = torch.where(flagged & (rank < cap), rank,
                       torch.full_like(rank, cap))
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=probs.device)
    idx.scatter_(0, lane, torch.arange(pad, device=probs.device))
    idx = idx[:cap]
    count = flagged.sum().to(torch.float32)
    return torch.cat([probs, count[None], idx.to(torch.float32),
                      feats[idx].reshape(-1)])


class _StepGraph:
    """One captured dispatch signature: the CUDA graph, its static inputs
    (before each replay a tensor argument is copied in, a number filled
    in), its static outputs (cloned right after each replay, so no result
    shares memory with a later replay of any graph of the pool), and the
    launches of each kernel wrapper it recorded, counted at every
    replay."""

    def __init__(self, graph, inputs: list, outputs, launches: dict):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches

    def replay(self, *args):
        for dst, src in zip(self.inputs, args):
            if src is dst:
                continue
            if isinstance(src, torch.Tensor):
                dst.copy_(src, non_blocking=True)
            else:
                dst.fill_(src)
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        return tree.map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        else t, self.outputs)


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
    """Drives source → device step → sink for a model of any kind.

    ``device=None`` means CUDA (raises without a card); ``device="cpu"``
    runs the plain PyTorch path. The feature state is updated in place;
    the params and the scaler are the engine's own copies (a restore
    writes into them). ``host_prep`` names the host-prep route:
    ``"native"`` (the C++ unit built) or ``"numpy"``. ``metrics`` is the
    registry the tiered store reports to (default: the process-wide one).
    ``online_lr > 0`` turns on the in-step online SGD for kinds with a
    gradient path; ``feature_cache`` (``runtime/feedback.py``) keeps the
    emitted rows for the labeled-feedback join; ``dead_letter`` is the
    sink the non-finite guard (``runtime.nan_guard``) quarantines into.
    For the sequence kind ``feature_state`` is a
    ``features/history.py::HistoryState``. ``scorer`` (default
    ``runtime.scorer``) ``"cpu"`` rescores every batch's fetched features
    on the host with ``cpu_model.predict_proba_np`` (an
    ``io/artifacts.py::TrainedModel``) after the step ran unchanged on the
    device. ``recorder`` is the flight record :meth:`run` writes to (None:
    the process-wide ``active_recorder()`` at the run's start).
    """

    # Whether the fused featurize→score kernels may serve the step (the
    # sharded engine's rows get their terminal aggregates through the
    # owner exchange, so it scores through the leaf sum instead).
    _FUSED_STEP = True
    # How delayed labels land in the window state (a subclass's layout
    # may route them otherwise).
    _state_feedback = staticmethod(state_feedback)

    def __init__(
        self,
        cfg: Config,
        kind: str,
        params,
        scaler: Scaler,
        feature_state: Optional[FeatureState] = None,
        device=None,
        metrics=None,
        online_lr: float = 0.0,
        feature_cache=None,
        dead_letter=None,
        scorer: Optional[str] = None,
        cpu_model=None,
    ):
        _require_kind(kind)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kind = kind
        self.online_lr = float(online_lr)
        self._loss = loss_fn_for(kind)
        self.scorer = scorer or cfg.runtime.scorer
        if self.scorer not in ("cpu", "tpu"):
            raise ValueError(f"scorer must be 'cpu' or 'tpu', got "
                             f"{self.scorer!r}")
        if self.scorer == "cpu" and kind != "sequence" and cpu_model is None:
            raise ValueError("scorer='cpu' needs cpu_model= (a TrainedModel "
                             "whose predict_proba_np rescores on the host)")
        self.cpu_model = cpu_model
        self._check_emission(cfg, feature_cache, self.scorer)
        self.feature_cache = feature_cache
        rt = cfg.runtime
        self._selective = rt.emit_threshold > 0.0
        self._emit_bf16 = rt.emit_dtype == "bfloat16"
        # batches whose flagged rows overflowed the compaction cap (each
        # fetched its full matrix instead)
        self.selective_overflows = 0
        # overload rung 2: alerts-only emission, decided on the host
        self._shed_features = False
        self.dead_letter = dead_letter
        self._nan_guard = bool(rt.nan_guard)
        if self._nan_guard and dead_letter is None:
            raise ValueError(
                "runtime.nan_guard needs a dead-letter sink to quarantine "
                "into — pass dead_letter=DeadLetterSink(...) "
                "(CLI: --nan-guard requires --dead-letter)")
        self._twins: Optional[list] = None  # the nan-guard's snapshot
        # the last run's learning loop: its worker thread does device
        # work on its own stream, and holds still while a graph captures
        self._learning = None
        # Learning hooks (runtime/learner.py): a ShadowScorer dual-scores
        # emitted batches; feedback_tap hands labeled rows to the
        # streaming learner. Both None unless a LearningLoop attaches;
        # shadow_paused gates the shadow without detaching it.
        self.shadow = None
        self.feedback_tap = None
        self.shadow_paused = False
        # True once an online update (in-step or feedback SGD) landed
        # since the last wholesale swap: a reload then clobbers it
        self._online_dirty = False
        self.z_mode = resolve_z_mode(cfg.runtime.z_mode, self.device)
        self.metrics = metrics if metrics is not None else get_registry()
        self._init_telemetry()
        # The precompiled step: one CUDA graph per dispatch signature
        # (precompile), the keys done (on the CPU: listed, none
        # captured), the pool they share, the form of the tensors the
        # graphs read (data pointers and baked-in scalars), and whether a
        # change of that form waits for a recapture.
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._precompiled: set = set()
        self._pool = None
        self._graph_form: Optional[tuple] = None
        self._recapture = False
        self._captures = CaptureTelemetry(self.metrics)
        self._devmem = DeviceMemoryTelemetry(self.device, self.metrics)
        self._m_reloads = {
            o: self.metrics.counter(
                "rtfds_model_reloads_total",
                "hot model reloads by outcome (clobbered_online_updates "
                "= the swap discarded on-device online-SGD updates "
                "accumulated since the previous artifact)", outcome=o)
            for o in ("clean", "clobbered_online_updates")
        }
        fcfg = cfg.features
        # Tiered store (key_mode="exact"): slots through the key
        # directories, misses from the sketch tier, compaction every
        # compact_every batches between steps.
        self._exact = fcfg.key_mode == "exact"
        self._compact_every = fcfg.compact_every if self._exact else 0
        self._max_day = 0
        # pending host copies of compaction counts: (event, host, apply)
        self._meters: deque = deque()
        # The host cold tier, armed by _init_cold below.
        self._cold = None  # io.coldstore.ColdStore
        self._promoter = None  # io.coldstore.ColdPromoter
        self._demote_slots = (int(fcfg.cold_demote_slots)
                              if self._exact and fcfg.cold_store else 0)
        self._cold_pending: set = set()  # (table, key) requested, not landed
        self._degraded_keys: set = set()  # served from the sketch meanwhile
        self._cold_index: dict = {}  # table -> sorted uint32 key snapshot
        self._cold_index_version = -1
        self._cold_synced = False
        # The fleet's seams (set by the CLI): the drain event a SIGTERM
        # sets (run() breaks at the next batch boundary) and the
        # cross-process terminal-sketch exchange, run at checkpoints.
        self.stop_event = None
        self.cms_exchange = None
        if kind == "sequence":
            self._init_sequence(params, scaler, feature_state)
        else:
            self._check_state_budget()
            self._init_state_telemetry()
            params = tree.clone(device_params_for(
                kind, tree.to(params, self.device)))
            self.state = EngineState(
                feature_state=feature_state
                or init_feature_state(cfg.features, self.device),
                params=params,
                scaler=tree.clone(scaler.to(self.device)),
            )
            self._predict = predict_fn_for(kind, self.z_mode)
            # the fused kernels read the customer table and know nothing
            # of the sketch tier: only direct and hash keys on the table
            # take them
            self._fused = (self._FUSED_STEP
                           and cfg.features.customer_source == "table"
                           and not self._exact)
            self._derive_tables()
        self.host_prep = ("native" if native.hostprep_available()
                          else "numpy")
        cuda = self.device.type == "cuda"
        self._staging = (_StagingRing(max(1, cfg.runtime.pipeline_depth) + 1)
                         if cuda else None)
        self._d2h_stream = (torch.cuda.Stream(self.device)
                            if cuda and cfg.runtime.fetch_overlap else None)
        if self._demote_slots:
            self._init_cold(fcfg)

    def _init_telemetry(self) -> None:
        """The JAX engine's series, resolved once (the loop then pays one
        call per event). Where a JAX name has no direct counterpart:

        - ``rtfds_precompiled_steps_total`` counts the CUDA graphs
          :meth:`precompile` captured (the JAX engine's AOT executables);
        - ``rtfds_aot_fallbacks_total`` counts dispatches, after a
          precompile captured graphs, whose signature had no graph and ran
          eagerly (the JAX engine's fallback from an AOT executable to jit);
        - ``rtfds_fetch_overlap_seconds_total`` adds up, per batch, the
          time from the side-stream result copies' issue to the loop's
          wait for them (the head start the copy got);
        - ``rtfds_z_mode{mode}`` is 1 for the dtype of the tree kinds'
          dense path table (``runtime.z_mode``) and ``rtfds_use_pallas``
          1 when the step takes one of the hand-written kernels (the fused
          forest or logreg kernel, or the leaf sum), the port's
          counterpart of the JAX engine's opt-in Pallas path;
        - the JAX ``rtfds_xla_*`` compile series are left out: nothing is
          compiled while the port serves (its kernels build before the
          first batch, its graphs are captured by :meth:`precompile`, in
          ``cuda_graph_captures_total`` and
          ``cuda_graph_recaptures_total``).
        """
        reg = self.metrics
        self.recorder = None
        self.tracer = get_tracer()
        # NVTX ranges beside the spans: decided once, by the device
        self._nvtx = self.device.type == "cuda"
        self._m_batches = reg.counter("rtfds_batches_total",
                                      "micro-batches scored")
        # the overload ladder's scored side of scored + deferred == polled
        self._m_rows = reg.counter("rtfds_rows_total", "rows scored")
        self._m_lat = reg.histogram(
            "rtfds_batch_latency_seconds",
            "end-to-end micro-batch latency (poll wait excluded)")
        self._m_phase = {
            ph: reg.histogram("rtfds_phase_seconds",
                              "per-batch loop-time decomposition by phase",
                              phase=ph)
            for ph in PHASES}
        self._m_last = reg.gauge(
            "rtfds_last_batch_unix_seconds",
            "wall-clock time the last batch finished (healthz input)")
        self._m_qdepth = reg.gauge("rtfds_queue_depth",
                                   "micro-batches currently in flight")
        self._m_precompiled = reg.counter(
            "rtfds_precompiled_steps_total",
            "dispatch signatures captured as CUDA graphs by precompile")
        self._m_aot_fallbacks = reg.counter(
            "rtfds_aot_fallbacks_total",
            "dispatches after precompile whose signature had no captured "
            "graph (served eagerly)")
        self._m_fetch_overlap = reg.counter(
            "rtfds_fetch_overlap_seconds_total",
            "seconds from the side-stream result copies' issue to the "
            "loop's wait for them")
        self._m_zmode = {
            m: reg.gauge(
                "rtfds_z_mode",
                "dtype of the tree kinds' dense path table (1 = the "
                "active mode)", mode=m)
            for m in ("f32", "bf16", "int8")}
        for m, g in self._m_zmode.items():
            g.set(1.0 if m == self.z_mode else 0.0)
        self._m_use_pallas = reg.gauge(
            "rtfds_use_pallas",
            "1 when the step launches a hand-written CUDA kernel (on the "
            "CPU: its plain version)")

    @staticmethod
    def _check_emission(cfg: Config, feature_cache,
                        scorer: str = "tpu") -> None:
        """The JAX engine's emission checks, with its messages: what the
        host re-consumes (the CPU scorer, a feature cache) needs every
        row's float32 features. Raises ValueError."""
        rt = cfg.runtime
        host_rows = scorer == "cpu" or feature_cache is not None
        if rt.emit_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"emit_dtype must be float32|bfloat16, "
                             f"got {rt.emit_dtype!r}")
        if host_rows and not rt.emit_features:
            raise ValueError(
                "emit_features=False (alerts-only serving) cannot be "
                "combined with --scorer cpu or a feature cache: both "
                "consume host-side feature rows")
        if rt.emit_dtype != "float32" and host_rows:
            raise ValueError(
                "emit_dtype='bfloat16' is lossy on the emitted feature "
                "columns; --scorer cpu and the feedback feature cache "
                "re-consume those rows and would drift — keep float32")
        thresh = float(rt.emit_threshold)
        if not 0.0 <= thresh <= 1.0:
            raise ValueError(
                f"emit_threshold must be in [0, 1], got {thresh}")
        if thresh > 0.0 and not rt.emit_features:
            raise ValueError(
                "emit_threshold > 0 (selective emission) contradicts "
                "emit_features=False (alerts-only): pick one")
        if thresh > 0.0:
            if host_rows:
                raise ValueError(
                    "selective emission (emit_threshold > 0) cannot be "
                    "combined with --scorer cpu or a feature cache: both "
                    "consume every row's features host-side")
            if rt.emit_dtype != "float32":
                raise ValueError(
                    "selective emission already cuts feature D2H by "
                    "~1/emit_cap_fraction; emit_dtype='bfloat16' is not "
                    "supported on the packed selective transfer — keep "
                    "float32")
            if not 0.0 < rt.emit_cap_fraction <= 1.0:
                raise ValueError(
                    "emit_cap_fraction must be in (0, 1], got "
                    f"{rt.emit_cap_fraction}")

    def _init_sequence(self, params, scaler, feature_state) -> None:
        """kind='sequence': the history state and its step, with the JAX
        engine's refusals. The emitted feature matrix is zeros (the
        transformer reads raw event channels, not the engineered
        features), so the analyzed schema stays the same for sinks."""
        cfg = self.cfg
        check_sequence_serving(cfg, self.online_lr,
                               feedback=self.feature_cache is not None,
                               scorer=self.scorer)
        self._m_tier = None
        self._predict = None
        self._fused = False
        self.tables = self.leaf_tables = None
        self.state = EngineState(
            feature_state=feature_state
            or init_history_state(cfg.features, self.device),
            params=tree.clone(tree.to(params, self.device)),
            scaler=tree.clone(scaler.to(self.device)),
        )
        self._tables_epoch = self.state.params_epoch

    def _derive_tables(self) -> None:
        """The kernels' tables, from the live params' shapes where
        ``admit_tables`` admits a GEMM-form ensemble: ``tables`` for the
        fused forest kernel (tree and forest kinds on the customer
        table), ``leaf_tables`` for the leaf-sum kernel (gbt, and tree
        and forest on the sketch or the tiered store); both None
        otherwise. Derived at build and again after a restore or a swap
        that brought other params: tables of the same form as the ones
        there are copied into them in place (the captured graphs read
        them by pointer)."""
        tables: Optional[ForestTables] = None
        leaf_tables: Optional[ForestTables] = None
        params = self.state.params
        trees = params.trees if isinstance(params, GBTModel) else params
        if isinstance(trees, GemmEnsemble) and admit_tables(trees).fits:
            if self.kind == "gbt" or not self._fused:
                leaf_tables = to_kernel_tables(trees, self.z_mode)
            else:
                tables = to_kernel_tables(trees, self.z_mode)
        old = getattr(self, "tables", None)
        self.tables = (old if old is not None and tables is not None
                       and copy_into(old, tables) else tables)
        old = getattr(self, "leaf_tables", None)
        self.leaf_tables = (old if old is not None and leaf_tables is not None
                            and copy_into(old, leaf_tables) else leaf_tables)
        self._tables_epoch = self.state.params_epoch
        self._m_use_pallas.set(float(
            self.tables is not None or self.leaf_tables is not None
            or (self.kind == "logreg" and self._fused)))
        if self.device.type == "cuda":
            self._load_kernels()

    def _load_kernels(self) -> None:
        """Build and load the kernel libraries the step launches (once per
        process), so one that does not build or load raises here: from
        the constructor, outside the recovery supervisor's restarts, and
        never from a supervised step."""
        if self.kind == "logreg" and self._fused:
            score_kernels._library()
        if self.tables is not None:
            forest_kernels._library()
        if self.leaf_tables is not None:
            forest_kernels._leaf_sum_library()

    def checkpoint_state(self) -> EngineState:
        """The state a checkpoint save persists: the engine's own, or,
        with a sketch exchange that adopted peer content, a shallow copy
        whose ``terminal_cms`` holds the locals-only partial (so the P→1
        resize merge's same-day sketch sum stays exact whenever the last
        round ran)."""
        xch = self.cms_exchange
        fs = self.state.feature_state
        if xch is None or fs is None or fs.terminal_cms is None:
            return self.state
        partial = xch.checkpoint_cms(fs.terminal_cms)
        if partial is None:
            return self.state
        view = dataclasses.replace(self.state)
        view.feature_state = fs._replace(terminal_cms=partial)
        return view

    def _maybe_exchange_cms(self) -> None:
        """One terminal-sketch exchange round (at a checkpoint, between
        steps): publish this process's cumulative local contributions,
        adopt the peers' partials present, and write the merged view into
        the serving sketch's tensors in place."""
        xch = self.cms_exchange
        fs = self.state.feature_state
        if xch is None or fs is None or fs.terminal_cms is None:
            return
        from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
            _wait_ready,
        )
        from real_time_fraud_detection_system_tpu_torch.runtime \
            .cms_exchange import install_logical

        _wait_ready(self.state)
        merged = xch.exchange(fs.terminal_cms)
        if merged is None:
            return
        new = install_logical(fs.terminal_cms, merged)
        for dst, src in zip(fs.terminal_cms, new):
            if dst is not None:
                dst.copy_(torch.as_tensor(np.asarray(src)).to(dst.dtype))

    def _unfused_predict(self, x: torch.Tensor) -> torch.Tensor:
        """The predict of the unfused step on scaled features ``x``."""
        tables = self.leaf_tables
        if tables is None:
            return self._predict(self.state.params, x)
        return leaf_sum_proba(tables, x, self.state.params.base_score
                              if self.kind == "gbt" else None)

    def _step(self, packed: torch.Tensor) -> StepOut:
        """One device step on a packed batch: what a captured graph
        records and an eager dispatch runs. Everything here is enqueued
        on the current stream without a host sync; the host's share of a
        batch (the tables' re-derive, ``params_crcs``, events) runs
        around it in :meth:`_start_batch`."""
        batch = unpack_batch(packed)
        if self.kind == "sequence":
            _, probs = update_and_score(self.state.feature_state,
                                        self.state.params, batch,
                                        self.cfg.features)
            return StepOut(probs)
        fcfg = self.cfg.features
        scaler = self.state.scaler
        params = self.state.params
        tables = self.tables
        tier = None
        if self._exact:
            fstate, feats, tier = update_and_featurize_exact(
                self.state.feature_state, batch, fcfg)
            probs = self._unfused_predict(transform(scaler, feats))
        elif self.kind == "logreg" and self._fused:
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
        if self.online_lr > 0.0 and self._loss is not None:
            self._online_sgd(batch, transform(scaler, feats))
        probs = torch.where(batch.valid, probs, torch.zeros_like(probs))
        if self._emit_bf16:
            # half the emitted bytes; the classifier above read float32
            feats = feats.to(torch.bfloat16)
        packed_out = None
        if self._selective:
            rt = self.cfg.runtime
            packed_out = pack_selective(probs, feats, batch.valid,
                                        float(rt.emit_threshold),
                                        rt.emit_cap_fraction)
        return StepOut(probs, feats, tier, packed_out)

    def _online_sgd(self, batch, x: torch.Tensor) -> None:
        """The in-step SGD on the batch's in-band labels: the gradient on
        the params this step served with, then ``p -= lr·has·g`` in place
        on the step's stream (``has`` stays on the device: no sync)."""
        labeled = batch.valid & (batch.label >= 0)
        y = torch.clamp(batch.label, min=0)
        params = self.state.params
        _, g = loss_grad(self._loss, params, x, y, labeled)
        has = torch.any(labeled).to(torch.float32)
        with torch.no_grad():
            for p, gi in zip(tree.leaves(params), tree.leaves(g)):
                p.sub_(self.online_lr * has * gi)

    # -- tiered feature store (key_mode="exact") ---------------------------

    def _state_shards(self) -> int:
        """The shard count the feature state is laid out for (and
        ``state_bytes`` accounts: a sketch per shard): 1 here, the
        sharded engine's width there."""
        return 1

    def _check_state_budget(self) -> None:
        """``features.state_hbm_budget_mb``: fail the build, not the
        stream, when the configured feature state cannot fit the budget
        (``features/online.py::state_bytes``)."""
        fcfg = self.cfg.features
        if fcfg.state_hbm_budget_mb <= 0:
            return
        sb = state_bytes(fcfg, n_shards=self._state_shards())
        budget = int(fcfg.state_hbm_budget_mb * 2 ** 20)
        if sb["total"] > budget:
            raise ValueError(
                f"feature state needs {sb['total']} bytes "
                f"(dense {sb['dense']}, directory {sb['directory']}, "
                f"cms {sb['cms']}) against a state_hbm_budget_mb="
                f"{fcfg.state_hbm_budget_mb:g} budget ({budget} bytes) — "
                "shrink the hot tier (customer_capacity/"
                "terminal_capacity), the sketch (cms_width), or raise "
                "the budget")

    def _init_state_telemetry(self) -> None:
        """The tiered store's series, under the JAX engine's names:
        registered only when the tiers are live (bytes gauges also when a
        budget is set)."""
        reg = self.metrics
        fcfg = self.cfg.features
        self._m_tier = None
        self._m_slots_occ: dict = {}
        self._m_slots_rec: dict = {}
        if self._exact:
            self._m_tier = {
                t: reg.counter(
                    "rtfds_feature_tier_rows_total",
                    "row x keyspace feature reads served per tier "
                    "(dense = private hot-tier slot; cms = count-min "
                    "sketch fallback after an admission miss)", tier=t)
                for t in ("dense", "cms")}
            for t in self._dir_tables():
                self._m_slots_occ[t] = reg.gauge(
                    "rtfds_feature_slots_occupied",
                    "hot-tier slots currently owned by a key "
                    "(updated at compaction cadence)", table=t)
                self._m_slots_rec[t] = reg.counter(
                    "rtfds_feature_slots_reclaimed_total",
                    "hot-tier slots reclaimed by recency compaction "
                    "(the slot held only history older than "
                    "delay + max(window))", table=t)
        if self._exact or fcfg.state_hbm_budget_mb > 0:
            sb = state_bytes(fcfg, n_shards=self._state_shards())
            for tier in ("dense", "directory", "cms", "total"):
                reg.gauge(
                    "rtfds_feature_state_bytes",
                    "device bytes of the configured feature state per "
                    "tier (static accounting, features/online.state_bytes)",
                    tier=tier).set(float(sb[tier]))
            reg.gauge(
                "rtfds_feature_state_budget_bytes",
                "configured feature-state budget "
                "(state_hbm_budget_mb; 0 = unchecked)").set(
                float(fcfg.state_hbm_budget_mb * 2 ** 20))

    def _dir_tables(self) -> tuple:
        """The tables with a key directory (demotable, promotable)."""
        if self.cfg.features.customer_source == "cms":
            return ("terminal",)
        return ("customer", "terminal")

    def _note_batch_days(self, cols: dict) -> None:
        """The newest day the stream has seen: compaction's cutoff."""
        if not self._compact_every:
            return
        us = cols.get("tx_datetime_us")
        if us is not None and len(us):
            self._max_day = max(self._max_day, int(np.max(us) // US_PER_DAY))

    def _maybe_compact(self) -> None:
        """The recency compaction, every ``compact_every`` finished
        batches, between steps and on the step's stream: it is enqueued
        behind every step launched so far (at depth 2, batch N+1's too,
        as the JAX engine's data dependence orders it), and the next
        step serves the compacted state."""
        if (not self._compact_every
                or self.state.batches_done % self._compact_every != 0):
            return
        with self.tracer.span("state_compact", day=self._max_day,
                              nvtx=self._nvtx):
            # the day goes in as a kernel argument (a fill of the graph's
            # static day): no host-to-device copy
            out = self._dispatch_step(("compact",), self._compact_body,
                                      self._max_day)
            if self._demote_slots:
                self._append_demotions(dict(zip(("customer", "terminal"),
                                                out[1])))
            self._record_compaction(out[0])

    def _compact_pass(self, fstate, day):
        """The recency compaction over the state, IN PLACE (the sharded
        engine's runs per shard): ``features/online.py::
        compact_feature_state``'s return."""
        return compact_feature_state(fstate, day, self.cfg.features,
                                     demote_slots=self._demote_slots)

    def _compact_body(self, day) -> tuple:
        """The compaction signature's device work: ``(reclaimed,)``, and
        with a cold tier ``(reclaimed, (customer payload, terminal
        payload))``, a payload None for a table without a directory."""
        out = self._compact_pass(self.state.feature_state, day)
        if not self._demote_slots:
            return (out[1],)
        return out[1], (out[2]["customer"], out[2]["terminal"])

    def _record_compaction(self, reclaimed: torch.Tensor) -> None:
        """Meter one compaction: the reclaimed counts (``[2]``, or ``[n,
        2]`` per shard) and the occupancy come to the host through a
        side-stream copy, read once it has landed (:meth:`_drain_meters`),
        never through a sync."""
        fs = self.state.feature_state
        dirs = {t: getattr(fs, f"{t}_dir") for t in self._dir_tables()}
        n = self._state_shards()
        vals = torch.cat([reclaimed.to(torch.int32).reshape(-1)] + [
            (kd.free.shape[-1] - kd.free_top.reshape(-1)).to(torch.int32)
            for kd in dirs.values()])
        capacity = sum(kd.free.numel() for kd in dirs.values())
        batch = self.state.batches_done

        def apply(v: np.ndarray) -> None:
            rec = v[:2 * n].reshape(n, 2)
            occ = dict(zip(dirs, v[2 * n:].reshape(len(dirs), n)))
            for i, table in enumerate(("customer", "terminal")):
                if table in dirs:
                    self._m_slots_rec[table].inc(int(rec[:, i].sum()))
            occupied = {t: int(o.sum()) for t, o in occ.items()}
            for table, o in occupied.items():
                self._m_slots_occ[table].set(o)
            extra = self._meter_shards(rec, occ)
            recorder = active_recorder()
            if recorder is not None:
                if self._cold is not None:
                    extra.update(cold_keys=int(self._cold.keys_count),
                                 cold_bytes=int(self._cold.bytes),
                                 promote_backlog=int(
                                     self._promoter.backlog()))
                recorder.record_event(
                    "feature_state", reclaimed=int(rec.sum()),
                    occupied=sum(occupied.values()), capacity=capacity,
                    dense_rows=self._m_tier["dense"].value,
                    cms_rows=self._m_tier["cms"].value, batch=batch,
                    **extra)

        if self.device.type != "cuda":
            apply(vals.numpy())
            return
        done = torch.cuda.Event()
        done.record()
        side = self._d2h_stream or torch.cuda.current_stream(self.device)
        side.wait_event(done)
        host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            host.copy_(vals, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(side)
        # vals stays referenced until the copy has landed
        self._meters.append((landed, host, apply, vals))

    def _meter_shards(self, reclaimed: np.ndarray,
                      occupied: dict) -> dict:
        """The sharded engine's per-shard series of one compaction, and
        what they add to its flight event: none here."""
        return {}

    def _drain_meters(self, wait: bool = False) -> None:
        """Apply the compaction meters whose host copies have landed (all
        of them, waiting, with ``wait``)."""
        while self._meters:
            landed, host, apply, _ = self._meters[0]
            if not wait and not landed.query():
                return
            landed.synchronize()
            self._meters.popleft()
            apply(host.numpy())

    # -- host cold tier (features.cold_store) ------------------------------

    def _init_cold(self, fcfg) -> None:
        """Arm the host cold tier: the keyed store, the promoter thread
        and their metrics."""
        from real_time_fraud_detection_system_tpu_torch.io.coldstore import (
            ColdPromoter,
            ColdStore,
        )

        self._cold = ColdStore(fcfg.cold_store,
                               segment_mb=fcfg.cold_segment_mb)
        self._promoter = ColdPromoter(self._cold,
                                      depth=fcfg.cold_promote_queue)
        reg = self.metrics
        self._m_cold_keys = reg.gauge(
            "rtfds_feature_cold_keys",
            "keys resident in the host cold tier (demoted, not yet "
            "promoted back)")
        self._m_cold_bytes = reg.gauge(
            "rtfds_feature_cold_bytes",
            "host bytes of live cold-tier segments + flush buffer")
        self._m_cold_prom = reg.counter(
            "rtfds_feature_cold_promotions_total",
            "cold-tier keys promoted back into the hot tier")
        self._m_cold_dem = reg.counter(
            "rtfds_feature_cold_demotions_total",
            "hot-tier keys demoted to the cold tier by compaction "
            "pressure eviction")
        self._m_cold_wait = reg.counter(
            "rtfds_feature_cold_promote_wait_seconds_total",
            "seconds between a returning key's promotion request and "
            "its rows landing in the hot tier")
        self._m_cold_backlog = reg.gauge(
            "rtfds_feature_cold_promote_backlog",
            "promotion requests enqueued or resolved but not yet "
            "landed on device (overload-ladder pressure input)")
        reg.gauge(
            "rtfds_feature_cold_promote_queue_limit",
            "bounded capacity of the cold promoter request queue "
            "(features.cold_promote_queue)").set(
            float(fcfg.cold_promote_queue))

    def _cold_gauges(self) -> None:
        self._m_cold_keys.set(float(self._cold.keys_count))
        self._m_cold_bytes.set(float(self._cold.bytes))

    def _note_cold_touches(self, cols: dict) -> None:
        """Returning-key detection on the host: the host wrote the cold
        store, so it intersects the batch's folded keys with a sorted
        snapshot of the cold index (rebuilt when the index changes) and
        requests the hits from the promoter. The rows are served from
        the sketch tier meanwhile (``exactness_degraded_keys``) and
        become exact again when the promotion lands."""
        if self._cold is None:
            return
        ver = self._cold.version()
        if ver != self._cold_index_version:
            self._cold_index = {t: self._cold.index_snapshot(t)
                                for t in self._dir_tables()}
            self._cold_index_version = ver
        for table, col in (("customer", "customer_id"),
                           ("terminal", "terminal_id")):
            snap = self._cold_index.get(table)
            ids = cols.get(col)
            if snap is None or not snap.size or ids is None or not len(ids):
                continue
            keys = fold_key(np.asarray(ids))
            # the directory's canonical form of EMPTY_KEY (ops/keydir.py)
            keys = np.where(keys == np.uint32(0xFFFFFFFF),
                            np.uint32(0xFFFFFFFE), keys)
            for k in np.unique(keys[np.isin(keys, snap)]):
                ki = int(k)
                self._degraded_keys.add((table, ki))
                if (table, ki) in self._cold_pending:
                    continue  # already in flight
                if self._promoter.request(table, ki):
                    self._cold_pending.add((table, ki))
                # a full queue drops the request: the key asks again on
                # its next touch
        self._m_cold_backlog.set(float(self._promoter.backlog()))

    def _append_demotions(self, payload: dict) -> None:
        """Land one compaction's demotion payload in the cold store (the
        copy to the host waits for the compaction). A demoted key with a
        promotion in flight has it cancelled: its resolved rows predate
        this demotion, and its next touch promotes the newer ones."""
        total = 0
        for table in ("customer", "terminal"):
            pay = payload.get(table)
            if pay is None:
                continue
            keys, *rows = (t.cpu().numpy() for t in pay)
            # a sharded payload is stacked [n, K, ...]: its lanes in order
            keys = keys.reshape(-1)
            rows = [r.reshape(len(keys), -1) for r in rows]
            total += self._cold.append(table, keys, *rows)
            for k in keys[keys != np.uint32(0xFFFFFFFF)]:
                self._cold_pending.discard((table, int(k)))
        if total:
            self._m_cold_dem.inc(total)
        self._cold_gauges()

    def _promote_arrays(self, rows_by_table: dict) -> list:
        """Resolved cold rows → the fixed-shape promote payload on the
        host, flat: per table with a directory, ``EMPTY_KEY``-padded keys
        (their int32 bits) [K], bucket_day int32 [K, NB] and count,
        amount, fraud float32 [K, NB]. A state of stacked directories
        (the sharded engine's) takes ``[n, K, ...]`` lanes, key k in
        shard ``k % n``'s (the modulo the partitioner and the exchange
        route by, so a key demoted by shard i promotes back into it);
        ``poll_ready(max_items=K)`` bounds a promotion at K keys, so even
        one shard's lanes hold them all."""
        k = self._demote_slots
        nb = self.cfg.features.n_day_buckets
        n = self._state_shards()
        stacked = self.state.feature_state.terminal_dir.keys.dim() == 2
        flat = []
        for table in self._dir_tables():
            keys = np.full((n, k), 0xFFFFFFFF, np.uint32)
            bd = np.full((n, k, nb), -1, np.int32)
            cnt = np.zeros((n, k, nb), np.float32)
            amt = np.zeros((n, k, nb), np.float32)
            frd = np.zeros((n, k, nb), np.float32)
            fill = [0] * n
            for key, r in (rows_by_table.get(table) or {}).items():
                sh = int(key) % n
                i, fill[sh] = fill[sh], fill[sh] + 1
                keys[sh, i] = key
                bd[sh, i], cnt[sh, i], amt[sh, i], frd[sh, i] = r
            arrays = [keys.view(np.int32), bd, cnt, amt, frd]
            flat += arrays if stacked else [a[0] for a in arrays]
        return flat

    def _promote_pass(self, fstate, payload: dict):
        """Land a promote payload in the state, IN PLACE (the sharded
        engine's lands each shard's lanes in its shard):
        ``features/online.py::promote_rows``'s return."""
        return promote_rows(fstate, payload, self.cfg.features)

    def _promote_body(self, *flat: torch.Tensor) -> torch.Tensor:
        """The promotion signature's device work on the flat payload of
        :meth:`_promote_arrays`: the stats int32 [2, 2] (``[n, 2, 2]``
        per shard)."""
        it = iter(flat)
        tables = self._dir_tables()
        payload = {t: ((next(it).view(torch.uint32), next(it), next(it),
                        next(it), next(it)) if t in tables else None)
                   for t in ("customer", "terminal")}
        return self._promote_pass(self.state.feature_state, payload)[1]

    def _maybe_promote(self) -> None:
        """Land resolved promotions between steps (after
        ``_maybe_compact``): drain the promoter's ready queue up to the
        payload width, merge the rows on the step's stream, and retire
        the landed keys from the cold index."""
        if self._promoter is None:
            return
        ready = self._promoter.poll_ready(max_items=self._demote_slots)
        self._m_cold_backlog.set(float(self._promoter.backlog()))
        if not ready:
            return
        rows_by_table: dict = {"customer": {}, "terminal": {}}
        wait = 0.0
        now = time.perf_counter()
        for table, key, rows, t_enq in ready:
            if (table, key) not in self._cold_pending:
                continue  # cancelled (demoted again) or fenced
            self._cold_pending.discard((table, key))
            wait += now - t_enq
            if rows is None:
                continue  # corrupt segment: stays on the sketch, counted
            rows_by_table[table][key] = rows
        if wait > 0.0:
            self._m_cold_wait.inc(wait)
        if not any(rows_by_table.values()):
            return
        with self.tracer.span("state_promote", nvtx=self._nvtx):
            flat = [torch.from_numpy(a) for a in
                    self._promote_arrays(rows_by_table)]
            if ("promote",) not in self._graphs:
                flat = [t.to(self.device) for t in flat]
            stats = self._dispatch_step(("promote",), self._promote_body,
                                        *flat)
            # [2, 2] per table, or [n, 2, 2] per shard: summed over shards
            st = stats.cpu().numpy().reshape(-1, 2, 2).sum(axis=0)
        self._m_cold_prom.inc(int(st[:, 0].sum()))
        for i, table in enumerate(("customer", "terminal")):
            landed = list(rows_by_table[table])
            if landed and int(st[i, 1]) == 0:
                # every lane admitted: retire the keys from the index
                # (else they stay cold and promote on their next touch;
                # the merge is idempotent)
                self._cold.mark_promoted(table, landed)
        self._cold_gauges()

    def drain_promotions(self, timeout_s: float = 10.0) -> bool:
        """Block until every pending promotion has landed (tests and
        shutdown; the serving loop never waits for one). True when the
        pending set drained within the timeout."""
        if self._promoter is None:
            return True
        t0 = time.perf_counter()
        while self._cold_pending:
            self._maybe_promote()
            if not self._cold_pending:
                break
            if time.perf_counter() - t0 > timeout_s:
                return False
            time.sleep(0.005)
        return True

    def _sync_cold_after_restore(self) -> None:
        """Adopt a restored checkpoint's cold lineage once: prune the
        segments written after it (replay writes them again), fence the
        promoter's generation and drop the pending requests."""
        if self._cold is None or self._cold_synced:
            return
        lineage = self.state.cold_lineage
        if lineage is None:
            return
        self._cold_synced = True
        self._cold.sync_to(lineage)
        topo = getattr(self, "topology", None)
        if topo is not None and topo.n_processes > 1:
            # a resize: the adopted lineage may hold keys the new
            # topology homes elsewhere (a consolidated shrink store fanned
            # back out); cold keys are directory keys, so keep this
            # process's residue block and let the owners promote the rest
            # from their own copies
            dropped = self._cold.rehome(lambda _t, ks: topo.owns(ks))
            if dropped:
                log.info(
                    "cold tier re-homed for process %d/%d: dropped %d "
                    "foreign key(s)", topo.process_id, topo.n_processes,
                    dropped)
        self._promoter.reset()
        self._cold_pending.clear()
        self._cold_index_version = -1
        self._cold_gauges()
        self._m_cold_backlog.set(0.0)

    def fence_cold(self) -> None:
        """Cut this engine off the cold store: stop its promoter and
        refuse its further writes. The recovery supervisor calls it on an
        incarnation it abandons or that crashed, so a zombie never writes
        a segment under the next incarnation's store."""
        if self._cold is None:
            return
        self._promoter.close()
        self._cold.fence()

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

    # -- the precompiled step (dispatch inventory, CUDA graphs) -----------

    def dispatch_inventory(self) -> List[DispatchSignature]:
        """Every dispatch signature this engine can serve, the JAX
        engine's list for the same config: ``("step", 7, bucket)`` for
        each ``runtime.batch_buckets`` size, ``("compact",)`` with a
        compaction cadence, ``("promote",)`` with a cold tier.
        :meth:`precompile` captures exactly this list and
        :meth:`_dispatch_step` looks its keys up."""
        zmode_kinds = ("tree", "forest", "gbt")
        rt = self.cfg.runtime
        sigs = [DispatchSignature(
            key=("step", 7, int(b)), variant="step", kind=self.kind,
            z_mode=self.z_mode if self.kind in zmode_kinds else None,
            bucket=int(b), selective=self._selective,
            emit_dtype=rt.emit_dtype)
            for b in sorted(set(rt.batch_buckets))]
        for variant, on in (("compact", self._compact_every),
                            ("promote", self._demote_slots)):
            if on:
                sigs.append(DispatchSignature(
                    key=(variant,), variant=variant, kind=self.kind,
                    z_mode=None, bucket=0, selective=False,
                    emit_dtype=rt.emit_dtype))
        return sigs

    def signature_step(self, sig: DispatchSignature) -> Callable:
        """The callable ``sig`` dispatches to (eagerly, or recorded into
        its graph)."""
        if sig.variant == "compact":
            return self._compact_body
        if sig.variant == "promote":
            return self._promote_body
        return lambda packed: self._step(packed)

    def _static_inputs(self, sig: DispatchSignature) -> list:
        """The graph's input tensors, allocated outside the graphs' pool;
        their contents here (every row invalid, day 0, an empty payload)
        are what the warmup runs on."""
        dev = self.device
        if sig.variant == "step":
            return [torch.zeros((7, sig.bucket), dtype=torch.int32,
                                device=dev)]
        if sig.variant == "compact":
            return [torch.zeros((), dtype=torch.int32, device=dev)]
        return [torch.from_numpy(a).to(dev)
                for a in self._promote_arrays({})]

    def precompile(self) -> dict:
        """Capture one CUDA graph per :meth:`dispatch_inventory` signature
        not captured yet, all in one memory pool, and serve every later
        dispatch of it by replay. Each signature first runs
        ``WARMUP_RUNS`` times on a side stream against scratch copies of
        the feature state and the params, so the live state, params and
        counters stay as they were; the capture records without running.
        A capture that fails raises (dispatch never falls back). On the
        CPU nothing is captured and the signatures are listed as done.

        Returns the JAX engine's manifest (``buckets`` of the signatures
        done now, ``variants``, ``seconds``) with ``graphs`` (the graphs
        held) and ``pool_bytes`` (the device bytes of their pool; None
        when the allocator's snapshot does not name pools)."""
        t0 = time.perf_counter()
        self._ensure_layout()  # the graphs read the converted state
        sigs = [sg for sg in self.dispatch_inventory()
                if sg.key not in self._precompiled]
        if self.device.type == "cuda" and sigs:
            with self.tracer.span("precompile", nvtx=self._nvtx):
                self._note_params_swap()
                self._capture(sigs)
            self._captures.warm = True
        self._precompiled.update(sg.key for sg in sigs)
        self._recapture = False
        return {"buckets": [sg.bucket for sg in sigs], "variants": 1,
                "seconds": round(time.perf_counter() - t0, 3),
                "graphs": len(self._graphs),
                "pool_bytes": self.graph_pool_bytes()}

    def _capture(self, sigs: List[DispatchSignature]) -> None:
        """Warm up and capture ``sigs`` with the learning loop's worker
        held idle. Capture errors only on this thread's unsafe calls
        (``thread_local``): the sink writer and the supervisor's threads
        go on beside it."""
        hold = (self._learning.held() if self._learning is not None
                else contextlib.nullcontext())
        with hold:
            self._capture_held(sigs)

    def _capture_held(self, sigs: List[DispatchSignature]) -> None:
        inputs = {sg.key: self._static_inputs(sg) for sg in sigs}
        live = self.state
        scratch = dataclasses.replace(
            live, feature_state=tree.clone(live.feature_state),
            params=tree.clone(live.params))
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        self.state = scratch
        try:
            with torch.cuda.stream(side):
                for sg in sigs:
                    for _ in range(WARMUP_RUNS):
                        self.signature_step(sg)(*inputs[sg.key])
        finally:
            self.state = live
        cur.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        for sg in sigs:
            before = [w.captured for w in _WRAPPERS]
            graph = torch.cuda.CUDAGraph()
            t = time.perf_counter()
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = self.signature_step(sg)(*inputs[sg.key])
            launches = {w: w.captured - n for w, n in zip(_WRAPPERS, before)
                        if w.captured != n}
            self._graphs[sg.key] = _StepGraph(graph, inputs[sg.key], out,
                                              launches)
            self._captures.note(sg.key, time.perf_counter() - t)
            self._m_precompiled.inc()
        self._graph_form = self._form()

    def _form(self) -> tuple:
        """What the graphs bake in: the data pointer of every tensor they
        read or write (feature state, params, scaler, kernel tables) and
        the value of every other leaf (tree counts, depths, z modes)."""
        return tuple(
            leaf.data_ptr() if isinstance(leaf, torch.Tensor) else leaf
            for t in (self.state.feature_state, self.state.params,
                      self.state.scaler, self.tables, self.leaf_tables)
            for leaf in tree.leaves(t))

    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes of the graphs' memory pool: 0 without graphs,
        None when the allocator's snapshot does not name pools."""
        if self._pool is None or not self._graphs:
            return 0
        segs = torch.cuda.memory_snapshot()
        if segs and "segment_pool_id" not in segs[0]:
            return None
        pool = tuple(self._pool)
        return int(sum(sg["total_size"] for sg in segs
                       if tuple(sg["segment_pool_id"]) == pool))

    def _note_params_swap(self) -> None:
        """After a swap or a restore that brought other params
        (``params_epoch`` advanced): re-derive the kernel tables (in
        place where their form is the same) and, when the graphs' form
        changed (a rebound leaf, other tables, another depth), drop every
        graph; the next dispatch recaptures them, counted in
        ``cuda_graph_recaptures_total``, as the JAX engine drops its AOT
        executables when a reload changes the params' shape family."""
        if self._tables_epoch == self.state.params_epoch:
            return
        if self.kind == "sequence":
            self._tables_epoch = self.state.params_epoch
        else:
            self._derive_tables()
        if self._graphs and self._form() != self._graph_form:
            log.warning(
                "params swap changed the form the %d CUDA graphs read; "
                "dropping them (the next batch recaptures)",
                len(self._graphs))
            torch.cuda.synchronize(self.device)
            self._graphs.clear()
            self._precompiled.clear()
            self._pool = None
            self._recapture = True

    def _dispatch_step(self, key: tuple, fn: Callable, *args):
        """Replay ``key``'s graph when it was captured, else run ``fn``
        eagerly: the same device work either way."""
        graph = self._graphs.get(key)
        if graph is None:
            if self._graphs:
                self._m_aot_fallbacks.inc()
            return fn(*args)
        return graph.replay(*args)

    # -- emission (full, bf16, selective, alerts-only) ---------------------

    def _emit_features_now(self) -> bool:
        """Whether the feature matrix crosses to the host for the batch
        being finished: the static config gate and the overload ladder's
        rung-2 degrade (host-side only: the step and its graphs are the
        same either way, the matrix stays on the device unfetched)."""
        return self.cfg.runtime.emit_features and not self._shed_features

    def set_degraded_emission(self, on: bool) -> bool:
        """Overload rung 2: switch to alerts-only emission at run time.
        Refused (False, serving unchanged) where a consumer needs host-
        side feature rows: a feature cache, selective emission's packed
        transfer, or the sequence kind (alerts-shaped already)."""
        if not on:
            self._shed_features = False
            return True
        ok = (self.kind != "sequence" and self.cfg.runtime.emit_features
              and not self._selective and self.scorer != "cpu"
              and self.feature_cache is None)
        self._shed_features = bool(ok)
        if not ok:
            log.info("overload rung 2: alerts-only degrade not applicable "
                     "to this serving mode (a host-side feature consumer "
                     "is wired); batch forcing still applies")
        return self._shed_features

    def _issue_host_fetch(self, out: StepOut, n: int,
                          step_done) -> Optional[dict]:
        """Start the device-to-host copies of what the host will read —
        under selective emission the packed array alone (it carries the
        probabilities), else the ``n`` real rows' probabilities and, when
        emitted, their features; the exact path's tier counts — on the
        side stream, after ``step_done``, into pinned blocks of the
        caching host allocator (each batch its own). None without the
        side stream (the CPU, or ``fetch_overlap`` off)."""
        side = self._d2h_stream
        if side is None:
            return None
        side.wait_event(step_done)
        srcs = {}
        if out.packed is not None:
            srcs["packed"] = out.packed
        else:
            srcs["probs"] = out.probs[:n]
            if out.feats is not None and self._emit_features_now():
                srcs["feats"] = out.feats[:n]
        if out.tier is not None:
            srcs["tier"] = out.tier
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in srcs.items()}
        with torch.cuda.stream(side):
            for k, v in srcs.items():
                host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
        host["done"] = done
        host["issue_t"] = time.perf_counter()
        return host

    def _host_results(self, handle: dict):
        """Wait for the batch's copies (the event behind them on the side
        stream, never the whole device) and decode ``(probs, features,
        tier)`` on the host; a leaf not copied yet is read with a blocking
        copy."""
        n = handle["n"]
        out: StepOut = handle["out"]
        fetch = handle["fetch"] or {}
        if "done" in fetch:
            self._m_fetch_overlap.inc(
                max(0.0, time.perf_counter() - fetch["issue_t"]))
            fetch["done"].synchronize()

        def host(name: str, t: torch.Tensor) -> np.ndarray:
            t = fetch[name] if name in fetch else t.cpu()
            return (t if t.dtype == torch.float32
                    else t.to(torch.float32)).numpy()

        tier = host("tier", out.tier) if out.tier is not None else None
        if out.packed is not None:
            probs, feats = self._unpack_selective(
                n, out, host("packed", out.packed))
        else:
            probs = host("probs", out.probs[:n])
            if out.feats is not None and self._emit_features_now():
                feats = host("feats", out.feats[:n])
            else:
                # alerts-only, the ladder's degrade, or the sequence kind
                feats = np.zeros((n, N_FEATURES), np.float32)
        if self.scorer == "cpu":
            # the oracle: the host's pure-NumPy predict on the features
            # the device step emitted (its own probabilities are dropped)
            probs = self.cpu_model.predict_proba_np(
                feats.astype(np.float64))
        return probs, feats, tier

    def _unpack_selective(self, n: int, out: StepOut, flat: np.ndarray):
        """Decode the packed transfer ``[probs(pad) | count | idx(cap) |
        feats(cap·15)]``: flagged rows' features land bit-identical to
        full emission, the others zero; a count above the cap fetches
        the batch's full matrix, kept on the device for this."""
        pad = out.probs.shape[0]
        cap = (flat.shape[0] - pad - 1) // (1 + N_FEATURES)
        # a copy: a view would pin the whole packed block
        probs = flat[:n].copy()
        count = int(flat[pad])
        feats = np.zeros((n, N_FEATURES), np.float32)
        if count > cap:
            self.selective_overflows += 1
            feats = out.feats[:n].cpu().numpy()
        elif count:
            idx = flat[pad + 1:pad + 1 + count].astype(np.int64)
            sel = flat[pad + 1 + cap:pad + 1 + cap + count * N_FEATURES]
            feats[idx] = sel.reshape(count, N_FEATURES)
        return probs, feats

    # -- the non-finite guard (runtime.nan_guard) --------------------------

    def _guarded(self) -> list:
        """The tensors a step writes: the feature state, and the params
        under the in-step SGD."""
        trees = [self.state.feature_state]
        if self.online_lr > 0.0 and self._loss is not None:
            trees.append(self.state.params)
        return [t for tr in trees for t in tree.leaves(tr)
                if isinstance(t, torch.Tensor)]

    def _snapshot_twins(self) -> None:
        """Copy what the step writes into preallocated twins, on the
        stream, before the step: the state updates in place, so the
        pre-batch state the guard rolls back to lives there."""
        live = self._guarded()
        if self._twins is None or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(self._twins, live)):
            self._twins = [torch.empty_like(t) for t in live]
        for twin, t in zip(self._twins, live):
            twin.copy_(t)

    def _quarantine_nonfinite(self, handle: dict, probs_np: np.ndarray,
                              feats_np: np.ndarray):
        """The JAX engine's guard: rows whose score or emitted features
        reached the host non-finite go to the dead-letter sink
        (``reason=nonfinite``), the twins are copied back into the live
        tensors, and the batch is re-scored from that pre-batch state
        without them. Returns the re-scored result, or None for a clean
        batch."""
        n = handle["n"]
        bad = ~np.isfinite(probs_np[:n])
        if feats_np is not None and feats_np.shape[0] >= n:
            bad |= ~np.isfinite(feats_np[:n]).all(axis=1)
        if not bad.any():
            return None
        cols = handle["cols"]
        bad_idx = np.flatnonzero(bad)
        self.dead_letter.put_rows(
            {k: np.asarray(v)[bad_idx] for k, v in cols.items()},
            reason="nonfinite",
            error="non-finite feature/score at the host boundary",
            batch_index=self.state.batches_done + 1)
        log.warning("nan-guard: %d/%d row(s) produced non-finite outputs; "
                    "quarantined to the dead-letter queue and re-scoring "
                    "the batch without them", len(bad_idx), n)
        with torch.no_grad():
            for t, twin in zip(self._guarded(), self._twins):
                t.copy_(twin)
        good = np.flatnonzero(~bad)
        if len(good) == 0:
            self.state.batches_done += 1
            res = empty_batch_result(self.state.batches_done)
            res.latency_s = (time.perf_counter() - handle["t0"]
                             - handle.get("waited", 0.0))
            return res
        h2 = self._start_batch({k: np.asarray(v)[good]
                                for k, v in cols.items()})
        for key in ("index", "trace_id", "source_offsets", "waited", "t0"):
            if key in handle:
                h2[key] = handle[key]
        # each pass strictly shrinks the surviving rows: it terminates
        return self._finish_batch(h2)

    # -- one batch ---------------------------------------------------------

    def _start_batch(self, cols: dict) -> dict:
        """Host prep (dedup, validate, pad, pack), the host-to-device copy
        (into the bucket graph's static input when there is one), the
        device step (a replay or an eager run), and the start of the
        result copies. Does not wait for the device. The handle keeps the
        step's outputs until :meth:`_finish_batch` has waited for the
        copies that read them, so the caching allocator cannot hand their
        memory out while the side stream reads it."""
        t0 = time.perf_counter()
        with self.tracer.span("host_prep", nvtx=self._nvtx):
            keep = latest_wins_mask_host(cols["tx_id"], cols["kafka_ts_ms"])
            cols = {k: v[keep] for k, v in cols.items()}
            validate_ingest_rows(cols)
            n = len(cols["tx_id"])
            pad = bucket_size(n, self.cfg.runtime.batch_buckets)
            host = self._pack(cols, n, pad)
            t1 = time.perf_counter()
        with self.tracer.span("dispatch", rows=n, pad=pad, nvtx=self._nvtx):
            self._note_params_swap()
            if self._recapture:
                self.precompile()
            key = ("step", 7, pad)
            graph = self._graphs.get(key)
            src = host[0] if isinstance(host, list) else host
            if graph is not None:
                packed = graph.inputs[0]
                packed.copy_(src, non_blocking=True)
            else:
                packed = src.to(self.device, non_blocking=True)
            if isinstance(host, list):
                host[1] = torch.cuda.Event()
                host[1].record()
            if self._nan_guard:
                self._snapshot_twins()
            out = self._dispatch_step(key, self._step, packed)
            if self.online_lr > 0.0 and self._loss is not None:
                # the leaves no longer hold what the last restore wrote
                self.state.params_crcs = None
            self._note_batch_days(cols)
            self._note_cold_touches(cols)
            step_done = None
            if self.device.type == "cuda":
                # behind the step that wrote the state: the side-stream
                # copies and a checkpoint save wait for it
                step_done = torch.cuda.Event()
                step_done.record()
                self.state.ready = step_done
            fetch = self._issue_host_fetch(out, n, step_done)
        return {"cols": cols, "n": n, "out": out, "fetch": fetch,
                "t0": t0, "prep_s": t1 - t0,
                "dispatch_s": time.perf_counter() - t1}

    def _finish_batch(self, handle: dict) -> BatchResult:
        """Wait for this batch's result copies and build its result (the
        non-finite guard first, when on); then, between steps, the tiered
        store's compaction and promotions."""
        n = handle["n"]
        probs_np, feats_np, tier_np = self._host_results(handle)
        if self._nan_guard:
            res = self._quarantine_nonfinite(handle, probs_np, feats_np)
            if res is not None:
                return res
        if tier_np is not None and self._m_tier is not None:
            self._m_tier["dense"].inc(float(tier_np[0]))
            self._m_tier["cms"].inc(float(tier_np[1]))
        cols = handle["cols"]
        self._emit_learning(cols, n, probs_np, feats_np,
                            handle.get("trace_id"))
        self.state.batches_done += 1
        self.state.rows_done += n
        self._m_batches.inc()
        self._m_rows.inc(n)
        self._m_last.set(time.time())
        self._drain_meters()
        self._maybe_compact()
        self._maybe_promote()
        self._devmem.tick()
        res = BatchResult(
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
        self._m_lat.observe(res.latency_s)
        return res

    def _emit_learning(self, cols: dict, n: int, probs_np: np.ndarray,
                       feats_np: np.ndarray, trace_id=None) -> None:
        """The learning tail of a result: the feature-cache put, the
        shadow's dual score, and the online-update flag (from the host's
        own label column, never the device)."""
        in_band = cols.get("label")
        if self.feature_cache is not None and n:
            self.feature_cache.put_batch(
                cols["tx_id"], feats_np,
                terminal_ids=cols["terminal_id"],
                days=(cols["tx_datetime_us"] // US_PER_DAY).astype(np.int32),
                # in-band labels already reached the state in the step
                labeled=(np.asarray(in_band) >= 0)
                if in_band is not None else None,
            )
        if self.shadow is not None and not self.shadow_paused and n:
            with self.tracer.span("shadow_score", batch=trace_id,
                                  nvtx=self._nvtx):
                self.shadow.score_batch(cols["tx_id"], feats_np, probs_np)
        if (self.online_lr > 0.0 and self._loss is not None
                and in_band is not None
                and (np.asarray(in_band) >= 0).any()):
            # the in-step SGD consumed this batch's labels: the params
            # now lead the last published artifact
            self._online_dirty = True

    def _ensure_layout(self) -> None:
        """Adopt a restored checkpoint written at another shard width, as
        the JAX engine does before its next step: the checkpoint's state
        (``state.layout_pending``, the writer's layout) is converted to
        this engine's (``parallel/mesh.py::reshard_engine_state``, exact
        for direct keys) and written into the engine's own tensors in
        place, so captured graphs keep reading them."""
        st = self.state
        n_old = int(st.layout_devices or 1)
        n_new = self._state_shards()
        if n_old == n_new and st.layout_pending is None:
            return
        from real_time_fraud_detection_system_tpu_torch.parallel.mesh \
            import reshard_engine_state, shard_feature_state

        src = st.layout_pending
        if src is None:
            src = st.feature_state
        new = reshard_engine_state(self.kind, src, self.cfg, n_old, n_new)
        shard_feature_state(new, (self.device,) * n_new,
                            out=st.feature_state)
        st.layout_pending = None
        st.layout_devices = n_new

    def process_batch(self, cols: dict) -> BatchResult:
        """One micro-batch: dedup → pad → device step → host result."""
        self._ensure_layout()
        tid = self.tracer.begin_batch(self.state.batches_done + 1)
        handle = self._start_batch(cols)
        handle["trace_id"] = tid
        with self.tracer.span("result_wait", batch=tid, nvtx=self._nvtx):
            return self._finish_batch(handle)

    # -- learning (runtime/feedback.py, runtime/learner.py) ----------------

    def _reload(self, swap, learning, recorder) -> None:
        """A hot reload's swap, counted by outcome; with a learning loop
        it is registered in the lineage (publish + promote)."""
        new_params, new_scaler = swap
        outcome = ("clobbered_online_updates" if self._online_dirty
                   else "clean")
        self._m_reloads[outcome].inc()
        self._online_dirty = False
        self.swap_params(new_params, new_scaler)
        if recorder is not None:
            recorder.record_event("model_reload", outcome=outcome)
        if learning is not None:
            learning.note_external_swap(self.state.params, self.state.scaler,
                                        outcome, engine=self)

    @property
    def supports_online_sgd(self) -> bool:
        """True for model kinds with a gradient path (logreg)."""
        return self._loss is not None

    def apply_state_feedback(self, terminal_ids: np.ndarray,
                             days: np.ndarray, labels: np.ndarray) -> None:
        """Land delayed fraud labels in the terminal risk windows, in
        place on the serving stream (``features/online.py::
        apply_feedback``), in chunks of at most the largest bucket padded
        to a bucket. No-op rows: label < 0 (pending) and buckets whose
        ring slot has moved past the transaction's day. Every kind with
        window state (not the sequence kind, which has none)."""
        if self.kind == "sequence":
            check_sequence_serving(self.cfg, feedback=True)
        # labels scatter by slot: a cross-width restore converts first
        self._ensure_layout()
        labels = np.asarray(labels)
        mask = labels >= 0
        if not mask.any():
            return
        buckets = self.cfg.runtime.batch_buckets
        biggest = max(buckets)
        t_ids = np.asarray(terminal_ids)[mask]
        d = np.asarray(days)[mask]
        y = labels[mask]
        for s in range(0, len(y), biggest):
            n = len(y[s:s + biggest])
            pad = bucket_size(n, buckets)
            # one int32 [4, pad] copy: key (uint32 bits), day, label, valid
            packed = np.zeros((4, pad), dtype=np.int32)
            packed[0, :n] = fold_key(t_ids[s:s + n]).view(np.int32)
            packed[1, :n] = d[s:s + n]
            packed[2, :n] = y[s:s + n]
            packed[3, :n] = 1
            dev = host_to_device(packed, self.device)
            self.state.feature_state = self._state_feedback(
                self.state.feature_state, dev[0].view(torch.uint32), dev[1],
                dev[2], dev[3].bool(), self.cfg.features)

    def apply_feedback(self, features: np.ndarray,
                       labels: np.ndarray) -> None:
        """Backtracking SGD from delayed labels on RAW feature rows (as the
        cache holds them; the engine's scaler applies inside): per chunk of
        at most the largest bucket, halve the step up to 8 times until the
        loss contracts (``l1 <= l0``: one host read per try, as in JAX),
        then copy the new params in place; a chunk that cannot contract is
        skipped."""
        if self._loss is None:
            raise ValueError(
                f"model kind {self.kind!r} has no gradient path for "
                "feedback updates")
        lr = self.online_lr or self.cfg.train.online_learning_rate
        labels = np.asarray(labels)
        total = len(labels)
        if total == 0:
            return
        buckets = self.cfg.runtime.batch_buckets
        biggest = max(buckets)
        for s in range(0, total, biggest):
            lab = labels[s:s + biggest]
            n = len(lab)
            pad = bucket_size(n, buckets)
            x = np.zeros((pad, features.shape[1]), dtype=np.float32)
            x[:n] = features[s:s + n]
            # label < 0 is the 'unlabeled' sentinel: never trained on
            y = np.zeros(pad, dtype=np.int32)
            y[:n] = np.maximum(lab, 0)
            valid = np.zeros(pad, dtype=bool)
            valid[:n] = lab >= 0
            if not valid.any():
                continue
            dx, dy, dv = (host_to_device(a, self.device)
                          for a in (x, y, valid))
            step_lr = float(lr)
            for _ in range(8):
                new, l0, l1 = feedback_step(
                    self._loss, self.state.params, self.state.scaler,
                    dx, dy, dv, step_lr)
                if bool(l1 <= l0):
                    copy_into(self.state.params, new)
                    self.state.params_crcs = None
                    self._online_dirty = True
                    break
                step_lr *= 0.5

    def swap_params(self, params, scaler=None) -> None:
        """Swap in other params (and scaler): a hot reload, a promotion, a
        rollback or a resync. Leaves of the same form are copied in place
        on the serving stream (the kernels read them by pointer); another
        form is rebound. Either way ``params_epoch`` advances, so the next
        step re-derives the kernel tables, and ``params_crcs`` is cleared,
        so the next restore compares against the leaves as they are."""
        params = device_params_for(self.kind, tree.to(params, self.device))
        if not copy_into(self.state.params, params):
            self.state.params = tree.clone(params)
        if scaler is not None:
            scaler = scaler.to(self.device)
            if not copy_into(self.state.scaler, scaler):
                self.state.scaler = tree.clone(scaler)
        self.state.params_epoch += 1
        self.state.params_crcs = None

    def set_shadow(self, shadow) -> None:
        """Attach a shadow scorer (``runtime/learner.py::ShadowScorer``):
        the candidate dual-scores every emitted batch on the same host
        feature rows, so the features must leave the device."""
        if self.kind == "sequence":
            check_sequence_serving(self.cfg, shadow=True)
        if not self.cfg.runtime.emit_features or self._selective:
            raise ValueError(
                "shadow scoring consumes every row's features host-side; "
                "it does not compose with alerts-only or selective "
                "emission")
        if self.cfg.runtime.emit_dtype != "float32":
            raise ValueError(
                "shadow scoring re-consumes the emitted features; "
                "emit_dtype='bfloat16' would drift the candidate's "
                "scores — keep float32")
        self.shadow = shadow

    def clear_shadow(self) -> None:
        self.shadow = None

    def run(self, source, sink=None, max_batches: int = 0,
            checkpointer=None, trigger_seconds: Optional[float] = None,
            heartbeat=None, feedback=None, model_reload=None,
            learning=None) -> dict:
        """Stream until the source is exhausted or ``max_batches`` batches
        of this run have started (0: no cap; a negative count starts
        none). :func:`batches_left` turns a cap on the engine's lifetime
        batches, as the JAX engine counts them, into this one.

        With ``runtime.precompile`` the graphs are captured before the
        first poll (:meth:`precompile`). Up to ``runtime.pipeline_depth``
        batches are in flight (1 under ``runtime.nan_guard``, whose
        roll-back needs no later batch launched from the state it rolls
        back): a batch is finished (results waited for, sink appended)
        once ``depth`` handles are queued, and the rest drain at the end.
        ``runtime.coalesce_rows`` merges consecutive polls into one batch
        of up to that many rows, never past the largest bucket (a poll
        that would overflow it is carried into the next batch); with
        ``runtime.autobatch`` the controller's target
        (``runtime/autobatch.py``) takes its place. ``trigger_seconds``
        (default ``runtime.trigger_seconds``) spaces batch starts at
        least that far apart, once per loop pass on the poll side; the
        time slept, like source polls, is credited as wait so latencies
        measure the pipeline. An empty poll (an idle live source) drains
        the pipeline and waits one trigger.

        ``runtime.overload.enabled`` runs the ladder
        (``runtime/overload.py``): rung 1 pauses the shadow and the
        learner and samples the flight record
        (``overload.recorder_sample_every``), rung 2 pins the
        autobatch target to the largest bucket and degrades emission to
        alerts-only (host side only), rung 3 defers each assembled batch
        to the spill; deferred batches replay in order, through the same
        path, before any live poll, and at the source's end all of them
        do (``scored + deferred-pending == polled``).

        ``checkpointer``: after every ``runtime.checkpoint_every_batches``
        finished batches an async sink drains, the state is saved and the
        source commits (where it can), in that order, so offsets trail
        durable output and broker commits trail the checkpoint. A batch
        launches only once no queued batch will checkpoint (the pipeline
        drains first), so a save never holds a later batch's state.
        ``heartbeat`` is beaten once per loop pass (the stall watchdog's
        progress signal).

        Per finished batch, after the sink and before the checkpoint, in
        the JAX engine's order: ``feedback`` (a
        :class:`~.feedback.FeedbackLoop`) polls and applies its labels;
        ``model_reload`` (a callable returning None or ``(params,
        scaler)``) may swap the params, counted in
        ``rtfds_model_reloads_total{outcome}`` (``clobbered_online_updates``
        when online updates landed since the last swap); ``learning`` (a
        :class:`~.learner.LearningLoop`, attached before the first poll)
        makes its install, promotion and rollback decisions. With a
        checkpointer, feedback offsets are committed after each save.

        The flight record (``self.recorder``, else ``active_recorder()``
        at the start) gets one batch record per finished batch: its
        phases (the source polls since the last finished batch, host
        prep, dispatch, result wait, sink write), the queue depth, the
        latency and, with the tracer on, the trace id; the same phases go
        to ``rtfds_phase_seconds{phase}``.

        Returns this run's stats: rows, batches, wall and CPU seconds,
        rows/s, the per-batch latency p50/p99 (host prep through the
        results' arrival on the host, minus waits), the median ms of each
        loop stage (``stage_ms_p50``: source poll, per poll; host prep;
        dispatch — the host-to-device copy, the step's launches or its
        graph's replay, and the start of the result copies; result wait;
        sink write), the same four medians as ``*_p50_ms`` keys,
        ``pipeline_depth``, ``host_prep_route`` and ``z_mode``; with
        autobatch its target and adjustments, with selective emission
        this run's overflows.
        """
        # a restored state's cold lineage: reconcile the store (and fence
        # the promoter) before any batch can touch a demoted key
        self._sync_cold_after_restore()
        self._ensure_layout()  # a cross-width restore converts first
        rt = self.cfg.runtime
        self._learning = learning
        if rt.precompile and not self._precompiled:
            self.precompile()
        if learning is not None:
            # the shadow scorer and the learner's tap go in before the
            # first poll; the loop then rides the batch cadence
            learning.attach(self)
        if feedback is not None and checkpointer is not None:
            # feedback offsets trail the state checkpoint
            feedback.auto_commit = False
        degraded0 = len(self._degraded_keys)
        ovf0 = self.selective_overflows
        trigger = rt.trigger_seconds if trigger_seconds is None \
            else trigger_seconds
        depth = 1 if self._nan_guard else max(1, rt.pipeline_depth)
        coalesce = rt.coalesce_rows
        cap = max(rt.batch_buckets)
        auto = None
        if rt.autobatch:
            from real_time_fraud_detection_system_tpu_torch.runtime \
                .autobatch import AutoBatchController

            auto = AutoBatchController(rt.batch_buckets,
                                       latency_slo_ms=rt.latency_slo_ms,
                                       registry=self.metrics)
        recorder = self.recorder if self.recorder is not None \
            else active_recorder()
        overload = (self._overload_controller(learning, auto, recorder)
                    if rt.overload.enabled else None)
        phase_hist = self._m_phase
        # source-poll seconds since the last finished batch: the next
        # batch's flight record carries them, so a record's phases add
        # up to the loop's time
        pending = {"poll_s": 0.0}
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
            tid = handle.get("trace_id")
            t_block = time.perf_counter()
            # batch=tid: at depth > 1 the tracer's current batch is newer
            with self.tracer.span("result_wait", batch=tid, nvtx=self._nvtx):
                res = self._finish_batch(handle)
            prep_s, dispatch_s = handle["prep_s"], handle["dispatch_s"]
            wait_s = time.perf_counter() - t_block
            trackers["result_wait"].record(wait_s)
            trackers["host_prep"].record(prep_s)
            trackers["dispatch"].record(dispatch_s)
            trackers["latency"].record(res.latency_s, rows=len(res.tx_id))
            phase_hist["host_prep"].observe(prep_s)
            phase_hist["dispatch"].observe(dispatch_s)
            phase_hist["result_wait"].observe(wait_s)
            self.state.offsets = handle["source_offsets"]
            sink_s = 0.0
            if sink is not None:
                # an AsyncSink's enqueue (and any backpressure block): the
                # loop thread's cost; its writer reports the write itself
                t = time.perf_counter()
                with self.tracer.span("sink_write", batch=tid,
                                      nvtx=self._nvtx):
                    sink.append(res)
                sink_s = time.perf_counter() - t
                phase_hist["sink_write"].observe(sink_s)
                trackers["sink_write"].record(sink_s)
            if auto is not None:
                auto.observe(len(res.tx_id), res.latency_s)
            if overload is not None:
                rr = handle.pop("overload_replay_rows", None)
                if rr is not None:
                    # counted at finish: the replay's state updates landed
                    overload.note_replayed(rr)
                overload.observe_batch(len(res.tx_id), res.latency_s)
            if recorder is not None:
                # a slow batch's record names its span waterfall
                extra = {"trace_id": tid} if tid else {}
                recorder.record_batch(
                    res.batch_index, len(res.tx_id),
                    {"source_poll": pending["poll_s"], "host_prep": prep_s,
                     "dispatch": dispatch_s, "result_wait": wait_s,
                     "sink_write": sink_s},
                    queue_depth=len(q), latency_s=res.latency_s, **extra)
                pending["poll_s"] = 0.0
            if feedback is not None:
                # between steps, before the checkpoint: the saved state
                # holds the landed labels
                applied = feedback.poll_and_apply()
                if recorder is not None and applied:
                    recorder.record_event("feedback", applied=applied,
                                          batch=res.batch_index)
            if model_reload is not None:
                swap = model_reload()
                if swap is not None:
                    self._reload(swap, learning, recorder)
            if learning is not None:
                learning.on_batch(self)
            if checkpointer is not None \
                    and self.state.batches_done % every == 0:
                # offsets trail durable sink output: drain an async sink
                # first; a broker commits only after the save landed
                drain = getattr(sink, "drain", None)
                if drain is not None:
                    drain()
                if self._cold is not None:
                    # buffered demotions become segments now, so the
                    # lineage the checkpoint records is on disk
                    self._cold.flush()
                    self.state.cold_lineage = self._cold.lineage()
                self._maybe_exchange_cms()
                checkpointer.save(self.checkpoint_state())
                commit = getattr(source, "commit", None)
                if commit is not None:
                    commit()
                if feedback is not None:
                    feedback.commit()
                if self._cold is not None:
                    # fully promoted segments go only once a checkpoint
                    # that no longer lists them has landed
                    self._cold.gc()

        def _add_wait(dt: float) -> None:
            for h in q:
                h["waited"] = h.get("waited", 0.0) + dt

        def _drain() -> None:
            while q:
                _finish(q.popleft())

        def _poll() -> Optional[dict]:
            # attributed to the batch that will consume it: begin_batch
            # runs only after the poll, so the current id is the last one's
            nid = (f"b{self.state.batches_done + len(q) + 1:08d}"
                   if self.tracer.enabled else None)
            t = time.perf_counter()
            with self.tracer.span("source_poll", batch=nid, nvtx=self._nvtx):
                cols = source.poll_batch()
            dt = time.perf_counter() - t
            _add_wait(dt)
            phase_hist["source_poll"].observe(dt)
            pending["poll_s"] += dt
            if cols is not None:
                trackers["source_poll"].record(dt)
            return cols

        def _rows(cols: dict) -> int:
            return len(next(iter(cols.values()), ()))

        def _launch(cols: dict, offs: list, replay_rows=None) -> None:
            """One assembled batch into the pipeline: live traffic and a
            replayed deferred batch take the same path."""
            nonlocal t_last_start
            if checkpointer is not None and any(
                    h["index"] % every == 0 for h in q):
                _drain()  # a queued batch will checkpoint: nothing newer
            idx = self.state.batches_done + len(q) + 1
            tid = self.tracer.begin_batch(idx)
            handle = self._start_batch(cols)
            t_last_start = time.perf_counter()
            handle["index"] = idx
            handle["trace_id"] = tid
            handle["source_offsets"] = offs
            if replay_rows is not None:
                handle["overload_replay_rows"] = replay_rows
            q.append(handle)
            self._m_qdepth.set(len(q))
            while len(q) >= depth:
                _finish(q.popleft())
                self._m_qdepth.set(len(q))

        exhausted = False
        capped = False  # max_batches stopped the run (resumable)
        carry = None  # (cols, offsets): a poll beyond the coalesce cap
        t_last_start = None
        while not exhausted:
            if heartbeat is not None:
                heartbeat.beat()
            started = self.state.batches_done + len(q)
            if max_batches and started - batches0 >= max_batches:
                capped = True
                break
            if self.stop_event is not None and self.stop_event.is_set():
                # a coordinated drain (a fleet resize, a graceful SIGTERM):
                # stop at a batch boundary as a capped run does; deferred
                # batches stay behind the checkpointed offsets and re-poll
                # under the next topology
                capped = True
                break
            if trigger > 0 and t_last_start is not None:
                dt = trigger - (time.perf_counter() - t_last_start)
                if dt > 0:
                    time.sleep(dt)
                    _add_wait(dt)
            if overload is not None and overload.want_replay():
                # the deferred FIFO's head replays before any live poll:
                # rows reach the state in a never-overloaded run's order
                item = overload.next_replay()
                if item is not None:
                    _launch(item.cols, item.offsets, replay_rows=item.rows)
                    continue
            if carry is not None:
                cols, offs = carry
                carry = None
            else:
                cols = _poll()
                if cols is None:
                    break
                if _rows(cols) == 0:
                    _drain()
                    if overload is not None:
                        # the quiet period is the ladder's recovery window
                        overload.idle_tick()
                    if trigger > 0:
                        time.sleep(trigger)
                    continue
                offs = list(source.offsets)
            assemble = auto.target_rows() if auto is not None else coalesce
            if assemble > 0:
                target = min(assemble, cap)
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
            if overload is not None and overload.should_defer():
                # rung 3: the whole batch goes to the spill; it takes no
                # batch_index and state.offsets stays at the last scored
                # batch. What was launched before finishes first.
                _drain()
                overload.defer(cols, offs)
                continue
            _launch(cols, offs)
        try:
            if overload is not None and not capped:
                # the source is exhausted: every deferred batch is scored
                # before the run ends (a max_batches stop leaves them
                # spilled, behind the checkpointed offsets)
                overload.finish_stream()
                while True:
                    if heartbeat is not None:
                        heartbeat.beat()
                    item = overload.next_replay()
                    if item is None:
                        break
                    _launch(item.cols, item.offsets, replay_rows=item.rows)
            _drain()
        finally:
            if overload is not None:
                # revert every engine-side degrade for a later run
                overload.deactivate()
        self._m_qdepth.set(0)
        sink_drain = getattr(sink, "drain", None)
        if sink_drain is not None:
            sink_drain()
        if self._cold is not None:
            # land in-flight promotions and persist buffered demotions, so
            # the caller's next save records the fresh lineage
            self.drain_promotions()
            self._cold.flush()
            self.state.cold_lineage = self._cold.lineage()
        self._drain_meters(wait=True)
        wall = time.perf_counter() - t_start
        snaps = {k: t.snapshot() for k, t in trackers.items()}
        p50 = {k: snaps[k].get("p50_ms", 0.0) for k in trackers}
        rows = self.state.rows_done - rows0
        stats = {
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
        if auto is not None:
            stats["autobatch_target_rows"] = auto.target_rows()
            stats["autobatch_adjustments"] = auto.adjustments
        if self._selective:
            # this run's overflows (full fetches): recalibrate
            # emit_threshold or raise emit_cap_fraction when nonzero
            stats["selective_overflows"] = self.selective_overflows - ovf0
        if self._cold is not None:
            # keys scored from the sketch while their promotion was in
            # flight: the scope of the bit-identity claim
            stats["exactness_degraded_keys"] = (
                len(self._degraded_keys) - degraded0)
        return stats

    def _overload_controller(self, learning, auto, recorder):
        """The ladder for one run, with the engine-side effect of each
        rung (all reversible)."""
        from real_time_fraud_detection_system_tpu_torch.runtime.overload \
            import LadderActions, OverloadController

        every = self.cfg.runtime.overload.recorder_sample_every

        def shed_optional(on: bool) -> None:
            # rung 1: the shadow and the learner pause through their
            # hooks, and the flight record thins to every k-th batch
            self.shadow_paused = bool(on)
            if learning is not None:
                if on:
                    learning.pause()
                else:
                    learning.resume()
            if recorder is not None:
                recorder.set_sample_every(every if on else 1)

        def force_max_batch(on: bool) -> None:
            # rung 2: the largest bucket, a captured signature like any
            if auto is not None:
                if on:
                    auto.force_max()
                else:
                    auto.release_force()

        return OverloadController(
            self.cfg.runtime, registry=self.metrics,
            actions=LadderActions(
                shed_optional=shed_optional,
                degrade_emission=self.set_degraded_emission,
                force_max_batch=force_max_batch),
            recorder_fn=lambda: recorder)
