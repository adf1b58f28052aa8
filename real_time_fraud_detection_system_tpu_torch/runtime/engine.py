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

Not ported yet: selective and bf16 emission, the nan-guard, CUDA-graph
precompile, autobatch and the overload ladder (A4); the sharded engine
and the fleet, with their stacked directories and cold-store re-homing,
and the sharded sequence step (A7).
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
    leaf_sum,
    to_kernel_tables,
)
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    PoisonRowError,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    active_recorder,
    get_registry,
)
from real_time_fraud_detection_system_tpu_torch.utils.timing import (
    LatencyTracker,
)

_KINDS = ("logreg", "mlp", "tree", "forest", "gbt", "autoencoder",
          "sequence")


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
                           shadow: bool = False) -> None:
    """The sequence kind's refusals, the JAX engine's with its messages:
    the tiered store, online SGD, the labeled-feedback loop and shadow
    scoring all need the windows plane or a host-side feature matrix,
    which a history state does not have. Raises ValueError."""
    if cfg.features.key_mode == "exact":
        raise ValueError(
            "key_mode='exact' is the windows-plane tiered feature "
            "store; kind='sequence' serves from its own history state "
            "(keep key_mode direct/hash)")
    if online_lr > 0.0:
        raise ValueError("online SGD is not wired for kind='sequence'")
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
    emitted rows for the labeled-feedback join. For the sequence kind
    ``feature_state`` is a ``features/history.py::HistoryState``.
    """

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
    ):
        _require_kind(kind)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kind = kind
        self.online_lr = float(online_lr)
        self._loss = loss_fn_for(kind)
        if feature_cache is not None and not cfg.runtime.emit_features:
            raise ValueError(
                "emit_features=False (alerts-only serving) cannot be "
                "combined with a feature cache: it consumes host-side "
                "feature rows")
        self.feature_cache = feature_cache
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
            self._fused = (cfg.features.customer_source == "table"
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

    def _init_sequence(self, params, scaler, feature_state) -> None:
        """kind='sequence': the history state and its step, with the JAX
        engine's refusals. The emitted feature matrix is zeros (the
        transformer reads raw event channels, not the engineered
        features), so the analyzed schema stays the same for sinks."""
        cfg = self.cfg
        check_sequence_serving(cfg, self.online_lr,
                               feedback=self.feature_cache is not None)
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
        otherwise. Derived at build and again after a restore that
        brought other params."""
        self.tables: Optional[ForestTables] = None
        self.leaf_tables: Optional[ForestTables] = None
        params = self.state.params
        trees = params.trees if isinstance(params, GBTModel) else params
        if isinstance(trees, GemmEnsemble) and admit_tables(trees).fits:
            if self.kind == "gbt" or not self._fused:
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
        if self.kind == "logreg" and self._fused:
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
        """One device step on a packed batch; returns (probs, features,
        tier) with ``tier`` the ``[dense, cms]`` counts of the exact
        path, else None; the sequence kind's features are None (zeros,
        made on the host)."""
        batch = unpack_batch(packed)
        if self.kind == "sequence":
            _, probs = update_and_score(self.state.feature_state,
                                        self.state.params, batch,
                                        self.cfg.features)
            return probs, None, None
        if self._tables_epoch != self.state.params_epoch:
            self._derive_tables()
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
        return (torch.where(batch.valid, probs, torch.zeros_like(probs)),
                feats, tier)

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
        # the leaves no longer hold what the last restore wrote
        self.state.params_crcs = None

    # -- tiered feature store (key_mode="exact") ---------------------------

    def _check_state_budget(self) -> None:
        """``features.state_hbm_budget_mb``: fail the build, not the
        stream, when the configured feature state cannot fit the budget
        (``features/online.py::state_bytes``)."""
        fcfg = self.cfg.features
        if fcfg.state_hbm_budget_mb <= 0:
            return
        sb = state_bytes(fcfg)
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
            sb = state_bytes(fcfg)
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
        # the day goes in as a kernel argument: no host-to-device copy
        out = compact_feature_state(
            self.state.feature_state, self._max_day, self.cfg.features,
            demote_slots=self._demote_slots)
        if self._demote_slots:
            self._append_demotions(out[2])
        self._record_compaction(out[1])

    def _record_compaction(self, reclaimed: torch.Tensor) -> None:
        """Meter one compaction: the reclaimed counts and the occupancy
        come to the host through a side-stream copy, read once it has
        landed (:meth:`_drain_meters`), never through a sync."""
        fs = self.state.feature_state
        dirs = {t: getattr(fs, f"{t}_dir") for t in self._dir_tables()}
        vals = torch.cat([reclaimed.to(torch.int32), torch.stack(
            [(kd.slot_capacity - kd.free_top).to(torch.int32)
             for kd in dirs.values()])])
        batch = self.state.batches_done

        def apply(v: np.ndarray) -> None:
            for i, table in enumerate(("customer", "terminal")):
                if table in dirs:
                    self._m_slots_rec[table].inc(int(v[i]))
            occupied = dict(zip(dirs, map(int, v[2:])))
            for table, o in occupied.items():
                self._m_slots_occ[table].set(o)
            recorder = active_recorder()
            if recorder is not None:
                extra = {}
                if self._cold is not None:
                    extra = {"cold_keys": int(self._cold.keys_count),
                             "cold_bytes": int(self._cold.bytes),
                             "promote_backlog": int(
                                 self._promoter.backlog())}
                recorder.record_event(
                    "feature_state", reclaimed=int(v[:2].sum()),
                    occupied=sum(occupied.values()),
                    capacity=sum(kd.slot_capacity for kd in dirs.values()),
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
            keys, bd, cnt, amt, frd = (t.cpu().numpy() for t in pay)
            total += self._cold.append(table, keys, bd, cnt, amt, frd)
            for k in keys[keys != np.uint32(0xFFFFFFFF)]:
                self._cold_pending.discard((table, int(k)))
        if total:
            self._m_cold_dem.inc(total)
        self._cold_gauges()

    def _build_promote_payload(self, rows_by_table: dict) -> dict:
        """Resolved cold rows → the fixed-shape promote payload
        (``EMPTY_KEY``-padded ``[K, ...]`` per table with a directory),
        on the device."""
        k = self._demote_slots
        nb = self.cfg.features.n_day_buckets
        tables = self._dir_tables()
        payload = {}
        for table in ("customer", "terminal"):
            if table not in tables:
                payload[table] = None
                continue
            keys = np.full((k,), 0xFFFFFFFF, np.uint32)
            bd = np.full((k, nb), -1, np.int32)
            cnt = np.zeros((k, nb), np.float32)
            amt = np.zeros((k, nb), np.float32)
            frd = np.zeros((k, nb), np.float32)
            for i, (key, r) in enumerate(
                    (rows_by_table.get(table) or {}).items()):
                keys[i] = key
                bd[i], cnt[i], amt[i], frd[i] = r
            dev = self.device
            payload[table] = (
                torch.from_numpy(keys.view(np.int32)).to(dev)
                .view(torch.uint32),
                *(torch.from_numpy(a).to(dev) for a in (bd, cnt, amt, frd)))
        return payload

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
        _, stats = promote_rows(self.state.feature_state,
                                self._build_promote_payload(rows_by_table),
                                self.cfg.features)
        st = stats.cpu().numpy()
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

    def _issue_host_fetch(self, probs: torch.Tensor,
                          feats: Optional[torch.Tensor],
                          n: int, step_done,
                          tier: Optional[torch.Tensor] = None
                          ) -> Optional[dict]:
        """Start the device-to-host copies of the ``n`` real rows'
        probabilities (and features, when emitted and the step made them,
        and the exact path's tier counts) on the side stream,
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
        if self.cfg.runtime.emit_features and feats is not None:
            host["feats"] = torch.empty((n, N_FEATURES), dtype=torch.float32,
                                        pin_memory=True)
        if tier is not None:
            host["tier"] = torch.empty(2, dtype=torch.float32,
                                       pin_memory=True)
        with torch.cuda.stream(side):
            host["probs"].copy_(probs[:n], non_blocking=True)
            if "feats" in host:
                host["feats"].copy_(feats[:n], non_blocking=True)
            if tier is not None:
                host["tier"].copy_(tier, non_blocking=True)
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
        probs, feats, tier = self._step(packed)
        self._note_batch_days(cols)
        self._note_cold_touches(cols)
        step_done = None
        if self.device.type == "cuda":
            # behind the step that wrote the state: the side-stream copies
            # and a checkpoint save wait for it
            step_done = torch.cuda.Event()
            step_done.record()
            self.state.ready = step_done
        fetch = self._issue_host_fetch(probs, feats, n, step_done, tier)
        return {"cols": cols, "n": n, "probs": probs, "feats": feats,
                "tier": tier, "fetch": fetch, "t0": t0, "prep_s": t1 - t0,
                "dispatch_s": time.perf_counter() - t1}

    def _finish_batch(self, handle: dict) -> BatchResult:
        """Wait for this batch's result copies (the event behind them on
        the side stream, never the whole device) and build its result;
        then, between steps, the tiered store's compaction and
        promotions."""
        n = handle["n"]
        emit = (self.cfg.runtime.emit_features
                and handle["feats"] is not None)
        fetch = handle["fetch"]
        tier = handle.get("tier")
        if fetch is not None:
            fetch["done"].synchronize()
            probs_np = fetch["probs"].numpy()
            feats_np = fetch["feats"].numpy() if emit else None
            tier_np = fetch["tier"].numpy() if "tier" in fetch else None
        else:
            probs_np = handle["probs"][:n].cpu().numpy()
            feats_np = handle["feats"][:n].cpu().numpy() if emit else None
            tier_np = tier.cpu().numpy() if tier is not None else None
        if feats_np is None:
            feats_np = np.zeros((n, N_FEATURES), np.float32)
        if tier_np is not None and self._m_tier is not None:
            self._m_tier["dense"].inc(float(tier_np[0]))
            self._m_tier["cms"].inc(float(tier_np[1]))
        cols = handle["cols"]
        self._emit_learning(cols, n, probs_np, feats_np)
        self.state.batches_done += 1
        self.state.rows_done += n
        self._drain_meters()
        self._maybe_compact()
        self._maybe_promote()
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

    def _emit_learning(self, cols: dict, n: int, probs_np: np.ndarray,
                       feats_np: np.ndarray) -> None:
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
            self.shadow.score_batch(cols["tx_id"], feats_np, probs_np)
        if (self.online_lr > 0.0 and self._loss is not None
                and in_band is not None
                and (np.asarray(in_band) >= 0).any()):
            # the in-step SGD consumed this batch's labels: the params
            # now lead the last published artifact
            self._online_dirty = True

    def process_batch(self, cols: dict) -> BatchResult:
        """One micro-batch: dedup → pad → device step → host result."""
        return self._finish_batch(self._start_batch(cols))

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
            self.state.feature_state = state_feedback(
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
        if not self.cfg.runtime.emit_features:
            raise ValueError(
                "shadow scoring consumes every row's features host-side; "
                "it does not compose with alerts-only emission")
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

        Returns this run's stats: rows, batches, wall and CPU seconds,
        rows/s, the per-batch latency p50/p99 (host prep through the
        results' arrival on the host, minus waits), the median ms of each
        loop stage (``stage_ms_p50``: source poll, per poll; host prep;
        dispatch — the host-to-device copy, the step's launches and the
        start of the result copies; result wait; sink write), the same four
        medians as ``*_p50_ms`` keys, ``pipeline_depth``,
        ``host_prep_route`` and ``z_mode``.
        """
        # a restored state's cold lineage: reconcile the store (and fence
        # the promoter) before any batch can touch a demoted key
        self._sync_cold_after_restore()
        if learning is not None:
            # the shadow scorer and the learner's tap go in before the
            # first poll; the loop then rides the batch cadence
            learning.attach(self)
        if feedback is not None and checkpointer is not None:
            # feedback offsets trail the state checkpoint
            feedback.auto_commit = False
        degraded0 = len(self._degraded_keys)
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
            recorder = active_recorder()
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
            # keys scored from the sketch while their promotion was in
            # flight: the scope of the bit-identity claim (cold tier only)
            **({"exactness_degraded_keys":
                len(self._degraded_keys) - degraded0}
               if self._cold is not None else {}),
        }
