"""Continuous learning in the loop — port of the JAX package's
``runtime/learner.py``: streaming retrain, shadow scoring, and gated
canary promotion.

- :class:`StreamingLearner` warm-starts a candidate from the champion and
  fits it on the labeled-feedback window on its own thread and, on the
  card, its own CUDA stream, with its own copy of the params (never the
  engine's tensors): a bounded queue (a full queue drops, counted),
  generation fences (a reset supersedes training in flight), pause and
  resume around poison isolation, the worker's failure re-raised on the
  loop thread with its original type. It publishes versions to the
  :class:`~..io.registry.ModelRegistry` on a label cadence.
- :class:`ShadowScorer` scores the candidate beside the champion on the
  same host feature rows, through the predict the champion's kind serves
  with: the plain predict for logreg (the fused kernel needs state rows),
  mlp and autoencoder, the leaf-sum kernel for tree kinds whose tables
  ``admit_tables`` admits (the tables derived once per candidate), the
  plain predict otherwise. The sequence kind has no feature-row predict
  and is refused, as the engine refuses its shadow.
  It counts divergence and keeps live precision/recall per model from the
  feedback stream.
- :class:`LearningLoop`, the promotion controller, polled once per
  finished batch between steps: installs published candidates into
  shadow, promotes when the candidate's live metrics beat the champion's
  (re-verifying the artifact at the gate), watches the new champion and
  rolls back on a regression. Promotion, rollback and resync swap params
  through :meth:`~.engine.ScoringEngine.swap_params`, in place.

Everything but the learner's worker runs on the serving loop thread
between steps (the contract of :class:`~.feedback.FeedbackLoop`).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.core.batch import bucket_size
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    CorruptModelError,
    TrainedModel,
)
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    resolve_z_mode,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import transform
from real_time_fraud_detection_system_tpu_torch.ops.forest_kernels import (
    leaf_sum,
    leaf_sum_tables,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    device_params_for,
    feedback_step,
    host_to_device,
    loss_fn_for,
    predict_fn_for,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from real_time_fraud_detection_system_tpu_torch.utils.logging import (
    get_logger,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    active_recorder,
    get_registry,
)

log = get_logger("learner")

# |p_candidate - p_champion| ladder for the score-delta histogram
SCORE_DELTA_BUCKETS = (1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
                       0.1, 0.25, 0.5, 1.0)


def _own_copy(params, device, stream):
    """A copy of a params or scaler tree on ``device`` that shares no
    storage with the caller's, made on the caller's stream; on the card
    ``stream`` waits for an event behind the copy (not for the caller's
    later work) and the copy's blocks are marked as used by it."""
    out = tree.clone(tree.to(params, device))
    if stream is not None:
        done = torch.cuda.Event()
        done.record()
        stream.wait_event(done)
        for leaf in tree.leaves(out):
            if isinstance(leaf, torch.Tensor):
                leaf.record_stream(stream)
    return out


def _on(stream):
    """The context that makes ``stream`` current (none on the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


class LiveModelMetrics:
    """Windowed confusion counts → live precision/recall for one model.
    ``reset()`` starts a fresh comparison window, so champion and
    candidate are judged on the same stretch of labeled traffic."""

    def __init__(self, role: str, threshold: float = 0.5, registry=None):
        self.role = role
        self.threshold = float(threshold)
        reg = registry if registry is not None else get_registry()
        self._g_prec = reg.gauge(
            "rtfds_live_precision",
            "live precision over the current label window", model=role)
        self._g_rec = reg.gauge(
            "rtfds_live_recall",
            "live recall over the current label window", model=role)
        self._m_labels = reg.counter(
            "rtfds_live_labels_total",
            "feedback labels scored into the live metric windows",
            model=role)
        self.tp = self.fp = self.fn = self.tn = 0

    def reset(self) -> None:
        self.tp = self.fp = self.fn = self.tn = 0
        self._g_prec.set(0.0)
        self._g_rec.set(0.0)

    def observe(self, probs: np.ndarray, labels: np.ndarray) -> None:
        if len(labels) == 0:
            return
        pred = np.asarray(probs) >= self.threshold
        y = np.asarray(labels) > 0
        self.tp += int((pred & y).sum())
        self.fp += int((pred & ~y).sum())
        self.fn += int((~pred & y).sum())
        self.tn += int((~pred & ~y).sum())
        self._m_labels.inc(len(labels))
        self._g_prec.set(self.precision)
        self._g_rec.set(self.recall)

    @property
    def n(self) -> int:
        return self.tp + self.fp + self.fn + self.tn

    @property
    def positives(self) -> int:
        """Fraud labels in the window: recall is undefined without any."""
        return self.tp + self.fn

    @property
    def precision(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class ShadowScorer:
    """Score the candidate beside the champion on the same batches.

    The engine calls :meth:`score_batch` once per emitted batch (loop
    thread) with the host feature rows and the champion's probabilities.
    The rows go through a pinned staging buffer per bucket to the card,
    on the scorer's own stream, and the candidate's probabilities come
    back; the serving step is untouched. Scores are cached by tx_id
    (direct-mapped, bounded) so delayed labels join back to both models'
    decisions; each entry is consumed once, so label replays never
    double-count the confusion windows.
    """

    def __init__(self, kind: str, cfg, capacity: int = 1 << 16,
                 decision_threshold: float = 0.5,
                 divergence_threshold: float = 0.25, registry=None,
                 device=None):
        self.kind = kind
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.decision_threshold = float(decision_threshold)
        self.divergence_threshold = float(divergence_threshold)
        self.candidate_version: Optional[int] = None
        self._cand_params = None
        self._cand_scaler = None
        self._cand_tables = None
        # the champion's arithmetic (runtime.z_mode): a mode split would
        # let the shadow diverge for arithmetic reasons, not model ones
        self.z_mode = resolve_z_mode(cfg.runtime.z_mode, self.device)
        self._predict = predict_fn_for(kind, self.z_mode)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._staging: dict = {}  # bucket → pinned [pad, F] float32
        self._ids = np.full(self.capacity, -1, np.int64)
        self._champ_p = np.zeros(self.capacity, np.float32)
        self._cand_p = np.zeros(self.capacity, np.float32)
        self._has_cand = np.zeros(self.capacity, bool)
        reg = registry if registry is not None else get_registry()
        self.champion = LiveModelMetrics(
            "champion", threshold=decision_threshold, registry=reg)
        self.candidate = LiveModelMetrics(
            "candidate", threshold=decision_threshold, registry=reg)
        self._m_rows = reg.counter(
            "rtfds_shadow_rows_total",
            "rows dual-scored by the shadow candidate")
        self._m_div = reg.counter(
            "rtfds_shadow_divergence_total",
            "rows where candidate and champion disagree (decision flip "
            "at the decision threshold, or |Δp| over the divergence "
            "threshold)")
        self._h_delta = reg.histogram(
            "rtfds_shadow_score_delta",
            "per-batch max |candidate - champion| score delta",
            buckets=SCORE_DELTA_BUCKETS)

    # -- candidate management (loop thread) -------------------------------

    def _clear_cache(self) -> None:
        self._ids.fill(-1)
        self._has_cand.fill(False)

    def set_candidate(self, version: int, params, scaler,
                      fresh_window: bool = True) -> None:
        """Install a verified candidate for dual scoring: its params in
        device form on the scorer's device, and, for a tree kind the
        leaf-sum kernel admits, its kernel tables (derived once here).

        ``fresh_window=True`` (the first candidate of a comparison)
        restarts both metric windows and drops the score cache;
        ``False`` (a newer version of the same candidate stream) keeps
        them, so the comparison measures the stream's live quality."""
        params = _own_copy(device_params_for(self.kind, params),
                           self.device, self._stream)
        self._cand_scaler = _own_copy(scaler, self.device, self._stream)
        self._cand_params = params
        with _on(self._stream):
            self._cand_tables = leaf_sum_tables(params, self.z_mode)
        self.candidate_version = int(version)
        if fresh_window:
            self._clear_cache()
            self.champion.reset()
            self.candidate.reset()

    def clear_candidate(self) -> None:
        self._cand_params = None
        self._cand_scaler = None
        self._cand_tables = None
        self.candidate_version = None
        self._clear_cache()
        self.candidate.reset()

    def _candidate_probs(self, x: torch.Tensor) -> torch.Tensor:
        """The candidate's predict on raw rows ``x`` (device tensor)."""
        z = transform(self._cand_scaler, x)
        tables = self._cand_tables
        if tables is None:
            return self._predict(self._cand_params, z)
        leaf = leaf_sum(tables, z)
        if self.kind == "gbt":
            return torch.sigmoid(self._cand_params.base_score + leaf)
        return leaf / tables.n_trees

    # -- hot path (loop thread, once per emitted batch) -------------------

    def score_batch(self, tx_ids: np.ndarray, feats_np: np.ndarray,
                    champ_probs: np.ndarray) -> None:
        n = len(tx_ids)
        if n == 0:
            return
        tx_ids = np.asarray(tx_ids, dtype=np.int64)
        champ = np.asarray(champ_probs[:n], dtype=np.float32)
        cand = None
        if self._cand_params is not None:
            pad = bucket_size(n, self.cfg.runtime.batch_buckets)
            n_feat = feats_np.shape[1]
            x = self._staging.get(pad)
            if x is None or x.shape[1] != n_feat:
                x = torch.zeros((pad, n_feat), dtype=torch.float32,
                                pin_memory=self._stream is not None)
                self._staging[pad] = x
            elif n < pad:
                # rows [:n] are overwritten below; only the pad tail can
                # hold a previous batch's rows
                x[n:] = 0.0
            x.numpy()[:n] = feats_np[:n]
            with _on(self._stream):
                probs = self._candidate_probs(
                    x.to(self.device, non_blocking=True))
                # the copy back syncs this stream only (and the staging
                # buffer is free again once it returns)
                cand = probs[:n].cpu().numpy()
            thr = self.decision_threshold
            delta = np.abs(cand - champ)
            flips = ((cand >= thr) != (champ >= thr)) \
                | (delta > self.divergence_threshold)
            self._m_rows.inc(n)
            if flips.any():
                self._m_div.inc(int(flips.sum()))
            self._h_delta.observe(float(delta.max()))
        slots = tx_ids % self.capacity
        self._ids[slots] = tx_ids
        self._champ_p[slots] = champ
        if cand is not None:
            self._cand_p[slots] = cand
            self._has_cand[slots] = True
        else:
            self._has_cand[slots] = False

    def observe_labels(self, tx_ids: np.ndarray, labels: np.ndarray) -> None:
        """Join arrived labels to the cached scores and update the live
        confusion windows; each cached entry is consumed once."""
        tx_ids = np.asarray(tx_ids, dtype=np.int64)
        labels = np.asarray(labels)
        good = labels >= 0
        if not good.any():
            return
        tx_ids, labels = tx_ids[good], labels[good]
        slots = tx_ids % self.capacity
        hit = (self._ids[slots] == tx_ids) & (tx_ids >= 0)
        if not hit.any():
            return
        sel = slots[hit]
        y = labels[hit]
        self.champion.observe(self._champ_p[sel], y)
        with_cand = self._has_cand[sel]
        if with_cand.any():
            self.candidate.observe(self._cand_p[sel][with_cand],
                                   y[with_cand])
        self._ids[sel] = -1  # one observation per transaction
        self._has_cand[sel] = False


class StreamingLearner:
    """Fit a candidate on the feedback window off the loop thread and
    publish it to the registry on a label cadence.

    The loop's cost is one bounded-queue enqueue per labeled-feedback
    application (:meth:`submit`); a full queue drops
    (``rtfds_learner_dropped_labels_total``): serving never waits on
    training. A worker failure is re-raised on the loop thread with its
    original type at the next ``submit``/``raise_pending``.
    ``pause()``/``resume()`` gate the worker around poison isolation.

    Training is the engine's backtracking SGD (:func:`~.engine.
    feedback_step`, halving until the step contracts) over a bounded
    replay window of the newest labeled rows, ``epochs`` passes per
    submission, on the learner's own copy of the params, on its own CUDA
    stream on the card.
    """

    _STOP = object()

    def __init__(self, kind: str, params, scaler, cfg, registry,
                 parent_version: Optional[int] = None,
                 publish_every_labels: int = 512, max_queue: int = 8,
                 learning_rate: Optional[float] = None, epochs: int = 2,
                 window_rows: int = 4096, metrics=None, device=None):
        loss = loss_fn_for(kind)
        if loss is None:
            raise ValueError(
                f"model kind {kind!r} has no gradient path — the "
                "streaming learner fits differentiable kinds "
                "(logreg/mlp/autoencoder); tree ensembles retrain "
                "offline and publish to the registry directly")
        self.kind = kind
        self.cfg = cfg
        self.registry = registry
        self.device = resolve_device(device)
        self.parent_version = parent_version
        self.publish_every_labels = int(publish_every_labels)
        self.learning_rate = float(
            learning_rate if learning_rate is not None
            else cfg.train.online_learning_rate)
        self.epochs = max(1, int(epochs))
        self.window_rows = max(1, int(window_rows))
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        # candidate state: the worker owns it; reset() from the loop
        # thread takes the same lock
        self._plock = threading.Lock()
        self._params = _own_copy(params, self.device, self._stream)
        self._scaler = _own_copy(scaler, self.device, self._stream)
        # bumped by reset(): training that started against an older
        # generation discards its result
        self._gen = 0
        # the replay window, trimmed back under window_rows after every
        # append (whole chunks)
        self._buf_x: List[np.ndarray] = []
        self._buf_y: List[np.ndarray] = []
        self._buf_rows = 0
        self._labels_since_publish = 0
        self.labels_total = 0

        def fb(params, scaler, x_raw, y, valid, lr):
            return feedback_step(loss, params, scaler, x_raw, y, valid, lr)

        self._fb_step = fb
        reg = metrics if metrics is not None else get_registry()
        self._m_trained = reg.counter(
            "rtfds_learner_labels_trained_total",
            "labeled rows the streaming learner fitted on")
        self._m_dropped = reg.counter(
            "rtfds_learner_dropped_labels_total",
            "labeled rows dropped because the learner queue was full "
            "(serving never blocks on training)")
        self._m_published = reg.counter(
            "rtfds_learner_published_total",
            "candidate versions the learner published to the registry")
        self._g_queue = reg.gauge(
            "rtfds_learner_queue_depth",
            "labeled-feedback chunks waiting for the learner thread")
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(max_queue)))
        self._published: List[int] = []
        self._pub_lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._paused = threading.Event()
        # pause/train handshake: the worker enters training only under
        # this condition while not paused; pause() waits out a chunk in
        # flight
        self._train_cond = threading.Condition()
        self._in_train = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="learner")
        self._thread.start()

    # -- loop-thread API --------------------------------------------------

    def raise_pending(self) -> None:
        """Re-raise a worker failure with its original type; clears it so
        a recovered incarnation resumes training."""
        err, self._err = self._err, None
        if err is not None:
            raise err

    def submit(self, feats: np.ndarray, labels: np.ndarray) -> None:
        """Hand the learner a chunk of labeled rows (raw serving features,
        what the champion's SGD consumed)."""
        self.raise_pending()
        if len(labels) == 0:
            return
        try:
            self._q.put_nowait((np.array(feats, np.float32, copy=True),
                                np.array(labels, np.int32, copy=True)))
        except queue.Full:
            self._m_dropped.inc(len(labels))
        self._g_queue.set(self._q.qsize())

    def take_published(self) -> Optional[int]:
        """Newest candidate version published since the last call (older
        unconsumed ones are superseded), or None."""
        with self._pub_lock:
            if not self._published:
                return None
            v = self._published[-1]
            self._published.clear()
        return v

    def pause(self, timeout_s: float = 60.0) -> None:
        """Stop consuming AND wait out a chunk in flight (poison isolation
        runs unaccompanied). Submissions still enqueue up to the bound.
        The timeout is a backstop for a wedged device, logged."""
        self._paused.set()
        with self._train_cond:
            deadline = time.monotonic() + timeout_s
            while self._in_train:
                left = deadline - time.monotonic()
                if left <= 0:
                    log.warning(
                        "learner pause: the training chunk in flight did "
                        "not finish within %.0fs; poison isolation "
                        "proceeds beside it", timeout_s)
                    return
                self._train_cond.wait(left)

    def resume(self) -> None:
        self._paused.clear()
        with self._train_cond:
            self._train_cond.notify_all()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    def reset(self, params, scaler, parent_version: Optional[int]) -> None:
        """Warm-restart the candidate (after a promotion from the new
        champion, after a rollback from the restored one) and drop the
        replay window: it was evidence for a decided comparison."""
        params = _own_copy(params, self.device, self._stream)
        scaler = _own_copy(scaler, self.device, self._stream)
        with self._plock:
            self._gen += 1
            self._params = params
            self._scaler = scaler
            self.parent_version = parent_version
            self._buf_x.clear()
            self._buf_y.clear()
            self._buf_rows = 0
            self._labels_since_publish = 0

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Block until every queued chunk is processed (tests and a clean
        shutdown); re-raises a pending worker failure."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.raise_pending()
            # unfinished_tasks drops only at task_done(), after the chunk
            # trained: no window between get() and the busy mark
            if self._q.unfinished_tasks == 0:
                return True
            time.sleep(0.005)
        return False

    def close(self) -> None:
        self._paused.clear()
        self._q.put(self._STOP)
        self._thread.join(timeout=10.0)

    # -- worker thread ----------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is self._STOP:
                    return
                # the pause check and the in-train mark share one lock:
                # once pause() set the flag the worker cannot slip in
                with self._train_cond:
                    while self._paused.is_set():
                        self._train_cond.wait(0.05)
                    self._in_train = True
                try:
                    if self._err is None:
                        self._train(*item)
                    # while a failure is pending queued chunks are
                    # discarded: their labels replay after recovery
                finally:
                    with self._train_cond:
                        self._in_train = False
                        self._train_cond.notify_all()
            # the thread boundary: the original exception is parked for
            # the loop thread to re-raise with its type
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()
                self._g_queue.set(self._q.qsize())

    def _train(self, feats: np.ndarray, labels: np.ndarray) -> None:
        with self._plock:
            gen = self._gen
            self._buf_x.append(feats)
            self._buf_y.append(labels)
            self._buf_rows += len(labels)
            while self._buf_rows > self.window_rows and len(self._buf_x) > 1:
                self._buf_rows -= len(self._buf_y.pop(0))
                self._buf_x.pop(0)
            x_all = np.concatenate(self._buf_x)
            y_all = np.concatenate(self._buf_y)
            params, scaler = self._params, self._scaler
        buckets = self.cfg.runtime.batch_buckets
        biggest = max(buckets)
        with _on(self._stream):
            for _ in range(self.epochs):
                for s in range(0, len(y_all), biggest):
                    yc = y_all[s:s + biggest]
                    n = len(yc)
                    pad = bucket_size(n, buckets)
                    x = np.zeros((pad, x_all.shape[1]), np.float32)
                    x[:n] = x_all[s:s + n]
                    y = np.zeros(pad, np.int32)
                    y[:n] = np.maximum(yc, 0)
                    valid = np.zeros(pad, bool)
                    valid[:n] = yc >= 0
                    if not valid.any():
                        continue
                    dx, dy, dv = (host_to_device(a, self.device)
                                  for a in (x, y, valid))
                    lr = self.learning_rate
                    for _h in range(8):  # halvings until the step contracts
                        new, l0, l1 = self._fb_step(params, scaler, dx, dy,
                                                    dv, lr)
                        if bool(l1 <= l0):
                            params = new
                            break
                        lr *= 0.5
        n_new = int((labels >= 0).sum())
        with self._plock:
            if self._gen != gen:
                # a reset landed mid-train: this result descends from the
                # superseded lineage — discard it
                return
            self._params = params
            self.labels_total += n_new
            self._labels_since_publish += n_new
            publish = self._labels_since_publish >= self.publish_every_labels
        self._m_trained.inc(n_new)
        if publish:
            self._publish(gen)

    def _publish(self, gen: int) -> None:
        with self._plock:
            if self._gen != gen:
                # a reset between the write-back and here: _params is the
                # reset champion now, not a candidate
                return
            model = TrainedModel(kind=self.kind, scaler=self._scaler,
                                 params=self._params)
            parent = self.parent_version
            labels = self.labels_total
            self._labels_since_publish = 0
        # the registry write runs unlocked: a loop-thread reset() never
        # waits on a store
        with _on(self._stream):
            version = self.registry.publish(
                model, parent=parent, source="learner",
                labels_trained=labels)
        self._m_published.inc()
        with self._plock:
            stale = self._gen != gen
        if not stale:
            # a reset during the write supersedes this version: it stays
            # in the registry as lineage but is never installed
            with self._pub_lock:
                self._published.append(version)
        log.info("published candidate v%d (parent v%s, %d labels)",
                 version, parent, labels)


class LearningLoop:
    """The promotion controller: shadow install → gated canary promotion
    → regression rollback, polled once per finished batch between steps.

    Every decision comes from the live metric windows the feedback stream
    feeds, and re-verifies the artifact at the gate: a corrupt candidate
    is refused (``rtfds_model_promotions_total{outcome=refused_corrupt}``)
    and the champion keeps serving.
    """

    def __init__(self, registry, cfg, kind: str, model=None, learner=None,
                 metrics=None, model_is_champion: bool = True, device=None):
        lc = cfg.learn
        self.registry = registry
        self.cfg = cfg
        self.kind = kind
        self.learner = learner
        self.promote_min_labels = int(lc.promote_min_labels)
        self.promote_margin = float(lc.promote_margin)
        self.precision_tolerance = float(lc.precision_tolerance)
        self.rollback_min_labels = int(lc.rollback_min_labels)
        self.rollback_margin = float(lc.rollback_margin)
        reg = metrics if metrics is not None else get_registry()
        self._m_promotions = {
            o: reg.counter(
                "rtfds_model_promotions_total",
                "candidate promotion attempts by outcome", outcome=o)
            for o in ("promoted", "refused_corrupt")
        }
        self._m_rollbacks = reg.counter(
            "rtfds_model_rollbacks_total",
            "champions rolled back after a live-metric regression")
        self._m_resyncs = reg.counter(
            "rtfds_model_resyncs_total",
            "incarnations whose starting params predated the registry "
            "champion and were re-synced to it at attach")
        self.shadow = ShadowScorer(
            kind, cfg, capacity=int(lc.shadow_cache_rows),
            decision_threshold=float(lc.decision_threshold),
            divergence_threshold=float(lc.divergence_threshold),
            registry=reg, device=device)
        # an empty registry adopts the serving model as v1: from here on
        # every params swap is a versioned event
        if registry.champion_version() is None and model is not None:
            v = registry.publish(model, source="bootstrap")
            registry.promote(v, by="bootstrap")
        self.champion_version = registry.champion_version()
        # the version fresh engines are built with (None when the caller
        # could not adopt the champion: every attach then re-applies it)
        self._boot_version = (self.champion_version
                              if model_is_champion else None)
        if (model_is_champion and learner is not None
                and learner.parent_version is None):
            learner.parent_version = self.champion_version
        # post-promotion watch: the baseline the new champion must hold
        self._watch: Optional[dict] = None
        # newest published version waiting out an active canary watch
        self._pending_install: Optional[int] = None
        self._attached = None  # the engine currently wired
        # without an in-stream learner (tree kinds) candidates arrive by
        # external publish: poll the registry on a batch cadence
        self._ext_every = (int(lc.external_poll_batches)
                           if learner is None else 0)
        self._ext_tick = 0
        self._ext_seen: Optional[int] = None

    # -- engine wiring ----------------------------------------------------

    def attach(self, engine) -> None:
        """Install the shadow scorer and the learner's tap on the engine
        (once per engine: a supervisor's next incarnation brings a fresh
        one), then re-sync it to the registry champion."""
        if self._attached is engine:
            return
        if engine.state.model_version is None:
            # a fresh engine (no checkpoint stamp) serves the model the
            # caller built engines from: the adoption-time champion
            engine.state.model_version = self._boot_version
        engine.set_shadow(self.shadow)
        if self.learner is not None:
            engine.feedback_tap = self.learner.submit
        self._attached = engine
        self._resync(engine)

    def _resync(self, engine) -> None:
        """Re-apply the current champion when the engine's stamp
        disagrees with the registry pointer (a restore can predate a
        promotion or reload). Counted in ``rtfds_model_resyncs_total``; a
        champion that fails verification leaves the params serving,
        loudly."""
        v = self.champion_version
        stamp = engine.state.model_version
        if v is None or stamp == v:
            return
        try:
            m = self.registry.get(v)
        except (CorruptModelError, KeyError) as e:
            log.error(
                "cannot re-apply champion v%s over restored params "
                "(stamp v%s): %s: %s — serving the restored params",
                v, stamp, type(e).__name__, e)
            return
        engine.swap_params(m.params, m.scaler)
        engine._online_dirty = False
        engine.state.model_version = v
        self._m_resyncs.inc()
        self._event("model_resync", version=v, restored_stamp=stamp)
        log.info("re-applied registry champion v%s (incarnation started "
                 "on v%s params)", v, stamp)

    def pause(self) -> None:
        """Gate the learner's worker around poison isolation."""
        if self.learner is not None:
            self.learner.pause()

    def resume(self) -> None:
        if self.learner is not None:
            self.learner.resume()

    @contextlib.contextmanager
    def held(self):
        """Hold the learner's worker idle for the block (a CUDA graph
        capture on the loop thread), then leave it paused or running as
        it was (an overload rung-1 pause outlasts the block)."""
        if self.learner is None or self.learner.paused:
            yield
            return
        self.learner.pause()
        try:
            yield
        finally:
            self.learner.resume()

    def close(self) -> None:
        if self.learner is not None:
            self.learner.pause()
            self.learner.close()

    def note_external_swap(self, params, scaler, outcome: str,
                           engine=None) -> None:
        """A hot reload swapped params from outside the registry: record
        it as a versioned event (publish + promote, source=reload).
        Best-effort: a params form the artifact writer cannot serialize
        (device-form tree tables) is logged, never fatal."""
        try:
            model = TrainedModel(kind=self.kind, scaler=scaler,
                                 params=params)
            v = self.registry.publish(model, parent=self.champion_version,
                                      source="reload", note=outcome)
            self.registry.promote(v, by="reload")
            self.champion_version = v
            if engine is not None:
                engine.state.model_version = v
            # the reload supersedes any canary comparison in flight
            self._watch = None
            self._pending_install = None
            self.shadow.clear_candidate()
            self.shadow.champion.reset()
            if self.learner is not None:
                self.learner.reset(params, scaler, v)
        # any registry failure leaves serving on the swapped params
        except Exception as e:  # noqa: BLE001
            log.warning("could not register hot-reloaded params as a "
                        "version (%s: %s); serving is unaffected",
                        type(e).__name__, e)

    # -- per-batch control (loop thread) ----------------------------------

    def on_batch(self, engine) -> None:
        if self.learner is not None:
            self.learner.raise_pending()
            v = self.learner.take_published()
            if v is not None:
                self._pending_install = v
        elif self._ext_every > 0:
            self._ext_tick += 1
            if self._ext_tick >= self._ext_every:
                self._ext_tick = 0
                self._poll_external()
        if self._watch is not None:
            self._maybe_rollback(engine)
        if self._watch is None:
            # installs wait out an active watch (an install resets the
            # champion's window, which is the canary evidence)
            v = self._pending_install
            self._pending_install = None
            if v is not None and v != self.shadow.candidate_version:
                self._install_candidate(engine, v)
            if self.shadow.candidate_version is not None:
                self._maybe_promote(engine)

    def _poll_external(self) -> None:
        """One registry listing: an externally published candidate this
        loop has not handled yet?"""
        try:
            vs = self.registry.versions()
        # a flaky listing skips one poll; the next cadence retries
        except Exception as e:  # noqa: BLE001
            log.warning("registry poll for external candidates failed "
                        "(%s: %s); retrying next cadence",
                        type(e).__name__, e)
            return
        if not vs:
            return
        v = vs[-1]
        if v in (self.champion_version, self.shadow.candidate_version,
                 self._ext_seen):
            return
        self._ext_seen = v
        self._pending_install = v
        log.info("externally published candidate v%d detected", v)

    def _install_candidate(self, engine, version: int) -> None:
        try:
            m = self.registry.get(version)
        except (CorruptModelError, KeyError) as e:
            # quarantined and counted by the registry, or vanished since
            # the listing: refuse, keep the current shadow
            self._m_promotions["refused_corrupt"].inc()
            self._event("model_promote_refused", version=version,
                        stage="shadow_install",
                        reason=getattr(e, "reason", "missing"))
            return
        if m.kind != self.kind:
            log.warning("candidate v%d is kind=%r but the serving kind "
                        "is %r; not installing", version, m.kind, self.kind)
            self._event("model_promote_refused", version=version,
                        stage="shadow_install", reason="kind_mismatch")
            return
        self.shadow.set_candidate(
            version, m.params, m.scaler,
            fresh_window=self.shadow.candidate_version is None)
        self._event("model_candidate", version=version,
                    champion=self.champion_version)

    def _maybe_promote(self, engine) -> None:
        ch, cand = self.shadow.champion, self.shadow.candidate
        if (cand.n < self.promote_min_labels
                or ch.n < self.promote_min_labels):
            return
        if (cand.recall > ch.recall + self.promote_margin
                and cand.precision >= ch.precision
                - self.precision_tolerance):
            self._promote(engine)

    def _promote(self, engine) -> None:
        version = self.shadow.candidate_version
        baseline = {"recall": self.shadow.candidate.recall,
                    "precision": self.shadow.candidate.precision}
        try:
            m = self.registry.get(version)  # re-verify AT the gate
        except (CorruptModelError, KeyError) as e:
            self._m_promotions["refused_corrupt"].inc()
            self._event("model_promote_refused", version=version,
                        stage="promote",
                        reason=getattr(e, "reason", "missing"))
            self.shadow.clear_candidate()
            return
        prev = self.champion_version
        engine.swap_params(m.params, m.scaler)
        engine.state.model_version = version
        # a promotion replaces the on-device params by design
        engine._online_dirty = False
        self.registry.promote(version)
        self.champion_version = version
        self._watch = {**baseline, "previous": prev}
        self.shadow.clear_candidate()
        self.shadow.champion.reset()
        if self.learner is not None:
            self.learner.reset(m.params, m.scaler, version)
        self._m_promotions["promoted"].inc()
        self._event("model_promoted", version=version, previous=prev,
                    recall=round(baseline["recall"], 4),
                    precision=round(baseline["precision"], 4))
        log.info("promoted candidate v%s over champion v%s "
                 "(live recall %.3f, precision %.3f)", version, prev,
                 baseline["recall"], baseline["precision"])

    def _maybe_rollback(self, engine) -> None:
        ch = self.shadow.champion
        if ch.n < self.rollback_min_labels or ch.positives == 0:
            # no fraud labels yet: recall is undefined, not 0.0
            return
        watch, self._watch = self._watch, None
        if ch.recall >= watch["recall"] - self.rollback_margin:
            self._event("model_canary_passed",
                        version=self.champion_version,
                        recall=round(ch.recall, 4))
            return
        self._rollback(engine, watch)

    def _rollback(self, engine, watch: dict) -> None:
        prev = watch["previous"]
        regressed = self.champion_version
        regressed_recall = self.shadow.champion.recall
        try:
            m = self.registry.get(prev)
        except (CorruptModelError, KeyError) as e:
            log.error("rollback target v%s failed verification (%s); "
                      "keeping the regressed champion — operator "
                      "intervention needed", prev, e)
            return
        engine.swap_params(m.params, m.scaler)
        engine.state.model_version = prev
        engine._online_dirty = False
        self.registry.rollback()
        self.champion_version = prev
        self.shadow.champion.reset()
        self.shadow.clear_candidate()
        # anything published during the watch descends from the
        # regressed champion
        self._pending_install = None
        if self.learner is not None:
            self.learner.reset(m.params, m.scaler, prev)
        self._m_rollbacks.inc()
        self._event("model_rollback", version=prev, regressed=regressed,
                    recall=round(regressed_recall, 4),
                    baseline=round(watch["recall"], 4))
        log.warning("rolled back champion v%s → v%s (live recall fell "
                    "below the promotion baseline %.3f)", regressed, prev,
                    watch["recall"])

    def _event(self, name: str, **fields) -> None:
        rec = active_recorder()
        if rec is not None:
            rec.record_event(name, **fields)
