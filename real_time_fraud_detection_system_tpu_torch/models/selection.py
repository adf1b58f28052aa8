"""Model selection: prequential validation, grid search, k-fold CV —
port of the JAX package's ``models/selection.py``.

The reference's model-selection machinery from
``fraud_detection_model/shared_functions.py``:

- ``prequentialSplit`` (``:265-292``) → :func:`prequential_split` — n
  time-shifted train/delay/test folds, most recent first;
- ``prequential_grid_search`` (``:774-814``) → :func:`prequential_grid_search`
  — hyper-parameter sweep where every candidate is scored on every
  prequential fold, with fit/predict wall-clock recorded per fold (the
  reference's ``training_execution_time`` / ``prediction_execution_time``
  hooks, ``:312-320``);
- ``model_selection_wrapper`` (``:824-872``) → :func:`model_selection_wrapper`
  — the validation+test double sweep;
- ``kfold_cv_with_classifier`` (``:882-911``) → :func:`kfold_cv_with_classifier`
  — stratified k-fold CV for non-temporal sanity checks;
- ``get_summary_performances`` (``:597-648``) → :func:`summarize_performances`
  — mean±std per candidate, best-by-validation choice, and the test
  performance of that choice.

Everything operates on plain numpy + the typed :class:`..config.Config`; no
pandas DataFrames in the loop. Fits and predictions run on the given device
(None = CUDA).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from real_time_fraud_detection_system_tpu_torch.config import Config
from real_time_fraud_detection_system_tpu_torch.data.generator import Transactions
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.models.metrics import (
    performance_assessment,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    fit_scaler,
)
from real_time_fraud_detection_system_tpu_torch.models.train import (
    TrainedModel,
    device_sync,
    fit_classifier,
    scale_features,
    scale_split_to_txs,
    train_delay_test_split,
)

METRIC_KEYS = ("auc_roc", "average_precision", "card_precision@100")


def prequential_split(
    txs: Transactions,
    start_day_training: int,
    n_folds: int = 4,
    delta_train: int = 153,
    delta_delay: int = 30,
    delta_assessment: int = 30,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """n (train_mask, test_mask) folds, fold i shifted back i*delta_assessment.

    Fold 0 is the most recent window, matching ``shared_functions.py:265-292``
    where ``start_date_training - fold_index*delta_assessment`` walks
    backwards in time. Folds whose training window would start before day 0
    are dropped (the reference would silently produce empty frames), and
    spans that don't fit the dataset are auto-scaled like
    :func:`~.train.fit_split_to_days` does for ``train_model`` — the
    default 153/30/30 on a short dataset would otherwise give every fold
    an empty test window (NaN metric rows across the whole sweep).
    """
    delta_train, delta_delay, delta_assessment = scale_split_to_txs(
        txs, delta_train, delta_delay, delta_assessment,
        start_day=start_day_training, logger_name="selection",
    )
    folds = []
    for i in range(n_folds):
        sd = start_day_training - i * delta_assessment
        if sd < 0:
            break
        folds.append(
            train_delay_test_split(
                txs,
                start_day=sd,
                delta_train=delta_train,
                delta_delay=delta_delay,
                delta_test=delta_assessment,
            )
        )
    return folds


def expand_param_grid(param_grid: Dict[str, Sequence]) -> List[Dict]:
    """{'forest_max_depth': [2, 8], ...} → list of single-value dicts
    (cartesian product, like sklearn's ParameterGrid)."""
    if not param_grid:
        return [{}]
    keys = sorted(param_grid)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(param_grid[k] for k in keys))
    ]


def _apply_params(cfg: Config, params: Dict) -> Config:
    """Override ModelConfig/TrainConfig fields named in ``params``."""
    model_fields = {f.name for f in dataclasses.fields(cfg.model)}
    train_fields = {f.name for f in dataclasses.fields(cfg.train)}
    m_over = {k: v for k, v in params.items() if k in model_fields}
    t_over = {k: v for k, v in params.items() if k in train_fields}
    unknown = set(params) - m_over.keys() - t_over.keys()
    if unknown:
        raise ValueError(f"unknown hyper-parameters: {sorted(unknown)}")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **m_over),
        train=dataclasses.replace(cfg.train, **t_over),
    )


@dataclass
class FoldPerformance:
    """One (candidate, fold) evaluation row."""

    params: Dict
    fold: int
    expe_type: str  # "validation" | "test"
    metrics: Dict[str, float]
    fit_seconds: float
    predict_seconds: float
    n_train: int
    n_test: int


def prequential_grid_search(
    txs: Transactions,
    features: np.ndarray,
    cfg: Config,
    kind: str,
    param_grid: Dict[str, Sequence],
    start_day_training: int,
    n_folds: int = 4,
    expe_type: str = "test",
    delta_train: Optional[int] = None,
    delta_delay: Optional[int] = None,
    delta_assessment: Optional[int] = None,
    device=None,
) -> List[FoldPerformance]:
    """Every candidate × every prequential fold → a FoldPerformance row."""
    device = resolve_device(device)
    delta_train = cfg.train.delta_train_days if delta_train is None else delta_train
    delta_delay = cfg.train.delta_delay_days if delta_delay is None else delta_delay
    delta_assessment = (
        cfg.train.delta_test_days if delta_assessment is None else delta_assessment
    )
    folds = prequential_split(
        txs,
        start_day_training,
        n_folds=n_folds,
        delta_train=delta_train,
        delta_delay=delta_delay,
        delta_assessment=delta_assessment,
    )
    # Validate every candidate up front (fail before any expensive fit).
    candidates = [
        (cand, _apply_params(cfg, cand)) for cand in expand_param_grid(param_grid)
    ]
    rows: List[FoldPerformance] = []
    # Fold-major loop: scaling is hyper-parameter-independent, so each fold's
    # scaler fit + train-set transform happens once, not once per candidate.
    for i, (train_mask, test_mask) in enumerate(folds):
        x_train = features[train_mask]
        y_train = txs.tx_fraud[train_mask].astype(np.float32)
        scaler = fit_scaler(x_train, device)
        xs = scale_features(scaler, x_train)
        for cand, cand_cfg in candidates:
            t0 = time.perf_counter()
            params = fit_classifier(kind, xs, y_train, cand_cfg,
                                    device=device)
            device_sync(device)
            fit_s = time.perf_counter() - t0
            model = TrainedModel(kind=kind, scaler=scaler, params=params)
            t0 = time.perf_counter()
            probs = model.predict_proba(features[test_mask])
            pred_s = time.perf_counter() - t0
            metrics = performance_assessment(
                txs.tx_fraud[test_mask],
                probs,
                days=txs.tx_time_days[test_mask],
                customer_ids=txs.customer_id[test_mask],
            )
            rows.append(
                FoldPerformance(
                    params=cand,
                    fold=i,
                    expe_type=expe_type,
                    metrics=metrics,
                    fit_seconds=fit_s,
                    predict_seconds=pred_s,
                    n_train=int(train_mask.sum()),
                    n_test=int(test_mask.sum()),
                )
            )
    return rows


def model_selection_wrapper(
    txs: Transactions,
    features: np.ndarray,
    cfg: Config,
    kind: str,
    param_grid: Dict[str, Sequence],
    start_day_training_for_valid: int,
    start_day_training_for_test: int,
    n_folds: int = 4,
    **deltas,
) -> List[FoldPerformance]:
    """Validation sweep + test sweep (``shared_functions.py:824-872``).

    Validation folds end before the test period starts, so choosing
    hyper-parameters on them is unbiased; the matching test rows report what
    that choice would have achieved.

    Short datasets: the spans are scaled ONCE here, anchored at the later
    (test) sweep, and shared by both sweeps. Per-sweep scaling would let
    each sweep fill the data to its last day, overlapping the validation
    windows into the test period — selection would leak held-out days.
    With shared spans, the windows stay disjoint whenever the anchors are
    at least one (scaled) assessment span apart — the reference's own
    ``start_valid = start_test - delta_test`` convention.
    """
    dtr, dde, dte = scale_split_to_txs(
        txs,
        deltas.pop("delta_train", cfg.train.delta_train_days),
        deltas.pop("delta_delay", cfg.train.delta_delay_days),
        deltas.pop("delta_assessment", cfg.train.delta_test_days),
        start_day=start_day_training_for_test,
        logger_name="selection",
    )
    rows = prequential_grid_search(
        txs, features, cfg, kind, param_grid,
        start_day_training_for_valid, n_folds=n_folds,
        expe_type="validation", delta_train=dtr, delta_delay=dde,
        delta_assessment=dte, **deltas,
    )
    rows += prequential_grid_search(
        txs, features, cfg, kind, param_grid,
        start_day_training_for_test, n_folds=n_folds,
        expe_type="test", delta_train=dtr, delta_delay=dde,
        delta_assessment=dte, **deltas,
    )
    return rows


@dataclass
class SelectionSummary:
    """Per-metric selection outcome (``shared_functions.py:597-648``)."""

    metric: str
    best_params: Dict
    validation_mean: float
    validation_std: float
    test_mean: float
    test_std: float
    candidates: Dict[str, Dict[str, float]] = field(default_factory=dict)


def _param_key(params: Dict) -> str:
    return repr(sorted(params.items()))


def _mean_std(rows: List[FoldPerformance], metric: str) -> Tuple[float, float]:
    vals = np.array(
        [r.metrics[metric] for r in rows if np.isfinite(r.metrics.get(metric, np.nan))]
    )
    if len(vals) == 0:
        return float("nan"), float("nan")
    return float(vals.mean()), float(vals.std())


def summarize_performances(
    rows: List[FoldPerformance],
    metrics: Sequence[str] = METRIC_KEYS,
) -> Dict[str, SelectionSummary]:
    """For each metric: candidate means±stds, the best-by-validation
    candidate, and its test performance."""
    by_params: Dict[str, Tuple[Dict, List[FoldPerformance]]] = {}
    for r in rows:
        by_params.setdefault(_param_key(r.params), (r.params, []))[1].append(r)

    out: Dict[str, SelectionSummary] = {}
    for metric in metrics:
        candidates: Dict[str, Dict[str, float]] = {}
        best_key, best_val = None, -np.inf
        for key, (params, prs) in by_params.items():
            v_mean, v_std = _mean_std(
                [r for r in prs if r.expe_type == "validation"], metric
            )
            t_mean, t_std = _mean_std(
                [r for r in prs if r.expe_type == "test"], metric
            )
            candidates[key] = {
                "validation_mean": v_mean,
                "validation_std": v_std,
                "test_mean": t_mean,
                "test_std": t_std,
            }
            if np.isfinite(v_mean) and v_mean > best_val:
                best_key, best_val = key, v_mean
        if best_key is None:  # no validation rows: fall back to test
            for key, c in candidates.items():
                if np.isfinite(c["test_mean"]) and c["test_mean"] > best_val:
                    best_key, best_val = key, c["test_mean"]
        params = by_params[best_key][0] if best_key else {}
        c = candidates.get(best_key, {}) if best_key else {}
        out[metric] = SelectionSummary(
            metric=metric,
            best_params=params,
            validation_mean=c.get("validation_mean", float("nan")),
            validation_std=c.get("validation_std", float("nan")),
            test_mean=c.get("test_mean", float("nan")),
            test_std=c.get("test_std", float("nan")),
            candidates=candidates,
        )
    return out


def execution_times(rows: List[FoldPerformance]) -> Dict[str, Dict[str, float]]:
    """Mean fit/predict wall-clock per candidate
    (``shared_functions.py:499-512``)."""
    by_params: Dict[str, List[FoldPerformance]] = {}
    for r in rows:
        by_params.setdefault(_param_key(r.params), []).append(r)
    return {
        key: {
            "fit_seconds": float(np.mean([r.fit_seconds for r in prs])),
            "predict_seconds": float(np.mean([r.predict_seconds for r in prs])),
        }
        for key, prs in by_params.items()
    }


def kfold_cv_with_classifier(
    features: np.ndarray,
    labels: np.ndarray,
    cfg: Config,
    kind: str,
    n_folds: int = 5,
    seed: int = 0,
    device=None,
) -> Dict[str, float]:
    """Stratified k-fold CV (``shared_functions.py:882-911``) — the
    non-temporal sanity check. Returns mean±std AUC/AP over folds."""
    device = resolve_device(device)
    y = np.asarray(labels).astype(np.float32)
    bad = set(np.unique(y)) - {0.0, 1.0}
    if bad:
        raise ValueError(f"labels must be 0/1, got extra values {sorted(bad)}")
    rng = np.random.default_rng(seed)
    # Stratified fold assignment: shuffle within each class, deal round-robin.
    fold_of = np.empty(len(y), dtype=np.int64)
    for cls in (0, 1):
        idx = np.flatnonzero(y == cls)
        rng.shuffle(idx)
        fold_of[idx] = np.arange(len(idx)) % n_folds
    aucs, aps = [], []
    for f in range(n_folds):
        test_mask = fold_of == f
        train_mask = ~test_mask
        x_train = features[train_mask]
        scaler = fit_scaler(x_train, device)
        xs = scale_features(scaler, x_train)
        params = fit_classifier(kind, xs, y[train_mask], cfg, device=device)
        model = TrainedModel(kind=kind, scaler=scaler, params=params)
        probs = model.predict_proba(features[test_mask])
        m = performance_assessment(y[test_mask], probs)
        aucs.append(m["auc_roc"])
        aps.append(m["average_precision"])
    return {
        "auc_roc_mean": float(np.nanmean(aucs)),
        "auc_roc_std": float(np.nanstd(aucs)),
        "average_precision_mean": float(np.nanmean(aps)),
        "average_precision_std": float(np.nanstd(aps)),
        "n_folds": float(n_folds),
    }
