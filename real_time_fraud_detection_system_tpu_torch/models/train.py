"""Offline training pipeline: split → scale → fit → assess — port of the
JAX package's ``models/train.py``.

The reference's training protocol (``model_training.ipynb · cells
8,26,50``; ``shared_functions.py:133-188``): a time-based
train/delay/test split (153/30/30 days by default) where test days drop
the transactions of customers already known compromised — defrauded in
the train window, or by a fraud discovered up to each test day minus the
delay. Features come from :func:`..features.offline
.compute_features_replay`, so models train on exactly what serving
computes. Every step runs on the given device (None = CUDA); the gbt
booster and the sklearn fits run on the host, as in the JAX package, and
their tables land on the device. :class:`TrainedModel` lives in
``io/artifacts.py`` and is re-exported here.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.config import Config
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    make_batch,
    pack_batch,
    unpack_batch,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.history import (
    init_history_state,
    update_and_score,
)
from real_time_fraud_detection_system_tpu_torch.features.offline import (
    compute_features_replay,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    TrainedModel,
)
from real_time_fraud_detection_system_tpu_torch.models.autoencoder import (
    train_autoencoder,
)
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    fit_forest,
)
from real_time_fraud_detection_system_tpu_torch.models.gbt import train_gbt
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    train_logreg,
)
from real_time_fraud_detection_system_tpu_torch.models.metrics import (
    performance_assessment,
    rebalance_pos_weight,
)
from real_time_fraud_detection_system_tpu_torch.models.mlp import train_mlp
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    Scaler,
    fit_scaler,
    transform,
)
from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    build_sequences,
    train_transformer,
)
from real_time_fraud_detection_system_tpu_torch.utils.logging import (
    get_logger,
)
from real_time_fraud_detection_system_tpu_torch.utils.timing import (
    date_to_epoch_s,
)

__all__ = [
    "TrainedModel", "fit_split_to_days", "scale_split_to_txs",
    "train_delay_test_split", "fit_classifier", "fit_and_assess",
    "fit_and_assess_sequence", "train_sequence_model", "train_model",
    "scale_features", "device_sync",
]

SEQUENCE_EVAL_ROWS = 4096  # rows per batch of the sequence evaluation


def fit_split_to_days(n_days: int, delta_train: int, delta_delay: int,
                      delta_test: int) -> Tuple[int, int, int]:
    """Shrink a (train, delay, test) day split to fit an n_days dataset.

    When the spans do not fit, scale them proportionally (keeping the
    153:30:30 shape), train and test ≥ 1 day, leftover days to train. A
    ≤1-day dataset cannot hold disjoint train and test windows: it gets
    (n_days, 0, 0) and the caller's metrics are NaN."""
    need = delta_train + delta_delay + delta_test
    if n_days >= need or need <= 0:
        return delta_train, delta_delay, delta_test
    if n_days <= 1:
        return max(n_days, 0), 0, 0
    f = n_days / need
    test = max(1, int(delta_test * f))
    delay = int(delta_delay * f)
    train = max(1, n_days - delay - test)
    if train + delay + test > n_days:
        delay = max(0, n_days - train - test)
    return train, delay, test


def scale_split_to_txs(txs: Transactions, delta_train: int, delta_delay: int,
                       delta_test: int, start_day: int = 0,
                       logger_name: str = "train") -> Tuple[int, int, int]:
    """:func:`fit_split_to_days` against the days a split anchored at
    ``start_day`` has (days [start_day, dataset end)), with a warning
    when it scales them down."""
    n_days = int(txs.tx_time_days.max()) + 1 if txs.n else 0
    avail = max(0, n_days - start_day)
    scaled = fit_split_to_days(avail, delta_train, delta_delay, delta_test)
    if scaled != (delta_train, delta_delay, delta_test):
        get_logger(logger_name).warning(
            "%d days available from day %d < configured %d/%d/%d split; "
            "scaled to %d/%d/%d",
            avail, start_day, delta_train, delta_delay, delta_test, *scaled,
        )
    return scaled


def train_delay_test_split(txs: Transactions, start_day: int = 0,
                           delta_train: int = 153, delta_delay: int = 30,
                           delta_test: int = 30
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(train_mask, test_mask) over ``txs`` rows.

    A customer enters the known-compromised pool with a fraud in the
    train window, or with a fraud on day (test_day − delay) as the test
    days advance; their transactions leave the test set
    (``shared_functions.py:146-171``)."""
    days = txs.tx_time_days
    train_mask = (days >= start_day) & (days < start_day + delta_train)

    known = set(np.unique(
        txs.customer_id[train_mask & (txs.tx_fraud == 1)]).tolist())
    test_mask = np.zeros(txs.n, dtype=bool)
    test_start = start_day + delta_train + delta_delay
    for d in range(delta_test):
        # frauds discovered by this test day (delay days after they happened)
        disc_day = start_day + delta_train + d - 1
        disc = (days == disc_day) & (txs.tx_fraud == 1)
        known.update(np.unique(txs.customer_id[disc]).tolist())
        day_mask = days == test_start + d
        if known:
            known_arr = np.fromiter(known, dtype=np.int64)
            day_mask &= ~np.isin(txs.customer_id, known_arr)
        test_mask |= day_mask
    return train_mask, test_mask


def device_sync(device: torch.device) -> None:
    """Wait for the device, so a host clock covers the work it queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_classifier(kind: str, xs: np.ndarray, y_train: np.ndarray,
                   cfg: Config, pos_weight: Optional[float] = None,
                   device=None):
    """Fit one classifier of the zoo on pre-scaled features; the params
    land on ``device`` (None = CUDA). The dispatch ``train_model`` and the
    model-selection sweeps share (the reference's classifier dict,
    ``model_training.ipynb · cell 50``)."""
    device = resolve_device(device)
    if pos_weight is None:
        pos_weight = rebalance_pos_weight(y_train)
    m, t = cfg.model, cfg.train
    if kind == "logreg":
        return train_logreg(xs, y_train, learning_rate=t.learning_rate,
                            batch_size=t.batch_size, epochs=t.epochs,
                            pos_weight=pos_weight, seed=m.seed,
                            device=device)
    if kind == "mlp":
        return train_mlp(xs, y_train, hidden=tuple(m.mlp_hidden),
                         batch_size=t.batch_size, epochs=t.epochs,
                         pos_weight=pos_weight, seed=m.seed, device=device)
    if kind in ("tree", "forest"):
        return fit_forest(xs, y_train, n_trees=m.forest_n_trees,
                          max_depth=(m.tree_max_depth if kind == "tree"
                                     else m.forest_max_depth),
                          seed=m.seed, kind=kind, device=device)
    if kind == "gbt":
        return train_gbt(xs, y_train, n_trees=m.forest_n_trees,
                         max_depth=m.forest_max_depth, device=device)
    if kind == "autoencoder":
        return train_autoencoder(xs, y_train,
                                 hidden=tuple(m.autoencoder_hidden),
                                 batch_size=t.batch_size, epochs=t.epochs,
                                 seed=m.seed, device=device)
    raise ValueError(f"unknown model kind {kind}")


def scale_features(scaler: Scaler, x: np.ndarray) -> np.ndarray:
    """``transform`` on the scaler's device, back as float32 numpy."""
    return transform(scaler, torch.as_tensor(
        np.asarray(x, dtype=np.float32),
        device=scaler.mean.device)).cpu().numpy()


def fit_and_assess(txs: Transactions, features: np.ndarray, cfg: Config,
                   kind: str, train_mask: np.ndarray, test_mask: np.ndarray,
                   device=None
                   ) -> Tuple[TrainedModel, dict, float, float, np.ndarray]:
    """scale → fit → predict → assess on one (train, test) mask pair, on
    ``device``. Returns (model, test metrics, fit seconds, predict
    seconds, test probabilities); the two times are the reference's
    per-classifier execution-time hook (``shared_functions.py:312-320``),
    each ending in a device sync."""
    device = resolve_device(device)
    x_train = features[train_mask]
    y_train = txs.tx_fraud[train_mask].astype(np.float32)
    scaler = fit_scaler(x_train, device)
    xs = scale_features(scaler, x_train)
    t0 = time.perf_counter()
    params = fit_classifier(kind, xs, y_train, cfg, device=device)
    device_sync(device)
    fit_s = time.perf_counter() - t0
    model = TrainedModel(kind=kind, scaler=scaler, params=params)
    t0 = time.perf_counter()
    probs = model.predict_proba(features[test_mask])
    predict_s = time.perf_counter() - t0
    metrics = performance_assessment(
        txs.tx_fraud[test_mask], probs,
        days=txs.tx_time_days[test_mask],
        customer_ids=txs.customer_id[test_mask])
    return model, metrics, fit_s, predict_s, probs


def fit_and_assess_sequence(txs: Transactions, cfg: Config,
                            train_mask: np.ndarray, test_mask: np.ndarray,
                            start_date: Optional[str] = None, device=None
                            ) -> Tuple[TrainedModel, dict, float, float,
                                       np.ndarray]:
    """The sequence family's :func:`fit_and_assess`: train on the train
    window's histories, then evaluate by streaming the whole table through
    the ONLINE history step (``features/history.py::update_and_score``)
    in batches of 4,096 rows — the serving path, so train/serve skew shows
    here. Returns (model, test metrics, fit seconds, predict seconds,
    test probabilities)."""
    device = resolve_device(device)
    epoch0 = date_to_epoch_s(start_date or cfg.data.start_date)
    m = cfg.model
    seqs = build_sequences(txs.slice(train_mask),
                           max_len=cfg.features.history_len,
                           start_epoch_s=epoch0)
    t0 = time.perf_counter()
    params = train_transformer(
        seqs, d_model=m.seq_d_model, n_heads=m.seq_n_heads,
        n_layers=m.seq_n_layers, d_ff=m.seq_d_ff, epochs=cfg.train.epochs,
        seed=cfg.data.seed, device=device)
    device_sync(device)
    fit_s = time.perf_counter() - t0

    # serving-path evaluation: stream the table through the online step
    t_us = txs.epoch_us(epoch0)
    state = init_history_state(cfg.features, device)
    rows = SEQUENCE_EVAL_ROWS
    probs = torch.zeros(txs.n, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for s in range(0, txs.n, rows):
            e = min(s + rows, txs.n)
            packed = pack_batch(make_batch(
                customer_id=txs.customer_id[s:e],
                terminal_id=txs.terminal_id[s:e],
                tx_datetime_us=t_us[s:e],
                amount_cents=txs.amount_cents[s:e],
                pad_to=rows,
            ))
            batch = unpack_batch(torch.from_numpy(packed).to(device))
            state, p = update_and_score(state, params, batch, cfg.features)
            probs[s:e] = p[: e - s]
    probs = probs.cpu().numpy().astype(np.float64)
    predict_s = time.perf_counter() - t0
    metrics = performance_assessment(
        txs.tx_fraud[test_mask], probs[test_mask],
        days=txs.tx_time_days[test_mask],
        customer_ids=txs.customer_id[test_mask])
    scaler = Scaler(mean=torch.zeros(15, device=device),
                    scale=torch.ones(15, device=device))
    model = TrainedModel(kind="sequence", scaler=scaler, params=params)
    return model, metrics, fit_s, predict_s, probs[test_mask]


def _split_masks(txs: Transactions, cfg: Config):
    dtr, dde, dte = scale_split_to_txs(
        txs, cfg.train.delta_train_days, cfg.train.delta_delay_days,
        cfg.train.delta_test_days)
    return train_delay_test_split(txs, delta_train=dtr, delta_delay=dde,
                                  delta_test=dte)


def train_sequence_model(txs: Transactions, cfg: Config,
                         start_date: Optional[str] = None, device=None
                         ) -> Tuple[TrainedModel, dict]:
    """Offline training of the sequence (causal transformer) family — see
    :func:`fit_and_assess_sequence`."""
    train_mask, test_mask = _split_masks(txs, cfg)
    model, metrics, _, _, _ = fit_and_assess_sequence(
        txs, cfg, train_mask, test_mask, start_date=start_date,
        device=device)
    return model, metrics


def train_model(txs: Transactions, cfg: Config,
                features: Optional[np.ndarray] = None,
                kind: Optional[str] = None, device=None
                ) -> Tuple[TrainedModel, dict]:
    """End-to-end offline training on ``device`` (None = CUDA); returns
    (model, test metrics)."""
    kind = kind or cfg.model.kind
    if kind == "sequence":
        # trains on event histories, not the replayed features
        return train_sequence_model(txs, cfg, device=device)
    if features is None:
        features = compute_features_replay(
            txs, cfg.features, start_date=cfg.data.start_date,
            device=device)
    train_mask, test_mask = _split_masks(txs, cfg)
    model, metrics, _, _, _ = fit_and_assess(
        txs, features, cfg, kind, train_mask, test_mask, device=device)
    return model, metrics
