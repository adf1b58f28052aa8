"""Online feature computation: update device state, emit the 15 features.

Port of the JAX package's ``features/online.py`` for the serving path's
configuration: ``key_mode="direct"`` with ``customer_source="table"``.
One call per micro-batch scatters the batch into the rolling-window state,
then reads the feature vector of every row from it (update-then-query: a
row's windows include itself and its batch-mates of the same key and day).
The fused steps hand the tables and slots to their kernels, which read the
rows by slot; the unfused step gathers the rows first.

Terminal fraud labels arrive late; the risk windows are delay-shifted, so
current-batch labels never reach the queried window.

The JAX step donates the state and XLA updates it in place; here the
state tensors are updated in place and the same ``FeatureState`` is
returned.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from real_time_fraud_detection_system_tpu_torch.config import FeatureConfig
from real_time_fraud_detection_system_tpu_torch.core.batch import TxBatch
from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
    flags,
    gather_feature_rows,
    ratio,
    stack_features,
)
from real_time_fraud_detection_system_tpu_torch.ops.forest_kernels import (
    ForestTables,
    fused_forest_leaf_sum,
)
from real_time_fraud_detection_system_tpu_torch.ops.score_kernels import (
    fused_featurize_score,
)
from real_time_fraud_detection_system_tpu_torch.ops.windows import (
    WindowState,
    init_window_state,
    update_windows,
    window_sums,
)

_NOT_PORTED = {
    "hash": "key_mode='hash' is not ported yet (ROADMAP A1, hash key mode)",
    "exact": "key_mode='exact' is not ported yet (ROADMAP A5, tiered "
             "feature store)",
    "cms": "customer_source='cms' is not ported yet (ROADMAP A5, "
           "count-min sketch)",
}


def _require_ported(cfg: FeatureConfig) -> None:
    if cfg.key_mode != "direct":
        raise NotImplementedError(_NOT_PORTED[cfg.key_mode])
    if cfg.customer_source != "table":
        raise NotImplementedError(_NOT_PORTED["cms"])


class FeatureState(NamedTuple):
    """All device-resident feature state. ``cms`` is always None here:
    the count-min sketch belongs to modes not ported yet."""

    customer: WindowState
    terminal: WindowState
    cms: Optional[object] = None


def init_feature_state(cfg: FeatureConfig, device) -> FeatureState:
    _require_ported(cfg)
    return FeatureState(
        customer=init_window_state(cfg.customer_capacity, cfg.n_day_buckets,
                                   device),
        terminal=init_window_state(cfg.terminal_capacity, cfg.n_day_buckets,
                                   device),
        cms=None,
    )


def _slot(key: torch.Tensor, capacity: int, mode: str) -> torch.Tensor:
    """uint32 key → int64 table slot. 'direct' is exact for dense serial
    ids (< capacity): ``key & (capacity-1)``, taken on the int32 view
    (torch has no ``&`` on uint32 tensors; the low bits are the same)."""
    if mode != "direct":
        raise NotImplementedError(_NOT_PORTED.get(mode, mode))
    return (key.view(torch.int32) & (capacity - 1)).long()


def state_bytes(cfg: FeatureConfig) -> dict:
    """Static device accounting of the feature state
    :func:`init_feature_state` builds: window tables hold bucket_day i32 +
    count/amount/fraud f32 = 16 B per bucket."""
    _require_ported(cfg)
    dense = (cfg.customer_capacity + cfg.terminal_capacity) \
        * cfg.n_day_buckets * 16
    return {"dense": int(dense), "directory": 0, "cms": 0,
            "total": int(dense)}


def _flags(batch: TxBatch, cfg: FeatureConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_weekend, is_night) float32 flags from (day, tod_s)."""
    return flags(batch.day, batch.tod_s, cfg.weekend_start_weekday,
                 cfg.night_end_hour)


def _update_state(
    state: FeatureState, batch: TxBatch, cfg: FeatureConfig
) -> Tuple[FeatureState, torch.Tensor, torch.Tensor]:
    """Scatter-update half of both scoring paths, in place.

    Returns (state, cust_slot, term_slot). Labeled rows
    (``batch.label >= 0``) also scatter fraud counts into the terminal
    state; unlabeled rows contribute 0. The customer table skips its
    fraud column and the terminal table its amount column: no feature
    reads them.
    """
    _require_ported(cfg)
    cust_slot = _slot(batch.customer_key, cfg.customer_capacity, cfg.key_mode)
    term_slot = _slot(batch.terminal_key, cfg.terminal_capacity, cfg.key_mode)
    fraud = torch.clamp(batch.label, min=0).to(torch.float32)
    update_windows(state.customer, cust_slot, batch.day, batch.amount, fraud,
                   batch.valid, track_fraud=False)
    update_windows(state.terminal, term_slot, batch.day, batch.amount, fraud,
                   batch.valid, track_amount=False)
    return state, cust_slot, term_slot


def update_and_featurize(
    state: FeatureState,
    batch: TxBatch,
    cfg: FeatureConfig,
) -> Tuple[FeatureState, torch.Tensor]:
    """Returns (state, features [B, 15]); the state is updated in place."""
    windows = tuple(cfg.windows)
    state, cust_slot, term_slot = _update_state(state, batch, cfg)
    (c_bd, c_cnt, c_amt), (t_bd, t_cnt, t_frd) = gather_feature_rows(
        state.customer, state.terminal, cust_slot, term_slot)
    c_count, c_amount = window_sums(c_bd, (c_cnt, c_amt), batch.day, windows)
    t_count, t_fraud = window_sums(t_bd, (t_cnt, t_frd), batch.day, windows,
                                   cfg.delay_days)
    is_weekend, is_night = _flags(batch, cfg)
    features = _assemble(batch, cfg, c_count, ratio(c_amount, c_count),
                         t_count, ratio(t_fraud, t_count), is_weekend,
                         is_night)
    return state, features


def _assemble(batch, cfg, c_count, c_avg, t_count, t_risk,
              is_weekend, is_night) -> torch.Tensor:
    """Feature columns → [B, 15] in ``features/spec.py`` order."""
    return stack_features(batch.amount, is_weekend, is_night, c_count, c_avg,
                          t_count, t_risk)


def update_and_score_fused_forest(
    state: FeatureState,
    batch: TxBatch,
    cfg: FeatureConfig,
    scaler_mean: torch.Tensor,
    scaler_scale: torch.Tensor,
    tables: ForestTables,
) -> Tuple[FeatureState, torch.Tensor, torch.Tensor]:
    """Scatter-update the state (in place), then run the fused
    featurize→forest step (``ops/forest_kernels.py::fused_forest_leaf_sum``)
    on both tables and the batch's slots: its kernel reads the updated
    rows by slot.

    Counterpart of the JAX ``update_and_score_pallas_forest``: returns
    (state, leaf_sum [B], features [B, 15]); the caller divides by
    ``tables.n_trees`` and masks invalid rows.
    """
    state, cust_slot, term_slot = _update_state(state, batch, cfg)
    leaf_sum, feats = fused_forest_leaf_sum(
        tables, state.customer, state.terminal, cust_slot, term_slot,
        batch.day, batch.tod_s, batch.amount, scaler_mean, scaler_scale,
        windows=tuple(cfg.windows),
        delay=cfg.delay_days,
        weekend_start=cfg.weekend_start_weekday,
        night_end=cfg.night_end_hour,
    )
    return state, leaf_sum, feats


def update_and_score_fused_logreg(
    state: FeatureState,
    batch: TxBatch,
    cfg: FeatureConfig,
    scaler_mean: torch.Tensor,
    scaler_scale: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
) -> Tuple[FeatureState, torch.Tensor, torch.Tensor]:
    """Scatter-update the state (in place), then run the fused
    featurize→logreg step (``ops/score_kernels.py::fused_featurize_score``)
    on both tables and the batch's slots: its kernel reads the updated
    rows by slot.

    Counterpart of the JAX ``update_and_score_pallas``: returns (state,
    probs [B], features [B, 15]); padded rows score 0.
    """
    state, cust_slot, term_slot = _update_state(state, batch, cfg)
    probs, feats = fused_featurize_score(
        state.customer, state.terminal, cust_slot, term_slot, batch.day,
        batch.tod_s, batch.amount, batch.valid, scaler_mean, scaler_scale,
        w, b,
        windows=tuple(cfg.windows),
        delay=cfg.delay_days,
        weekend_start=cfg.weekend_start_weekday,
        night_end=cfg.night_end_hour,
    )
    return state, probs, feats
