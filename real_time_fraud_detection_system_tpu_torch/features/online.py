"""Online feature computation: update device state, emit the 15 features.

Port of the JAX package's ``features/online.py`` for ``key_mode="direct"``
and ``"hash"``, with ``customer_source="table"`` or ``"cms"`` (the
count-min sketch of ``ops/cms.py`` in place of the customer table);
``key_mode="exact"`` waits for the tiered store (ROADMAP A5).
One call per micro-batch scatters the batch into the rolling-window state,
then reads the feature vector of every row from it (update-then-query: a
row's windows include itself and its batch-mates of the same key and day).
The fused steps hand the tables and slots to their kernels, which read the
rows by slot; the unfused step gathers the rows first (and, under
``customer_source="cms"``, reads the customer windows from the sketch).

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
from real_time_fraud_detection_system_tpu_torch.ops.cms import (
    CountMinSketch,
    cms_init,
    cms_query,
    cms_update,
)
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
from real_time_fraud_detection_system_tpu_torch.ops.hashing import slot_of
from real_time_fraud_detection_system_tpu_torch.ops.score_kernels import (
    fused_featurize_score,
)
from real_time_fraud_detection_system_tpu_torch.ops.windows import (
    WindowState,
    init_window_state,
    update_windows,
    window_sums,
)


def _require_ported(cfg: FeatureConfig) -> None:
    if cfg.key_mode == "exact":
        raise NotImplementedError(
            "key_mode='exact' is not ported yet (ROADMAP A5, tiered "
            "feature store)")


class FeatureState(NamedTuple):
    """All device-resident feature state. ``cms`` is the customer sketch
    under ``customer_source="cms"`` (the customer table is then allocated
    but never read or written, as in the JAX package), else None."""

    customer: WindowState
    terminal: WindowState
    cms: Optional[CountMinSketch] = None


def init_feature_state(cfg: FeatureConfig, device) -> FeatureState:
    _require_ported(cfg)
    return FeatureState(
        customer=init_window_state(cfg.customer_capacity, cfg.n_day_buckets,
                                   device),
        terminal=init_window_state(cfg.terminal_capacity, cfg.n_day_buckets,
                                   device),
        cms=cms_init(cfg.cms_depth, cfg.cms_width, cfg.n_day_buckets, device)
        if cfg.customer_source == "cms" else None,
    )


def _slot(key: torch.Tensor, capacity: int, mode: str) -> torch.Tensor:
    """uint32 key → int64 table slot. 'direct' is exact for dense serial
    ids (< capacity): ``key & (capacity-1)``, taken on the int32 view
    (torch has no ``&`` on uint32 tensors; the low bits are the same).
    'hash' mixes the key first (``ops/hashing.py::slot_of``): bounded
    memory for sparse key universes, colliding keys share a slot."""
    if mode == "direct":
        return (key.view(torch.int32) & (capacity - 1)).long()
    if mode == "hash":
        return slot_of(key, capacity)
    raise ValueError(
        f"key_mode={mode!r} has no static slot map (key_mode='exact' "
        f"routes through the key directory, ROADMAP A5)")


def state_bytes(cfg: FeatureConfig) -> dict:
    """Static device accounting of the feature state
    :func:`init_feature_state` builds: window tables hold bucket_day i32 +
    count/amount/fraud f32 = 16 B per bucket; the sketch a slice_day i32
    per day and two f32 tables of depth × width per day."""
    _require_ported(cfg)
    nb = cfg.n_day_buckets
    dense = (cfg.customer_capacity + cfg.terminal_capacity) * nb * 16
    cms = 0
    if cfg.customer_source == "cms":
        cms = nb * 4 + 2 * nb * cfg.cms_depth * cfg.cms_width * 4
    return {"dense": int(dense), "directory": 0, "cms": int(cms),
            "total": int(dense + cms)}


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
    reads them. Under ``customer_source="cms"`` the customer rows go into
    the sketch instead of the customer table.
    """
    _require_ported(cfg)
    cust_slot = _slot(batch.customer_key, cfg.customer_capacity, cfg.key_mode)
    term_slot = _slot(batch.terminal_key, cfg.terminal_capacity, cfg.key_mode)
    fraud = torch.clamp(batch.label, min=0).to(torch.float32)
    if cfg.customer_source == "cms":
        _require_sketch(state)
        cms_update(state.cms, batch.customer_key, batch.amount, batch.day,
                   batch.valid)
    else:
        update_windows(state.customer, cust_slot, batch.day, batch.amount,
                       fraud, batch.valid, track_fraud=False)
    update_windows(state.terminal, term_slot, batch.day, batch.amount, fraud,
                   batch.valid, track_amount=False)
    return state, cust_slot, term_slot


def _require_table_source(cfg: FeatureConfig) -> None:
    """The fused kernels read the customer table; under
    ``customer_source="cms"`` the engine serves the unfused step."""
    if cfg.customer_source != "table":
        raise ValueError(
            "the fused steps read the customer table; customer_source="
            f"{cfg.customer_source!r} serves through update_and_featurize")


def _require_sketch(state: FeatureState) -> None:
    if state.cms is None:
        raise ValueError(
            "customer_source='cms' but the feature state has no sketch "
            "(init_feature_state must be built from the same config)")


def update_and_featurize(
    state: FeatureState,
    batch: TxBatch,
    cfg: FeatureConfig,
) -> Tuple[FeatureState, torch.Tensor]:
    """Returns (state, features [B, 15]); the state is updated in place."""
    windows = tuple(cfg.windows)
    state, cust_slot, term_slot = _update_state(state, batch, cfg)
    if cfg.customer_source == "cms":
        c_count, c_amount = cms_query(state.cms, batch.customer_key,
                                      batch.day, windows)
        t = state.terminal
        t_bd, t_cnt, t_frd = (t.bucket_day[term_slot], t.count[term_slot],
                              t.fraud[term_slot])
    else:
        (c_bd, c_cnt, c_amt), (t_bd, t_cnt, t_frd) = gather_feature_rows(
            state.customer, state.terminal, cust_slot, term_slot)
        c_count, c_amount = window_sums(c_bd, (c_cnt, c_amt), batch.day,
                                        windows)
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
    _require_table_source(cfg)
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
    _require_table_source(cfg)
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
