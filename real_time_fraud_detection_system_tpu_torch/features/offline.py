"""Offline feature computation — port of the JAX package's
``features/offline.py``.

- :func:`compute_features_replay` replays the historical stream
  chronologically through the SAME online step that serves
  (:func:`..features.online.update_and_featurize`), on the given device,
  so training sees the serving features exactly: no train/serve skew.
  :func:`warm_start_state` runs the same replay and returns the feature
  state the engine can continue from.
- :func:`pandas_rolling_features` is the reference-semantics oracle: the
  handbook's trailing wall-clock windows with pandas groupby-rolling
  (pandas is imported only when it is called).

Each chunk is built by ``core/batch.py::make_batch`` with the row's fraud
label in-band (risk windows are delay-shifted, so a label that arrives
with its transaction is not visible to queries any earlier than the
delayed feedback of production would be) and padded to ``chunk`` rows, as
the JAX package builds it. On CUDA the features collect on the card and
reach the host in one copy at the end.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.config import FeatureConfig
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    make_batch,
    pack_batch,
    unpack_batch,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    SECONDS_PER_DAY,
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.online import (
    init_feature_state,
    update_and_featurize,
)
from real_time_fraud_detection_system_tpu_torch.features.spec import (
    FEATURE_NAMES,
    N_FEATURES,
)
from real_time_fraud_detection_system_tpu_torch.ops.cms import (
    cms_init,
    cms_update,
)


def _epoch_day0(start_date: str) -> int:
    d = _dt.date.fromisoformat(start_date)
    return (d - _dt.date(1970, 1, 1)).days


def _replay(txs: Transactions, cfg: FeatureConfig, start_date: str,
            chunk: int, with_cms: bool, collect_features: bool, device):
    """The chronological replay both entry points share: returns
    (features [N, 15] numpy or None, final state on ``device``).

    ``with_cms`` carries the customer sketch beside the tables (and keeps
    it updated), as the JAX replay's ``init_feature_state(cfg,
    with_cms)`` does; under ``customer_source="cms"`` the sketch is the
    customer source and ``with_cms`` must be True there too."""
    if not np.all(np.diff(txs.tx_time_seconds) >= 0):
        raise ValueError("txs must be chronological")
    device = resolve_device(device)
    start_epoch_us = _epoch_day0(start_date) * SECONDS_PER_DAY * 1_000_000

    state = init_feature_state(cfg, device)
    if with_cms and state.cms is None:
        state = state._replace(cms=cms_init(cfg.cms_depth, cfg.cms_width,
                                            cfg.n_day_buckets, device))
    elif not with_cms and cfg.key_mode != "exact":
        state = state._replace(cms=None)
    extra_sketch = with_cms and cfg.customer_source != "cms"

    n = txs.n
    out = (torch.zeros((n, N_FEATURES), dtype=torch.float32, device=device)
           if collect_features else None)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        part = txs.slice(slice(s, e))
        packed = pack_batch(make_batch(
            customer_id=part.customer_id,
            terminal_id=part.terminal_id,
            tx_datetime_us=start_epoch_us + part.tx_time_seconds * 1_000_000,
            amount_cents=part.amount_cents,
            label=part.tx_fraud.astype(np.int32),
            pad_to=chunk,
        ))
        batch = unpack_batch(torch.from_numpy(packed).to(device))
        state, feats = update_and_featurize(state, batch, cfg)
        if extra_sketch:
            cms_update(state.cms, batch.customer_key, batch.amount,
                       batch.day, batch.valid)
        if out is not None:
            out[s:e] = feats[: e - s]
    return (out.cpu().numpy() if out is not None else None), state


def compute_features_replay(txs: Transactions, cfg: FeatureConfig,
                            start_date: str = "2025-04-01",
                            chunk: int = 8192, with_cms: bool = False,
                            device=None) -> np.ndarray:
    """Features float32 [N, 15] aligned with ``txs`` rows (chronological
    order), computed by replaying the table through the online step on
    ``device`` (None = CUDA) in chunks of ``chunk`` rows."""
    out, _ = _replay(txs, cfg, start_date, chunk, with_cms,
                     collect_features=True, device=device)
    return out


def warm_start_state(txs: Transactions, cfg: FeatureConfig,
                     start_date: str = "2025-04-01", chunk: int = 8192,
                     with_cms: bool = False, device=None):
    """The online feature state after replaying a historical table: what
    streaming from day 0 would have left (the reference bootstraps
    serving by MERGE-loading precomputed feature tables,
    ``load_initial_data.py:289-487``)."""
    _, state = _replay(txs, cfg, start_date, chunk, with_cms,
                       collect_features=False, device=device)
    return state


def pandas_rolling_features(
    txs: Transactions,
    windows=(1, 7, 30),
    delay_days: int = 7,
    start_date: str = "2025-04-01",
    night_end_hour: int = 6,
    weekend_start_weekday: int = 5,
) -> np.ndarray:
    """Reference-semantics oracle: trailing wall-clock rolling windows,
    float64 [N, 15].

    Customer windows: count + mean amount over trailing ``w`` days
    including the current row. Terminal windows: count + fraud risk over
    [t-delay-w, t-delay] (undefined risk → 0), vectorized with
    groupby-rolling (pandas comes in through ``Transactions.to_pandas``)."""
    df = txs.to_pandas(start_date)
    df = df.sort_values("TX_DATETIME", kind="stable").reset_index(drop=True)
    ts = df["TX_DATETIME"]

    weekday = ts.dt.weekday
    hour = ts.dt.hour
    out = {
        "TX_AMOUNT": df["TX_AMOUNT"].to_numpy(),
        "TX_DURING_WEEKEND": (weekday >= weekend_start_weekday)
        .astype(np.float64).to_numpy(),
        "TX_DURING_NIGHT": (hour <= night_end_hour).astype(np.float64)
        .to_numpy(),
    }

    # Roll over the TX_DATETIME column (``on=``) so the frame keeps its
    # unique RangeIndex; results join back by that index.
    n = len(df)
    gc = df.groupby("CUSTOMER_ID")[["TX_DATETIME", "TX_AMOUNT"]]
    for w in windows:
        r = gc.rolling(f"{w}D", on="TX_DATETIME")
        cnt = _realign(r.count()["TX_AMOUNT"], n)
        s = _realign(r.sum()["TX_AMOUNT"], n)
        out[f"CUSTOMER_ID_NB_TX_{w}DAY_WINDOW"] = cnt
        out[f"CUSTOMER_ID_AVG_AMOUNT_{w}DAY_WINDOW"] = s / cnt

    gt = df.groupby("TERMINAL_ID")[["TX_DATETIME", "TX_FRAUD"]]

    def _roll_ct(days: int):
        r = gt.rolling(f"{days}D", on="TX_DATETIME")
        return (_realign(r.count()["TX_FRAUD"], n),
                _realign(r.sum()["TX_FRAUD"], n))

    nb_delay, fr_delay = _roll_ct(delay_days)
    for w in windows:
        nb_dw, fr_dw = _roll_ct(delay_days + w)
        nb_w = nb_dw - nb_delay
        risk = np.where(nb_w > 0,
                        (fr_dw - fr_delay) / np.maximum(nb_w, 1.0), 0.0)
        out[f"TERMINAL_ID_NB_TX_{w}DAY_WINDOW"] = nb_w
        out[f"TERMINAL_ID_RISK_{w}DAY_WINDOW"] = risk

    return np.stack([np.asarray(out[name], dtype=np.float64)
                     for name in FEATURE_NAMES], axis=1)


def _realign(series, n: int) -> np.ndarray:
    """Groupby-rolling result → chronological row order, by index join:
    dropping the group level leaves the frame's unique RangeIndex."""
    flat = series.reset_index(level=0, drop=True)
    return flat.reindex(np.arange(n)).to_numpy(dtype=np.float64)
