"""Dashboard queries over the analyzed-transactions output — the port's
own copy of the JAX package's ``io/query.py`` (NumPy only).

The reference serves its results through Trino SQL over the Iceberg
``nessie.payment.analyzed_transactions`` table into a Superset dashboard
(``trino-config/catalog/nessie.properties:1-14``,
``superset/entrypoint.sh:19``). This module is the in-process equivalent for
deployments without that stack: the canned aggregations a fraud-ops
dashboard is built from, computed columnar over the ParquetSink output (or
any analyzed column dict). Trino/Superset still work unchanged on the
Parquet files for full-SQL deployments.

All functions take the analyzed column dict produced by
``io.sink._result_to_columns`` (keys: ``tx_id``, ``tx_datetime_us``,
``customer_id``, ``terminal_id``, ``tx_amount``, 15 feature columns,
``prediction``, ``processed_at_us``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

_US_PER_HOUR = 3_600_000_000
_US_PER_DAY = 24 * _US_PER_HOUR


def load_analyzed(directory: str) -> Dict[str, np.ndarray]:
    """Read every parquet part file of an analyzed output directory.

    Latest-wins by ``tx_id`` across parts (file order): a transaction
    re-scored by a replay/restart counts once — MERGE-on-read, the same
    contract as the raw-transactions table."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from real_time_fraud_detection_system_tpu_torch.io.sqlquery import (
        parquet_files,
    )

    files = parquet_files(directory)
    if not files:
        return {}
    table = pa.concat_tables([pq.read_table(f) for f in files])
    cols = {c: table[c].to_numpy() for c in table.column_names}
    ids = cols.get("tx_id")
    if ids is not None and len(ids):
        from real_time_fraud_detection_system_tpu_torch.ops.dedup import (
            latest_wins_mask_np,
        )

        keep = latest_wins_mask_np(ids, np.arange(len(ids)))
        if not keep.all():
            cols = {c: v[keep] for c, v in cols.items()}
    return cols


def summary_stats(cols: Dict[str, np.ndarray],
                  threshold: float = 0.5) -> dict:
    """Headline tiles: volumes, amounts, flag rate, score distribution."""
    n = len(cols.get("tx_id", ()))
    if n == 0:
        return {"transactions": 0}
    pred = cols["prediction"]
    amount = cols["tx_amount"]
    flagged = pred >= threshold
    return {
        "transactions": int(n),
        "customers": int(len(np.unique(cols["customer_id"]))),
        "terminals": int(len(np.unique(cols["terminal_id"]))),
        "total_amount": float(amount.sum()),
        "flagged": int(flagged.sum()),
        "flagged_rate": float(flagged.mean()),
        "flagged_amount": float(amount[flagged].sum()),
        "score_mean": float(pred.mean()),
        "score_p50": float(np.percentile(pred, 50)),
        "score_p99": float(np.percentile(pred, 99)),
        "threshold": float(threshold),
    }


def fraud_rate_over_time(
    cols: Dict[str, np.ndarray],
    bucket: str = "hour",
    threshold: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Time series of volume / flags / mean score per hour or day bucket."""
    div = _US_PER_HOUR if bucket == "hour" else _US_PER_DAY
    if bucket not in ("hour", "day"):
        raise ValueError("bucket must be 'hour' or 'day'")
    t = cols["tx_datetime_us"] // div
    pred = cols["prediction"]
    uniq, inv = np.unique(t, return_inverse=True)
    count = np.bincount(inv, minlength=len(uniq))
    flags = np.bincount(inv, weights=(pred >= threshold), minlength=len(uniq))
    score_sum = np.bincount(inv, weights=pred, minlength=len(uniq))
    amount = np.bincount(inv, weights=cols["tx_amount"], minlength=len(uniq))
    return {
        "bucket_start_us": uniq * div,
        "transactions": count.astype(np.int64),
        "flagged": flags.astype(np.int64),
        "flag_rate": flags / np.maximum(count, 1),
        "mean_score": score_sum / np.maximum(count, 1),
        "amount": amount,
    }


def _top_by_key(
    cols: Dict[str, np.ndarray],
    key_col: str,
    k: int,
    threshold: float,
    min_transactions: int,
) -> Dict[str, np.ndarray]:
    keys = cols[key_col]
    pred = cols["prediction"]
    uniq, inv = np.unique(keys, return_inverse=True)
    count = np.bincount(inv, minlength=len(uniq))
    score_sum = np.bincount(inv, weights=pred, minlength=len(uniq))
    flags = np.bincount(inv, weights=(pred >= threshold), minlength=len(uniq))
    amount = np.bincount(inv, weights=cols["tx_amount"], minlength=len(uniq))
    mean_score = score_sum / np.maximum(count, 1)
    eligible = count >= min_transactions
    rank_score = np.where(eligible, mean_score, -np.inf)
    top = np.argsort(-rank_score, kind="mergesort")[:k]
    top = top[np.isfinite(rank_score[top])]
    return {
        key_col: uniq[top],
        "transactions": count[top].astype(np.int64),
        "mean_score": mean_score[top],
        "flagged": flags[top].astype(np.int64),
        "amount": amount[top],
    }


def top_risky_terminals(
    cols: Dict[str, np.ndarray],
    k: int = 10,
    threshold: float = 0.5,
    min_transactions: int = 3,
) -> Dict[str, np.ndarray]:
    """Terminals ranked by mean fraud score (the compromised-terminal view —
    scenario 2's detection surface, ``data_generator.ipynb · cell 42``)."""
    return _top_by_key(cols, "terminal_id", k, threshold, min_transactions)


def top_risky_customers(
    cols: Dict[str, np.ndarray],
    k: int = 10,
    threshold: float = 0.5,
    min_transactions: int = 3,
) -> Dict[str, np.ndarray]:
    """Customers ranked by mean fraud score (scenario-3 view; the per-card
    ranking that Card Precision@k assesses)."""
    return _top_by_key(cols, "customer_id", k, threshold, min_transactions)


def recent_alerts(
    cols: Dict[str, np.ndarray],
    threshold: float = 0.5,
    limit: int = 100,
) -> Dict[str, np.ndarray]:
    """Most recent flagged transactions — the ops work queue."""
    pred = cols["prediction"]
    idx = np.flatnonzero(pred >= threshold)
    order = np.argsort(-cols["tx_datetime_us"][idx], kind="mergesort")[:limit]
    pick = idx[order]
    keep = ("tx_id", "tx_datetime_us", "customer_id", "terminal_id",
            "tx_amount", "prediction")
    return {c: cols[c][pick] for c in keep if c in cols}


def raw_transactions_report(directory: str) -> dict:
    """Per-day counts/volume over the persistent raw-transactions table
    (the reference's queryable day-partitioned ``nessie.payment.
    transactions``, ``load_initial_data.py:231``). Reads the Hive-layout
    partitions written by :class:`~.tables.RawTransactionsTable`."""
    from real_time_fraud_detection_system_tpu_torch.io.tables import (
        RawTransactionsTable,
    )

    import os

    if not os.path.isdir(directory):
        raise FileNotFoundError(
            f"raw-transactions table directory not found: {directory!r} "
            "(expected the day-partitioned tx_date=*/ layout written by "
            "the engine's --raw-table / demo output)"
        )
    cols = RawTransactionsTable(directory).read_all()
    if not cols:
        return {"transactions": 0, "days": []}
    us_per_day = 86400 * 1_000_000
    days = cols["tx_datetime_us"] // us_per_day
    uniq, inv = np.unique(days, return_inverse=True)
    counts = np.bincount(inv)
    amounts = np.bincount(inv, weights=cols["tx_amount_cents"]) / 100.0
    return {
        "transactions": int(len(cols["tx_id"])),
        "customers": int(len(np.unique(cols["customer_id"]))),
        "terminals": int(len(np.unique(cols["terminal_id"]))),
        "total_amount": round(float(cols["tx_amount_cents"].sum()) / 100.0,
                              2),
        "days": [
            {"day": RawTransactionsTable.day_str(int(d)),
             "transactions": int(c), "amount": round(float(a), 2)}
            for d, c, a in zip(uniq, counts, amounts)
        ],
    }


def _psi(ref: np.ndarray, cur: np.ndarray, n_bins: int = 10) -> float:
    """Population stability index between two samples of one variable.

    Bins are the reference deciles; probabilities are floored at 1e-4 so
    empty bins contribute a large-but-finite term. Common reading:
    < 0.1 stable, 0.1–0.25 drifting, > 0.25 shifted.
    """
    if len(ref) == 0 or len(cur) == 0:
        return 0.0
    edges = np.quantile(ref, np.linspace(0, 1, n_bins + 1)[1:-1])
    edges = np.unique(edges)
    if len(edges) < n_bins // 2:
        # Heavily tied reference (common for fraud scores clustered near
        # 0): duplicate decile edges collapse into one bin and PSI reads
        # ~0 regardless of the shift. Fall back to fixed-width bins over
        # the pooled range so movement within the tied region registers.
        lo = min(float(ref.min()), float(cur.min()))
        hi = max(float(ref.max()), float(cur.max()))
        if hi <= lo:
            return 0.0
        edges = np.linspace(lo, hi, n_bins + 1)[1:-1]
    nb = len(edges) + 1
    p_ref = np.bincount(np.searchsorted(edges, ref), minlength=nb)
    p_cur = np.bincount(np.searchsorted(edges, cur), minlength=nb)
    p_ref = np.maximum(p_ref / len(ref), 1e-4)
    p_cur = np.maximum(p_cur / len(cur), 1e-4)
    return float(((p_cur - p_ref) * np.log(p_cur / p_ref)).sum())


def drift_report(
    cols: Dict[str, np.ndarray],
    split_us: Optional[int] = None,
    threshold: float = 0.5,
) -> dict:
    """Score/volume drift between a reference window and the current one.

    The serving-side health check the reference's stack has no analogue
    for: compares the analyzed output BEFORE ``split_us`` (default: the
    time-midpoint) against AFTER it — PSI of the prediction
    distribution, amount distribution, and the flag-rate/volume deltas.
    A shifted score distribution (PSI > 0.25) is the canonical retrain
    trigger."""
    n = len(cols.get("tx_id", ()))
    if n == 0:
        return {"transactions": 0}
    t = cols["tx_datetime_us"]
    if split_us is None:
        split_us = int((int(t.min()) + int(t.max())) // 2)
    before = t < split_us
    after = ~before
    pred, amount = cols["prediction"], cols["tx_amount"]
    out = {
        "split_us": int(split_us),
        "reference_rows": int(before.sum()),
        "current_rows": int(after.sum()),
        "threshold": float(threshold),
    }
    if not (before.any() and after.any()):
        # one window is empty (e.g. all rows share a timestamp): there is
        # no comparison — say so, never a confident "stable"
        out["valid"] = False
        out["drifting"] = None
        return out
    out["valid"] = True
    out["prediction_psi"] = round(_psi(pred[before], pred[after]), 4)
    out["amount_psi"] = round(_psi(amount[before], amount[after]), 4)
    out["mean_score_delta"] = round(
        float(pred[after].mean() - pred[before].mean()), 4)
    out["flag_rate_before"] = round(
        float((pred[before] >= threshold).mean()), 4)
    out["flag_rate_after"] = round(
        float((pred[after] >= threshold).mean()), 4)
    out["drifting"] = bool(out["prediction_psi"] > 0.25)
    return out


def report(
    cols: Dict[str, np.ndarray],
    kind: str = "summary",
    threshold: float = 0.5,
    k: int = 10,
    bucket: str = "day",
) -> dict:
    """Dispatch a named dashboard report; arrays JSON-ready (lists)."""
    if kind == "summary":
        return summary_stats(cols, threshold)
    if kind == "drift":
        return drift_report(cols, threshold=threshold)
    if kind not in ("timeseries", "terminals", "customers", "alerts"):
        raise ValueError(f"unknown report kind {kind}")
    if not cols or len(cols.get("tx_id", ())) == 0:
        return {}
    if kind == "timeseries":
        out = fraud_rate_over_time(cols, bucket, threshold)
    elif kind == "terminals":
        out = top_risky_terminals(cols, k, threshold)
    elif kind == "customers":
        out = top_risky_customers(cols, k, threshold)
    else:
        out = recent_alerts(cols, threshold, k)
    return {key: v.tolist() for key, v in out.items()}
