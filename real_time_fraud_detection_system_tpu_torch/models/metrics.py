"""Evaluation metrics — port of the JAX package's ``models/metrics.py``
(NumPy, the same operations in the same order): AUC-ROC with mid-ranks,
Average Precision, Card Precision@k and the threshold matrix, the
reference's metric suite (``shared_functions.py:352-365,376-411,442-460,
538-581``). No sklearn in this path; tests use it as the oracle.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def rebalance_pos_weight(y: np.ndarray) -> float:
    """Soft class-rebalance weight sqrt(neg/pos) shared by all trainers."""
    n_pos = max(float(np.asarray(y).sum()), 1.0)
    n_tot = float(len(np.asarray(y)))
    return float(np.sqrt(max((n_tot - n_pos) / n_pos, 1.0)))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Mann-Whitney U formulation with midrank tie handling."""
    y = np.asarray(y_true).astype(np.float64)
    s = np.asarray(y_score).astype(np.float64)
    n_pos = y.sum()
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = _midranks(s[order])
    r_pos = ranks[y[order] == 1].sum()
    u = r_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def _midranks(sorted_vals: np.ndarray) -> np.ndarray:
    n = len(sorted_vals)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    # average ranks over ties
    _, first, counts = np.unique(sorted_vals, return_index=True, return_counts=True)
    for f, c in zip(first, counts):
        if c > 1:
            ranks[f : f + c] = ranks[f : f + c].mean()
    return ranks


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP = Σ (R_i - R_{i-1}) · P_i over descending-score prefix points,
    matching sklearn.metrics.average_precision_score."""
    y = np.asarray(y_true).astype(np.float64)
    s = np.asarray(y_score).astype(np.float64)
    n_pos = y.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-s, kind="mergesort")
    y = y[order]
    s = s[order]
    tp = np.cumsum(y)
    fp = np.cumsum(1 - y)
    precision = tp / (tp + fp)
    recall = tp / n_pos
    # Collapse tied score groups to their last (cumulative) point.
    last_of_group = np.r_[s[1:] != s[:-1], True]
    precision = precision[last_of_group]
    recall = recall[last_of_group]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def card_precision_top_k(
    y_true: np.ndarray,
    y_score: np.ndarray,
    days: np.ndarray,
    customer_ids: np.ndarray,
    k: int = 100,
) -> float:
    """Mean daily precision of the top-k most suspicious *cards*.

    For each day: aggregate per customer (max score, any-fraud), take the k
    highest-scored customers, precision = compromised fraction. Mean over
    days — the reference's ``card_precision_top_k`` metric
    (``shared_functions.py:352-411``).
    """
    days = np.asarray(days)
    precisions = []
    for d in np.unique(days):
        m = days == d
        cust = np.asarray(customer_ids)[m]
        score = np.asarray(y_score)[m]
        fraud = np.asarray(y_true)[m]
        uniq, inv = np.unique(cust, return_inverse=True)
        agg_score = np.full(len(uniq), -np.inf)
        np.maximum.at(agg_score, inv, score)
        agg_fraud = np.zeros(len(uniq))
        np.maximum.at(agg_fraud, inv, fraud)
        top = np.argsort(-agg_score, kind="mergesort")[:k]
        precisions.append(agg_fraud[top].mean() if len(top) else 0.0)
    return float(np.mean(precisions))


def threshold_based_metrics(
    y_true: np.ndarray,
    y_score: np.ndarray,
    thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
) -> Dict[float, Dict[str, float]]:
    """Per-threshold confusion metrics (reference ``shared_functions.py:538-581``)."""
    y = np.asarray(y_true).astype(bool)
    s = np.asarray(y_score)
    out: Dict[float, Dict[str, float]] = {}
    p = y.sum()
    n = (~y).sum()
    for t in thresholds:
        pred = s >= t
        tp = float((pred & y).sum())
        fp = float((pred & ~y).sum())
        fn = float((~pred & y).sum())
        tn = float((~pred & ~y).sum())
        tpr = tp / p if p else 0.0
        fpr = fp / n if n else 0.0
        tnr = tn / n if n else 0.0
        precision = tp / (tp + fp) if tp + fp else 0.0
        f1 = 2 * precision * tpr / (precision + tpr) if precision + tpr else 0.0
        out[float(t)] = {
            "TPR": tpr,
            "FPR": fpr,
            "TNR": tnr,
            "precision": precision,
            "F1": f1,
            "BER": 0.5 * (fpr + (fn / p if p else 0.0)),
            "G-mean": float(np.sqrt(tpr * tnr)),
            "accuracy": (tp + tn) / len(y) if len(y) else 0.0,
        }
    return out


def performance_assessment(
    y_true: np.ndarray,
    y_score: np.ndarray,
    days: np.ndarray | None = None,
    customer_ids: np.ndarray | None = None,
    top_k: int = 100,
) -> Dict[str, float]:
    """The reference's headline metric triple (``shared_functions.py:442-460``):
    AUC-ROC, Average Precision, Card Precision@k."""
    out = {
        "auc_roc": roc_auc(y_true, y_score),
        "average_precision": average_precision(y_true, y_score),
    }
    if days is not None and customer_ids is not None:
        out[f"card_precision@{top_k}"] = card_precision_top_k(
            y_true, y_score, days, customer_ids, top_k
        )
    return out
