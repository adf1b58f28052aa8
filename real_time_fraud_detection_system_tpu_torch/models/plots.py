"""Evaluation plots — port of the JAX package's ``models/plots.py``: the
reference's plotting toolkit, matplotlib-native (imported only inside
:func:`_mpl`, when a plot is drawn).

Re-implements the visualization section of
``fraud_detection_model/shared_functions.py:925-1302``: ROC and
precision-recall curves, per-threshold metric curves, model-comparison bars
with train/predict execution times, and prequential model-selection
summaries. All functions draw on a provided/created Axes and return the
Figure, so they compose into dashboards or save straight to disk
(``save_plots`` writes a one-stop PNG report).

Matplotlib uses the Agg backend when no display is present; nothing here
requires a GUI.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from real_time_fraud_detection_system_tpu_torch.models.metrics import (
    average_precision,
    roc_auc,
    threshold_based_metrics,
)


def _mpl():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg",):
        try:
            matplotlib.use("Agg", force=False)
        except Exception:  # pragma: no cover - interactive sessions
            pass
    import matplotlib.pyplot as plt

    return plt


def roc_points(y_true: np.ndarray, y_score: np.ndarray):
    """(fpr, tpr) at every distinct threshold, descending score order."""
    y = np.asarray(y_true).astype(np.float64)
    s = np.asarray(y_score).astype(np.float64)
    if len(s) == 0:
        # Trivial curve: the plots degrade gracefully on an empty score set
        # (np.r_'s length-1 mask would otherwise IndexError a 0-row array).
        return np.array([0.0, 1.0]), np.array([0.0, 1.0])
    order = np.argsort(-s, kind="mergesort")
    y = y[order]
    tp = np.cumsum(y)
    fp = np.cumsum(1 - y)
    n_pos = max(tp[-1] if len(tp) else 0.0, 1e-12)
    n_neg = max(fp[-1] if len(fp) else 0.0, 1e-12)
    last = np.r_[s[order][1:] != s[order][:-1], True]
    return np.r_[0.0, fp[last] / n_neg], np.r_[0.0, tp[last] / n_pos]


def pr_points(y_true: np.ndarray, y_score: np.ndarray):
    """(recall, precision) curve points, descending score order."""
    y = np.asarray(y_true).astype(np.float64)
    s = np.asarray(y_score).astype(np.float64)
    if len(s) == 0:
        return np.array([0.0, 1.0]), np.array([1.0, 1.0])
    order = np.argsort(-s, kind="mergesort")
    y = y[order]
    tp = np.cumsum(y)
    fp = np.cumsum(1 - y)
    n_pos = max(tp[-1] if len(tp) else 0.0, 1e-12)
    last = np.r_[s[order][1:] != s[order][:-1], True]
    recall = np.r_[0.0, tp[last] / n_pos]
    precision = np.r_[1.0, tp[last] / np.maximum(tp[last] + fp[last], 1e-12)]
    return recall, precision


def plot_roc(y_true, y_score, label: Optional[str] = None, ax=None):
    """ROC curve with AUC in the legend (reference ``plot_roc_curve``)."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    fpr, tpr = roc_points(y_true, y_score)
    auc = roc_auc(y_true, y_score)
    name = label or "model"
    ax.plot(fpr, tpr, label=f"{name} (AUC={auc:.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8, label="chance")
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title("ROC curve")
    ax.legend(loc="lower right")
    return ax.figure


def plot_precision_recall(y_true, y_score, label: Optional[str] = None,
                          ax=None):
    """PR curve with AP in the legend (reference ``plot_precision_recall``)."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    recall, precision = pr_points(y_true, y_score)
    ap = average_precision(y_true, y_score)
    name = label or "model"
    ax.plot(recall, precision, label=f"{name} (AP={ap:.3f})")
    base = float(np.asarray(y_true).mean()) if len(np.asarray(y_true)) else 0
    ax.axhline(base, color="k", ls="--", lw=0.8, label="chance")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_title("Precision-recall curve")
    ax.legend(loc="upper right")
    return ax.figure


def plot_threshold_metrics(
    y_true, y_score,
    metrics: Sequence[str] = ("TPR", "FPR", "precision", "F1", "G-mean"),
    ax=None,
):
    """Metric-vs-threshold curves (reference threshold exploration,
    ``shared_functions.py:538-581`` surfaced as plots)."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    thresholds = np.linspace(0.05, 0.95, 19)
    table = threshold_based_metrics(y_true, y_score, thresholds)
    for m in metrics:
        ax.plot(thresholds, [table[float(t)][m] for t in thresholds],
                marker=".", label=m)
    ax.set_xlabel("Decision threshold")
    ax.set_ylabel("Metric value")
    ax.set_title("Threshold metrics")
    ax.legend()
    return ax.figure


def plot_model_comparison(
    results: Dict[str, Dict[str, float]],
    metrics: Sequence[str] = ("auc_roc", "average_precision",
                              "card_precision@100"),
    ax=None,
):
    """Grouped bars of headline metrics per model (reference
    ``get_performances_plots``)."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(1.8 * max(len(results), 2) + 2, 4))
    names = list(results)
    width = 0.8 / max(len(metrics), 1)
    xs = np.arange(len(names))
    for j, m in enumerate(metrics):
        vals = [results[n].get(m, np.nan) for n in names]
        ax.bar(xs + j * width, vals, width, label=m)
    ax.set_xticks(xs + width * (len(metrics) - 1) / 2)
    ax.set_xticklabels(names)
    ax.set_ylim(0, 1)
    ax.set_title("Model comparison")
    ax.legend()
    return ax.figure


def plot_execution_times(times: Dict[str, Dict[str, float]], ax=None):
    """Fit/predict wall-clock bars per model (reference
    ``execution_times_model_collection``, ``shared_functions.py:499-512``)."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(1.5 * max(len(times), 2) + 2, 4))
    names = list(times)
    xs = np.arange(len(names))
    ax.bar(xs - 0.2, [times[n].get("fit_seconds", 0) for n in names],
           0.4, label="fit")
    ax.bar(xs + 0.2, [times[n].get("predict_seconds", 0) for n in names],
           0.4, label="predict")
    ax.set_xticks(xs)
    ax.set_xticklabels(names, rotation=20, ha="right")
    ax.set_ylabel("seconds")
    ax.set_title("Execution times")
    ax.legend()
    return ax.figure


def plot_prequential_summary(rows: List, metric: str = "auc_roc", ax=None):
    """Candidate mean±std on validation vs test folds (reference
    ``get_summary_performances`` visualization)."""
    from real_time_fraud_detection_system_tpu_torch.models.selection import (
        _mean_std,
        _param_key,
    )

    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    by_params: Dict[str, list] = {}
    for r in rows:
        by_params.setdefault(_param_key(r.params), []).append(r)
    labels, v_means, v_stds, t_means, t_stds = [], [], [], [], []
    for key, prs in sorted(by_params.items()):
        labels.append(", ".join(f"{k}={v}" for k, v in prs[0].params.items())
                      or "default")
        vm, vs = _mean_std([r for r in prs if r.expe_type == "validation"],
                           metric)
        tm, ts = _mean_std([r for r in prs if r.expe_type == "test"], metric)
        v_means.append(vm); v_stds.append(vs)
        t_means.append(tm); t_stds.append(ts)
    xs = np.arange(len(labels))
    ax.errorbar(xs - 0.05, v_means, yerr=v_stds, fmt="o-",
                label="validation", capsize=3)
    ax.errorbar(xs + 0.05, t_means, yerr=t_stds, fmt="s--",
                label="test", capsize=3)
    ax.set_xticks(xs)
    ax.set_xticklabels(labels, rotation=20, ha="right")
    ax.set_ylabel(metric)
    ax.set_title("Prequential model selection")
    ax.legend()
    return ax.figure


def plot_tx_stats(txs, ax=None):
    """Dataset statistics: transactions/day and fraudulent txs/day over
    the generated table (reference ``get_tx_stats`` +
    ``get_template_tx_stats``, ``shared_functions.py:925-988`` — the
    notebook's first look at the simulator output)."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    days = np.asarray(txs.tx_time_days)
    # full calendar range: a day with zero transactions plots as 0, not
    # as an interpolated segment between its neighbors
    n_days = int(days.max()) + 1 if len(days) else 0
    n_tx = np.bincount(days, minlength=n_days)
    n_fraud = np.bincount(days, weights=np.asarray(txs.tx_fraud),
                          minlength=n_days)
    xs_days = np.arange(n_days)
    ax.plot(xs_days, n_tx, label="# transactions")
    ax.plot(xs_days, n_fraud, label="# fraudulent txs")
    ax.set_xlabel("day")
    ax.set_ylabel("count")
    rate = n_fraud.sum() / max(n_tx.sum(), 1)
    ax.set_title(f"Transaction stats (fraud rate {rate:.2%})")
    ax.legend()
    return ax.figure


def plot_decision_boundary(
    predict_proba,
    x: np.ndarray,
    y: np.ndarray,
    feature_idx: Sequence[int] = (0, 1),
    resolution: int = 100,
    ax=None,
):
    """2-feature decision surface of any scorer (reference
    ``plot_decision_boundary_classifier``, ``shared_functions.py:
    1231-1302`` — the notebook's classifier-intuition figure).

    ``predict_proba(features) -> probs`` is called on a grid over the
    two selected features with the remaining features held at their
    column means."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 4))
    i, j = feature_idx
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y)
    xi, xj = x[:, i], x[:, j]
    pad_i = 0.1 * max(float(np.ptp(xi)), 1e-6)
    pad_j = 0.1 * max(float(np.ptp(xj)), 1e-6)
    gi = np.linspace(xi.min() - pad_i, xi.max() + pad_i, resolution)
    gj = np.linspace(xj.min() - pad_j, xj.max() + pad_j, resolution)
    mi, mj = np.meshgrid(gi, gj)
    grid = np.tile(x.mean(axis=0), (resolution * resolution, 1))
    grid[:, i] = mi.ravel()
    grid[:, j] = mj.ravel()
    probs = np.asarray(predict_proba(grid.astype(np.float32)))
    ax.contourf(mi, mj, probs.reshape(resolution, resolution),
                levels=20, cmap="RdBu_r", alpha=0.7, vmin=0, vmax=1)
    ax.scatter(xi[y == 0], xj[y == 0], s=8, c="tab:blue", label="genuine",
               edgecolors="none")
    ax.scatter(xi[y == 1], xj[y == 1], s=12, c="tab:red", label="fraud",
               edgecolors="none")
    ax.set_xlabel(f"feature {i}")
    ax.set_ylabel(f"feature {j}")
    ax.set_title("Decision boundary")
    ax.legend()
    return ax.figure


def save_plots(
    path: str,
    y_true,
    y_score,
    label: str = "model",
) -> str:
    """One-stop PNG report: ROC + PR + threshold metrics side by side."""
    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    plot_roc(y_true, y_score, label, ax=axes[0])
    plot_precision_recall(y_true, y_score, label, ax=axes[1])
    plot_threshold_metrics(y_true, y_score, ax=axes[2])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
