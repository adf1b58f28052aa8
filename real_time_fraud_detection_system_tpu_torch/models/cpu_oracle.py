"""CPU parity oracle — port of the JAX package's ``models/cpu_oracle.py``:
the reference's exact serving pipeline, kept as truth.

Mirrors ``fraud_detection.py:183-195``: sklearn ``StandardScaler.transform``
followed by ``predict_proba(...)[:, 1]`` of a sklearn classifier, fitted
and scored on the host (sklearn is imported only when
:func:`fit_cpu_scorer` runs). Parity tests hold the device path against
it (probability-level for logreg/forest, AUC-level for the approximated
features).
"""

from __future__ import annotations

import numpy as np


class CpuScorer:
    def __init__(self, scaler, model):
        self.scaler = scaler  # sklearn StandardScaler
        self.model = model  # sklearn classifier with predict_proba

    def predict_proba(self, features: np.ndarray) -> np.ndarray:
        scaled = self.scaler.transform(features)
        return self.model.predict_proba(scaled)[:, 1]


def fit_cpu_scorer(
    features: np.ndarray,
    labels: np.ndarray,
    kind: str = "forest",
    n_trees: int = 100,
    max_depth: int | None = 8,
    seed: int = 0,
) -> CpuScorer:
    """Train the reference-style sklearn pipeline on host."""
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.linear_model import LogisticRegression
    from sklearn.preprocessing import StandardScaler
    from sklearn.tree import DecisionTreeClassifier

    scaler = StandardScaler().fit(features)
    scaled = scaler.transform(features)
    if kind == "logreg":
        model = LogisticRegression(max_iter=1000, random_state=seed)
    elif kind == "tree":
        model = DecisionTreeClassifier(max_depth=2, random_state=seed)
    else:
        model = RandomForestClassifier(
            n_estimators=n_trees, max_depth=max_depth, random_state=seed, n_jobs=-1
        )
    model.fit(scaled, labels)
    # Serial predict: with n_jobs=-1 sklearn's forest predict_proba
    # accumulates per-tree probabilities from parallel workers in
    # nondeterministic order, so two calls on the SAME model differ by
    # ~1 ULP on ~20% of rows (measured: 111/600 at 20 trees on 2 cores).
    # A parity ORACLE must be bit-stable call-to-call; fitting above
    # keeps the parallel speedup, prediction pins the summation order.
    if hasattr(model, "n_jobs"):
        model.n_jobs = 1
    return CpuScorer(scaler, model)
