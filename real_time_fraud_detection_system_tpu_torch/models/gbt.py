"""Gradient-boosted trees — port of the JAX package's ``models/gbt.py``
(inference only).

A boosted ensemble is the forest's node tables with raw leaf scores in
``prob`` (learning rate applied) and an initial logit: the probability is
``sigmoid(base_score + Σ_t leaf score)``. The trainer and the xgboost
import come with the offline side (ROADMAP A8b).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    GemmEnsemble,
    TreeEnsemble,
    ensemble_leaf_values,
    for_device,
    gemm_leaf_sum,
    synthetic_ensemble,
)


class GBTModel(NamedTuple):
    # prob/leaf_val field holds raw leaf scores (lr pre-applied)
    trees: "TreeEnsemble | GemmEnsemble"
    base_score: torch.Tensor  # float32 [] — initial logit

    def to(self, device) -> "GBTModel":
        return GBTModel(self.trees.to(device), self.base_score.to(device))


def gbt_predict_proba(model: GBTModel, x: torch.Tensor,
                      z_mode: Optional[str] = None) -> torch.Tensor:
    if isinstance(model.trees, GemmEnsemble):
        raw = gemm_leaf_sum(model.trees, x, z_mode)
    else:
        raw = torch.sum(ensemble_leaf_values(model.trees, x), dim=1)
    return torch.sigmoid(model.base_score + raw)


def gbt_for_device(model: GBTModel, n_features: int) -> GBTModel:
    """GEMM-form trees where their depth allows it (see ``for_device``)."""
    if isinstance(model.trees, TreeEnsemble):
        return model._replace(trees=for_device(model.trees, n_features))
    return model


def synthetic_gbt(n_trees: int = 4, max_depth: int = 3,
                  n_features: int = 15, seed: int = 0,
                  device=None) -> GBTModel:
    """Shape-faithful GBT with no training dependency: the trees of
    ``synthetic_ensemble`` (the same seed gives the JAX package's tables)
    and a base logit of -2. The leaf scores are arbitrary: do not score
    real traffic with it."""
    device = resolve_device(device)
    return GBTModel(
        trees=synthetic_ensemble(n_trees, max_depth, n_features, seed,
                                 device=device),
        base_score=torch.tensor(-2.0, dtype=torch.float32, device=device),
    )
