"""Logistic-regression scorer — port of the JAX package's
``models/logreg.py`` (inference only).

The logit adds the 15 products in feature order, one after another: the
order the fused logreg kernel (``csrc/fused_score.cu``) uses, so the plain
path and the kernel agree bit for bit before the sigmoid. Training, the
loss and the online SGD step come with the learning loop (ROADMAP A6,
A8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LogRegParams(NamedTuple):
    w: torch.Tensor  # float32 [F]
    b: torch.Tensor  # float32 []

    def to(self, device) -> "LogRegParams":
        return LogRegParams(self.w.to(device), self.b.to(device))


def logreg_logits(params: LogRegParams, x: torch.Tensor) -> torch.Tensor:
    """[B, F] → ``Σ_f x_f·w_f + b`` [B], the products added in order."""
    acc = torch.zeros_like(x[:, 0])
    for f in range(x.shape[1]):
        acc = acc + x[:, f] * params.w[f]
    return acc + params.b


def logreg_predict_proba(params: LogRegParams,
                         x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(logreg_logits(params, x))
