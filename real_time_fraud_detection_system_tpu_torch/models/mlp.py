"""MLP classifier — port of the JAX package's ``models/mlp.py``: a plain
list of ``(w, b)`` layers (the JAX pytree form), ReLU between them, one
logit out.

The loss is the JAX package's weighted BCE-with-logits in optax's form
(``models/logreg.py::weighted_bce``), with ``pos_weight`` and ``valid``;
its gradient comes from ``torch.autograd`` (``models/logreg.py::
loss_grad``). Offline training (:func:`train_mlp`) is minibatch Adam
(``models/optim.py``) on the same loss.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    weighted_bce,
)
from real_time_fraud_detection_system_tpu_torch.models.optim import (
    Adam,
    epoch_batches,
)

MLPParams = List[Tuple[torch.Tensor, torch.Tensor]]


def init_mlp(n_features: int, hidden: Sequence[int] = (64, 32),
             seed: int = 0, device=None) -> MLPParams:
    """He-normal weights and zero biases from an explicit
    ``torch.Generator`` seeded with ``seed`` (not ``jax.random``'s
    stream: weights cross between the packages through artifacts)."""
    gen = torch.Generator().manual_seed(seed)
    dims = [n_features, *hidden, 1]
    params: MLPParams = []
    for i in range(len(dims) - 1):
        scale = float(np.sqrt(2.0 / dims[i]))
        w = torch.randn((dims[i], dims[i + 1]), generator=gen) * scale
        params.append((w.to(device), torch.zeros(dims[i + 1], device=device)))
    return params


def mlp_logits(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in params[:-1]:
        h = torch.relu(h @ w + b)
    w, b = params[-1]
    return (h @ w + b)[..., 0]


def mlp_predict_proba(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(mlp_logits(params, x))


def mlp_loss(params: MLPParams, x: torch.Tensor, y: torch.Tensor,
             valid: Optional[torch.Tensor] = None,
             pos_weight: float = 1.0) -> torch.Tensor:
    """Weighted BCE-with-logits; padded rows (``valid`` False) masked out."""
    return weighted_bce(mlp_logits(params, x), y, valid, pos_weight)


def train_mlp(x: np.ndarray, y: np.ndarray, hidden: Sequence[int] = (64, 32),
              learning_rate: float = 1e-3, batch_size: int = 4096,
              epochs: int = 5, pos_weight: float = 1.0, seed: int = 0,
              device=None) -> MLPParams:
    """Offline minibatch-Adam training on (already scaled) features, on
    ``device`` (None = CUDA)."""
    device = resolve_device(device)
    n, f = x.shape
    opt = Adam(init_mlp(f, hidden, seed, device), learning_rate)
    xj = torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    yj = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)

    def loss(p, xb, yb):
        return mlp_loss(p, xb, yb, None, pos_weight)

    for idx in epoch_batches(n, batch_size, epochs, seed, device):
        opt.step(loss, xj[idx], yj[idx])
    return opt.params
