"""Logistic-regression scorer — port of the JAX package's
``models/logreg.py``: the predict, the loss and the online SGD step.

The logit adds the 15 products in feature order, one after another: the
order the fused logreg kernel (``csrc/fused_score.cu``) uses, so the plain
path and the kernel agree bit for bit before the sigmoid. The loss is the
JAX package's weighted BCE-with-logits in optax's form
(``-y·log σ(z) − (1−y)·log σ(−z)``) over the same in-order logit, and its
gradient comes from ``torch.autograd`` on the plain loss: no kernel has a
backward. Offline training (:func:`train_logreg`) is minibatch Adam
(``models/optim.py``) on the same loss, in the JAX trainer's batch order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.models.optim import (
    Adam,
    epoch_batches,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree


class LogRegParams(NamedTuple):
    w: torch.Tensor  # float32 [F]
    b: torch.Tensor  # float32 []

    def to(self, device) -> "LogRegParams":
        return LogRegParams(self.w.to(device), self.b.to(device))


def init_logreg(n_features: int, seed: int = 0,
                device=None) -> LogRegParams:
    """Weights 0.01·N(0, 1) from an explicit ``torch.Generator`` seeded
    with ``seed`` (not ``jax.random``'s stream), bias 0."""
    gen = torch.Generator().manual_seed(seed)
    w = 0.01 * torch.randn(n_features, generator=gen)
    return LogRegParams(w=w.to(device),
                        b=torch.zeros((), dtype=torch.float32,
                                      device=device))


def logreg_logits(params: LogRegParams, x: torch.Tensor) -> torch.Tensor:
    """[B, F] → ``Σ_f x_f·w_f + b`` [B], the products added in order."""
    acc = torch.zeros_like(x[:, 0])
    for f in range(x.shape[1]):
        acc = acc + x[:, f] * params.w[f]
    return acc + params.b


def logreg_predict_proba(params: LogRegParams,
                         x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(logreg_logits(params, x))


def logreg_loss(params: LogRegParams, x: torch.Tensor, y: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                pos_weight: float = 1.0) -> torch.Tensor:
    """Weighted BCE-with-logits; padded rows (``valid`` False) masked out."""
    return weighted_bce(logreg_logits(params, x), y, valid, pos_weight)


def weighted_bce(z: torch.Tensor, y: torch.Tensor,
                 valid: Optional[torch.Tensor] = None,
                 pos_weight: float = 1.0) -> torch.Tensor:
    """Mean BCE-with-logits in optax's form over logits ``z``, positives
    weighted by ``pos_weight``, rows with ``valid`` False left out: the
    loss of every classifier kind (logreg, mlp)."""
    yf = y.to(torch.float32)
    per = -yf * F.logsigmoid(z) - (1.0 - yf) * F.logsigmoid(-z)
    w = torch.where(y > 0, torch.full_like(yf, pos_weight),
                    torch.ones_like(yf))
    if valid is not None:
        w = w * valid.to(torch.float32)
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)


def loss_grad(loss_fn, params, *args):
    """(loss, gradient) of ``loss_fn(params, *args)`` with respect to
    every tensor leaf of the params tree (``utils/tree.py``), through
    ``torch.autograd`` on detached leaves (the caller's tensors are never
    marked as requiring grad). A leaf the loss does not read gets a zero
    gradient, as ``jax.grad`` gives it."""
    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree.unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), tree.unflatten(params, grads)


def sgd_update(params: LogRegParams, x: torch.Tensor, y: torch.Tensor,
               valid: torch.Tensor, lr: float,
               pos_weight: float = 1.0) -> LogRegParams:
    """One plain-SGD step (out of place): ``p − lr·∇loss``."""
    _, g = loss_grad(lambda p, *a: logreg_loss(p, *a, pos_weight=pos_weight),
                     params, x, y, valid)
    return tree.map(lambda p, gi: p - lr * gi, params, g)


def train_logreg(x: np.ndarray, y: np.ndarray, learning_rate: float = 1e-2,
                 batch_size: int = 4096, epochs: int = 5,
                 pos_weight: float = 1.0, seed: int = 0,
                 device=None) -> LogRegParams:
    """Offline minibatch-Adam training on (already scaled) features, on
    ``device`` (None = CUDA)."""
    device = resolve_device(device)
    n, f = x.shape
    opt = Adam(init_logreg(f, seed, device), learning_rate)
    xj = torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    yj = torch.as_tensor(np.asarray(y, dtype=np.float32), device=device)

    def loss(p, xb, yb):
        return logreg_loss(p, xb, yb, None, pos_weight)

    for idx in epoch_batches(n, batch_size, epochs, seed, device):
        opt.step(loss, xj[idx], yj[idx])
    return opt.params
