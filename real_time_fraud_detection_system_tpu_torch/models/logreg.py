"""Logistic-regression scorer — port of the JAX package's
``models/logreg.py``: the predict, the loss and the online SGD step.

The logit adds the 15 products in feature order, one after another: the
order the fused logreg kernel (``csrc/fused_score.cu``) uses, so the plain
path and the kernel agree bit for bit before the sigmoid. The loss is the
JAX package's weighted BCE-with-logits in optax's form
(``-y·log σ(z) − (1−y)·log σ(−z)``) over the same in-order logit, and its
gradient comes from ``torch.autograd`` on the plain loss: no kernel has a
backward. Offline training waits for ROADMAP A8b.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from real_time_fraud_detection_system_tpu_torch.utils import tree


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
