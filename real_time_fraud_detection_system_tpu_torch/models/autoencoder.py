"""Autoencoder anomaly scorer — port of the JAX package's
``models/autoencoder.py``.

An hourglass of ``(w, b)`` layers (ReLU between, the last linear)
reconstructs the scaled feature vector; the per-row mean squared
reconstruction error is the anomaly score, squashed to a probability as
``1 − exp(−err / max(err_scale, 1e-12))``. ``err_scale`` is the
calibration the offline fit sets to the train-set median error; the loss
does not read it, so its gradient is exactly zero (``loss_grad``
materializes it, as ``jax.grad`` does). The loss masks out frauds and
invalid rows, so online updates pull the manifold toward legitimate
traffic only. Offline training (:func:`train_autoencoder`) fits the
layers with minibatch Adam on legitimate rows only, then sets
``err_scale`` to the train-set median error.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.models.optim import (
    Adam,
    epoch_batches,
)

Layers = List[Tuple[torch.Tensor, torch.Tensor]]


class AutoencoderParams(NamedTuple):
    layers: Layers  # encoder + decoder stacked; last layer linear
    err_scale: torch.Tensor  # float32 [] — calibration of the squash


def init_autoencoder(n_features: int, hidden: Sequence[int] = (32, 8),
                     seed: int = 0, device=None) -> AutoencoderParams:
    """Symmetric hourglass f → hidden… → bottleneck → …hidden → f, He-normal
    weights from an explicit ``torch.Generator``, ``err_scale`` 1."""
    gen = torch.Generator().manual_seed(seed)
    dims = [n_features, *hidden, *reversed(hidden[:-1]), n_features]
    layers: Layers = []
    for i in range(len(dims) - 1):
        scale = float(np.sqrt(2.0 / dims[i]))
        w = torch.randn((dims[i], dims[i + 1]), generator=gen) * scale
        layers.append((w.to(device), torch.zeros(dims[i + 1], device=device)))
    return AutoencoderParams(layers=layers,
                             err_scale=torch.tensor(1.0, device=device))


def reconstruct(params: AutoencoderParams, x: torch.Tensor) -> torch.Tensor:
    h = x
    for w, b in params.layers[:-1]:
        h = torch.relu(h @ w + b)
    w, b = params.layers[-1]
    return h @ w + b


def reconstruction_error(params: AutoencoderParams,
                         x: torch.Tensor) -> torch.Tensor:
    """Per-row mean squared reconstruction error."""
    r = reconstruct(params, x)
    return torch.mean((r - x) ** 2, dim=-1)


def autoencoder_predict_proba(params: AutoencoderParams,
                              x: torch.Tensor) -> torch.Tensor:
    """Anomaly score in [0, 1): ``1 − exp(−err / err_scale)``, monotone in
    the reconstruction error."""
    err = reconstruction_error(params, x)
    return 1.0 - torch.exp(-err / torch.clamp(params.err_scale, min=1e-12))


def autoencoder_loss(params: AutoencoderParams, x: torch.Tensor,
                     y: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean reconstruction MSE; labelled frauds (``y`` = 1) and
    padded rows are left out."""
    per = reconstruction_error(params, x)
    w = torch.ones_like(per)
    if y is not None:
        w = w * (1.0 - torch.clamp(y.to(torch.float32), 0.0, 1.0))
    if valid is not None:
        w = w * valid.to(torch.float32)
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1.0)


def train_autoencoder(x: np.ndarray, y: Optional[np.ndarray] = None,
                      hidden: Sequence[int] = (32, 8),
                      learning_rate: float = 1e-3, batch_size: int = 4096,
                      epochs: int = 10, seed: int = 0,
                      device=None) -> AutoencoderParams:
    """Fit on scaled features, on ``device`` (None = CUDA); rows with
    ``y == 1`` are left out. The batch is ``min(batch_size, n)`` rows;
    ``err_scale`` is ``max(median train error, 1e-6)``."""
    device = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    if y is not None:
        x = x[np.asarray(y) == 0]
    n, f = x.shape
    if n == 0:
        raise ValueError(
            "train_autoencoder: no legitimate rows to train on "
            "(all rows filtered out by labels)")
    params = init_autoencoder(f, hidden, seed, device)
    opt = Adam(params.layers, learning_rate)
    xj = torch.as_tensor(x, device=device)

    def loss(layers, xb):
        return autoencoder_loss(params._replace(layers=layers), xb)

    for idx in epoch_batches(n, min(batch_size, n), epochs, seed, device):
        opt.step(loss, xj[idx])
    params = params._replace(layers=opt.params)
    # Calibrate the probability squash to the train-set median error.
    with torch.no_grad():
        errs = reconstruction_error(params, xj).cpu().numpy()
    med = float(np.median(errs)) if len(errs) else 1.0
    return params._replace(err_scale=torch.tensor(
        max(med, 1e-6), dtype=torch.float32, device=device))
