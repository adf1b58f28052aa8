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
traffic only. Offline training waits for ROADMAP A8b.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

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
