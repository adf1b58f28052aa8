"""Feature standardization — port of the JAX package's ``models/scaler.py``.

sklearn-StandardScaler-compatible: fitted on the host with numpy, applied
on the device as ``(x - mean) / scale``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device


class Scaler(NamedTuple):
    mean: torch.Tensor  # float32 [F]
    scale: torch.Tensor  # float32 [F] — stddev, zero-variance cols → 1.0

    def to(self, device) -> "Scaler":
        return Scaler(self.mean.to(device), self.scale.to(device))


def fit_scaler(x: np.ndarray, device=None) -> Scaler:
    """Fit on host (numpy), matching sklearn: ddof=0, zero-var → scale 1.
    The result lives on ``device`` (None = CUDA)."""
    device = resolve_device(device)
    mean = np.asarray(x, dtype=np.float64).mean(axis=0)
    std = np.asarray(x, dtype=np.float64).std(axis=0)
    std[std == 0.0] = 1.0
    return Scaler(
        mean=torch.as_tensor(mean.astype(np.float32), device=device),
        scale=torch.as_tensor(std.astype(np.float32), device=device),
    )


def transform(scaler: Scaler, x: torch.Tensor) -> torch.Tensor:
    return (x - scaler.mean) / scaler.scale
