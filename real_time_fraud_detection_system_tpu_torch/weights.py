"""Carry parameters and state across from the JAX package.

:func:`from_numpy` takes one of the JAX package's parameter or state
records with its arrays turned into numpy (for example
``jax.tree.map(np.asarray, obj)``), or a plain mapping of the same field
names, and builds the port's object on ``device``. The record is
recognised by its field names:

- ``TreeEnsemble`` (feat, thresh, left, right, prob, max_depth);
- ``GemmEnsemble`` (sel, thresh, path, target, leaf_val);
- ``Scaler`` (mean, scale);
- ``WindowState`` (bucket_day, count, amount, fraud);
- ``FeatureState`` (customer, terminal; the sketch and key-directory
  fields must be None — those modes are not ported yet).

Arrays keep their dtypes and values, so both packages then compute the
same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.online import (
    FeatureState,
)
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    GemmEnsemble,
    TreeEnsemble,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.ops.windows import WindowState

_RECORDS = (TreeEnsemble, GemmEnsemble, Scaler, WindowState)


def from_numpy(obj, device=None):
    """A JAX-package record of numpy arrays → the port's record."""
    device = resolve_device(device)
    fields = obj._asdict() if hasattr(obj, "_asdict") else dict(obj)
    fields = {k: v for k, v in fields.items() if v is not None}
    names = set(fields)
    if "customer" in names or "terminal" in names:
        if names != {"customer", "terminal"}:
            raise NotImplementedError(
                "feature state with sketches or key directories (cms and "
                "exact modes) is not ported yet (ROADMAP A5)")
        return FeatureState(
            customer=from_numpy(fields["customer"], device),
            terminal=from_numpy(fields["terminal"], device),
            cms=None)
    for cls in _RECORDS:
        if names == set(cls._fields):
            return cls(**{
                k: int(v) if k == "max_depth"
                else torch.as_tensor(np.array(v, copy=True), device=device)
                for k, v in fields.items()})
    raise ValueError(f"no port record has the fields {sorted(names)}")
