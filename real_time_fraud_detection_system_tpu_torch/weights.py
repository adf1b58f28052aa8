"""Carry parameters and state across from the JAX package.

:func:`from_numpy` takes one of the JAX package's parameter or state
records with its arrays turned into numpy (for example
``jax.tree.map(np.asarray, obj)``), or a plain mapping of the same field
names, and builds the port's object on ``device``. The record is
recognised by its field names:

- ``LogRegParams`` (w, b);
- ``TreeEnsemble`` (feat, thresh, left, right, prob, max_depth);
- ``GemmEnsemble`` (sel, thresh, path, target, leaf_val);
- ``GBTModel`` (trees — itself a ``TreeEnsemble`` or ``GemmEnsemble``
  record — and base_score);
- ``Scaler`` (mean, scale);
- ``WindowState`` (bucket_day, count, amount, fraud);
- ``CountMinSketch`` (slice_day, count, amount);
- ``FeatureState`` (customer, terminal and, under
  ``customer_source="cms"``, the customer sketch ``cms``). The fields of
  the tiered store — ``customer_dir``, ``terminal_dir``, ``terminal_cms``
  and a sketch's ``fraud`` column — must be None: that mode is not ported
  yet (ROADMAP A5).

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
from real_time_fraud_detection_system_tpu_torch.models.gbt import GBTModel
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.ops.cms import CountMinSketch
from real_time_fraud_detection_system_tpu_torch.ops.windows import WindowState

_RECORDS = (LogRegParams, TreeEnsemble, GemmEnsemble, Scaler, WindowState,
            CountMinSketch)
_TIERED = {"customer_dir", "terminal_dir", "terminal_cms"}


def from_numpy(obj, device=None):
    """A JAX-package record of numpy arrays → the port's record."""
    device = resolve_device(device)
    fields = obj._asdict() if hasattr(obj, "_asdict") else dict(obj)
    fields = {k: v for k, v in fields.items() if v is not None}
    names = set(fields)
    if "customer" in names or "terminal" in names:
        if names & _TIERED or not names <= {"customer", "terminal", "cms"}:
            raise NotImplementedError(
                f"feature state with {sorted(names & _TIERED)}: the tiered "
                f"store's key directories and terminal sketch (key_mode="
                f"'exact') are not ported yet (ROADMAP A5)")
        return FeatureState(
            customer=from_numpy(fields["customer"], device),
            terminal=from_numpy(fields["terminal"], device),
            cms=(from_numpy(fields["cms"], device)
                 if "cms" in fields else None))
    if "slice_day" in names and "fraud" in names:
        raise NotImplementedError(
            "a count-min sketch with a fraud column (the tiered store's) "
            "is not ported yet (ROADMAP A5)")
    if names == set(GBTModel._fields):
        return GBTModel(
            trees=from_numpy(fields["trees"], device),
            base_score=torch.as_tensor(
                np.array(fields["base_score"], copy=True), device=device))
    for cls in _RECORDS:
        if names == set(cls._fields):
            return cls(**{
                k: int(v) if k == "max_depth"
                else torch.as_tensor(np.array(v, copy=True), device=device)
                for k, v in fields.items()})
    raise ValueError(f"no port record has the fields {sorted(names)}")
