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
- an mlp's list of ``(w, b)`` pairs;
- ``AutoencoderParams`` (layers — such a list — and err_scale);
- ``TransformerParams`` (embed_w, embed_b, blocks — a tuple of
  ``BlockParams`` records —, lnf_g, lnf_b, head_w, head_b);
- ``Scaler`` (mean, scale);
- ``WindowState`` (bucket_day, count, amount, fraud);
- ``CountMinSketch`` (slice_day, count, amount and, on the tiered
  store's terminal sketch, fraud);
- ``KeyDirectory`` (keys, slots, free, free_top);
- ``HistoryState`` (events, pos, count, last_t);
- ``FeatureState`` (customer, terminal and, where present, the customer
  sketch ``cms`` and the tiered store's ``customer_dir``,
  ``terminal_dir`` and ``terminal_cms``);
- the parallel library's ``MoEParams`` (w_router, w1, b1, w2, b2) and
  ``StackParams`` (w1, b1, w2, b2).

A stacked ``HistoryState`` (the JAX sharded sequence engine's, leaves
``[n_shards, C/n + 1, ...]``) carries over as any other, in the layout the
port's sharded engine serves (``parallel/sequence_step.py``).

A sharded ``FeatureState`` (the JAX ``ShardedScoringEngine``'s, through
``jax.tree.map(np.asarray, ...)``) carries over the same way: its window
tables are the owner-layout global arrays and its sketch has the leading
``[n_shards]`` axis, which is the port's sharded layout
(``parallel/mesh.py``), so both sharded engines start from one state.
Arrays keep their dtypes and values, so both packages then compute the
same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.history import (
    HistoryState,
)
from real_time_fraud_detection_system_tpu_torch.features.online import (
    FeatureState,
)
from real_time_fraud_detection_system_tpu_torch.models.autoencoder import (
    AutoencoderParams,
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
from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    BlockParams,
    TransformerParams,
)
from real_time_fraud_detection_system_tpu_torch.ops.cms import CountMinSketch
from real_time_fraud_detection_system_tpu_torch.ops.keydir import KeyDirectory
from real_time_fraud_detection_system_tpu_torch.ops.windows import WindowState
from real_time_fraud_detection_system_tpu_torch.parallel.expert_parallel \
    import MoEParams
from real_time_fraud_detection_system_tpu_torch.parallel.pipeline_parallel \
    import StackParams

_RECORDS = (LogRegParams, TreeEnsemble, GemmEnsemble, Scaler, WindowState,
            CountMinSketch, KeyDirectory, BlockParams, HistoryState,
            MoEParams, StackParams)


def _matches(cls, names: set) -> bool:
    """``names`` holds every field of ``cls`` without a default and no
    field it lacks (a None field was dropped by the caller)."""
    required = set(cls._fields) - set(cls._field_defaults)
    return required <= names <= set(cls._fields)


def from_numpy(obj, device=None):
    """A JAX-package record of numpy arrays → the port's record."""
    device = resolve_device(device)

    def tensor(v):
        return torch.as_tensor(np.array(v, copy=True), device=device)

    if isinstance(obj, list):  # an mlp: [(w, b), ...]
        return [(tensor(w), tensor(b)) for w, b in obj]
    fields = obj._asdict() if hasattr(obj, "_asdict") else dict(obj)
    fields = {k: v for k, v in fields.items() if v is not None}
    names = set(fields)
    if _matches(FeatureState, names):
        return FeatureState(**{k: from_numpy(v, device)
                               for k, v in fields.items()})
    if names == set(GBTModel._fields):
        return GBTModel(trees=from_numpy(fields["trees"], device),
                        base_score=tensor(fields["base_score"]))
    if names == set(AutoencoderParams._fields):
        return AutoencoderParams(
            layers=from_numpy(list(fields["layers"]), device),
            err_scale=tensor(fields["err_scale"]))
    if names == set(TransformerParams._fields):
        return TransformerParams(**{
            k: tuple(from_numpy(blk, device) for blk in v)
            if k == "blocks" else tensor(v) for k, v in fields.items()})
    for cls in _RECORDS:
        if _matches(cls, names):
            return cls(**{k: int(v) if k == "max_depth" else tensor(v)
                          for k, v in fields.items()})
    raise ValueError(f"no port record has the fields {sorted(names)}")
