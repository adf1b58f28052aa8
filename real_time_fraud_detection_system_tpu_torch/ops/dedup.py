"""Latest-wins dedup on the host — port of the JAX package's
``ops/dedup.py::latest_wins_mask_np``.

The reference dedups every micro-batch with
``ROW_NUMBER() OVER (PARTITION BY tx_id ORDER BY timestamp DESC)`` and keeps
rank 1 (``kafka_s3_sink_transactions.py:173-190``). Here: keep, for each
key, the row with the greatest timestamp, ties broken by the latest batch
position (Kafka log order). The native C++ pass of the JAX package
(``native/hostprep.cc``) is ported with the serving loop.
"""

from __future__ import annotations

import numpy as np


def latest_wins_mask_np(
    key: np.ndarray, ts: np.ndarray, valid: np.ndarray | None = None
) -> np.ndarray:
    """bool [B]: True where the row is the latest version of its key
    (int64 keys, host-side ingest)."""
    b = len(key)
    pos = np.arange(b)
    if valid is None:
        valid = np.ones(b, dtype=bool)
    k = np.where(valid, key, np.int64(np.iinfo(np.int64).min))
    order = np.lexsort((pos, ts, k))
    k_sorted = k[order]
    is_last = np.concatenate([k_sorted[1:] != k_sorted[:-1], [True]])
    win_sorted = is_last & (k_sorted != np.iinfo(np.int64).min)
    mask = np.zeros(b, dtype=bool)
    mask[order] = win_sorted
    return mask
