"""Latest-wins dedup on the host — port of the JAX package's
``ops/dedup.py::latest_wins_mask_np`` and ``latest_wins_mask_host``.

The reference dedups every micro-batch with
``ROW_NUMBER() OVER (PARTITION BY tx_id ORDER BY timestamp DESC)`` and keeps
rank 1 (``kafka_s3_sink_transactions.py:173-190``). Here: keep, for each
key, the row with the greatest timestamp, ties broken by the latest batch
position (Kafka log order).
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


def latest_wins_mask_host(key: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """The serving loop's dedup: the C++ O(n) hash pass
    (``native/hostprep.cc`` through ``core/native.py``) where it builds,
    else :func:`latest_wins_mask_np` — the same mask either way."""
    from real_time_fraud_detection_system_tpu_torch.core import native

    if native.hostprep_available():
        return native.latest_wins_keep(key, ts)
    return latest_wins_mask_np(key, ts)
