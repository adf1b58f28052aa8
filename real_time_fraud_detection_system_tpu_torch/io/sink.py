"""Result sinks — port of the JAX package's ``io/sink.py::MemorySink``.

Parquet, object-store and dead-letter sinks are ported with the serving
loop and durability work (ROADMAP A2, A3).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from real_time_fraud_detection_system_tpu_torch.features.spec import (
    FEATURE_NAMES,
)


def _result_to_columns(res) -> dict:
    """BatchResult → analyzed_transactions column dict."""
    now_us = int(time.time() * 1e6)
    n = len(res.tx_id)
    cols = {
        "tx_id": res.tx_id.astype(np.int64),
        "tx_datetime_us": res.tx_datetime_us.astype(np.int64),
        "customer_id": res.customer_id.astype(np.int64),
        "terminal_id": res.terminal_id.astype(np.int64),
        "tx_amount": res.amount_cents.astype(np.float64) / 100.0,
    }
    # feature columns, lower-cased like the reference table DDL
    for i, name in enumerate(FEATURE_NAMES):
        if name == "TX_AMOUNT":
            continue
        dt = np.int32 if ("NB_TX" in name or "DURING" in name) else np.float64
        cols[name.lower()] = res.features[:, i].astype(dt)
    cols["processed_at_us"] = np.full(n, now_us, dtype=np.int64)
    cols["prediction"] = res.probs.astype(np.float64)
    return cols


class MemorySink:
    """Keeps every batch's analyzed columns in memory."""

    def __init__(self):
        self.batches: List[dict] = []

    def append(self, res) -> None:
        self.batches.append(_result_to_columns(res))

    def concat(self) -> dict:
        if not self.batches:
            return {}
        keys = self.batches[0].keys()
        return {k: np.concatenate([b[k] for b in self.batches]) for k in keys}
