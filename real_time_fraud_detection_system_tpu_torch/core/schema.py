"""Typed table schemas for the payment domain — the port's own copy of the
JAX package's ``core/schema.py``.

Mirrors the reference OLTP DDL (``postgres/init.sql:8-42``) and the scorer's
output table (``pyspark/scripts/fraud_detection.py:136-163``,
``analyzed_transactions``). Money is int64 **cents** in memory (DECIMAL(10,2)
fidelity); timestamps are int64 µs since the unix epoch (the Debezium
MicroTimestamp wire unit, ``kafka_s3_sink_transactions.py:167``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class TableSchema:
    name: str
    key: str
    fields: Tuple[Tuple[str, str], ...]  # (name, numpy dtype str)

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(list(self.fields))

    @property
    def columns(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.fields)

    def empty(self, n: int = 0) -> dict:
        return {name: np.zeros(n, dtype=dt) for name, dt in self.fields}


CUSTOMERS = TableSchema(
    name="customers",
    key="customer_id",
    fields=(
        ("customer_id", "int64"),
        ("x_location", "float64"),
        ("y_location", "float64"),
    ),
)

TERMINALS = TableSchema(
    name="terminals",
    key="terminal_id",
    fields=(
        ("terminal_id", "int64"),
        ("x_location", "float64"),
        ("y_location", "float64"),
    ),
)

TRANSACTIONS = TableSchema(
    name="transactions",
    key="tx_id",
    fields=(
        ("tx_id", "int64"),
        ("tx_datetime_us", "int64"),  # µs since unix epoch
        ("customer_id", "int64"),
        ("terminal_id", "int64"),
        ("tx_amount_cents", "int64"),  # DECIMAL(10,2) as integer cents
    ),
)

# Output sink schema — analytic row per scored transaction, column-compatible
# with the reference's ``nessie.payment.analyzed_transactions`` so that the
# downstream Trino/Superset stack keeps working unchanged.
ANALYZED_TRANSACTIONS_FIELDS = (
    ("tx_id", "int64"),
    ("tx_datetime_us", "int64"),
    ("customer_id", "int64"),
    ("terminal_id", "int64"),
    ("tx_amount", "float64"),
    ("tx_during_weekend", "int32"),
    ("tx_during_night", "int32"),
    ("customer_id_nb_tx_1day_window", "int32"),
    ("customer_id_avg_amount_1day_window", "float64"),
    ("customer_id_nb_tx_7day_window", "int32"),
    ("customer_id_avg_amount_7day_window", "float64"),
    ("customer_id_nb_tx_30day_window", "int32"),
    ("customer_id_avg_amount_30day_window", "float64"),
    ("terminal_id_nb_tx_1day_window", "int32"),
    ("terminal_id_risk_1day_window", "float64"),
    ("terminal_id_nb_tx_7day_window", "int32"),
    ("terminal_id_risk_7day_window", "float64"),
    ("terminal_id_nb_tx_30day_window", "int32"),
    ("terminal_id_risk_30day_window", "float64"),
    ("processed_at_us", "int64"),
    ("prediction", "float64"),
)
