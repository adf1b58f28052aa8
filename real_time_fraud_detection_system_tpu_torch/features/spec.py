"""The 15-feature model input vector — single source of truth.

Order and names match the reference's serving feature list
(``pyspark/scripts/fraud_detection.py:126-132``), copied from
the JAX package's ``features/spec.py``; window/flag semantics
follow the canonical definitions in :mod:`..config` (the offline-training
definitions — the reference's online SQL disagreed with its own training
pipeline; see ``config.py`` docstring).
"""

from __future__ import annotations

FEATURE_NAMES = (
    "TX_AMOUNT",
    "TX_DURING_WEEKEND",
    "TX_DURING_NIGHT",
    "CUSTOMER_ID_NB_TX_1DAY_WINDOW",
    "CUSTOMER_ID_AVG_AMOUNT_1DAY_WINDOW",
    "CUSTOMER_ID_NB_TX_7DAY_WINDOW",
    "CUSTOMER_ID_AVG_AMOUNT_7DAY_WINDOW",
    "CUSTOMER_ID_NB_TX_30DAY_WINDOW",
    "CUSTOMER_ID_AVG_AMOUNT_30DAY_WINDOW",
    "TERMINAL_ID_NB_TX_1DAY_WINDOW",
    "TERMINAL_ID_RISK_1DAY_WINDOW",
    "TERMINAL_ID_NB_TX_7DAY_WINDOW",
    "TERMINAL_ID_RISK_7DAY_WINDOW",
    "TERMINAL_ID_NB_TX_30DAY_WINDOW",
    "TERMINAL_ID_RISK_30DAY_WINDOW",
)

N_FEATURES = len(FEATURE_NAMES)
