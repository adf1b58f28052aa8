"""Synthetic transaction data."""

from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
    generate_dataset,
)

__all__ = ["Transactions", "generate_dataset"]
