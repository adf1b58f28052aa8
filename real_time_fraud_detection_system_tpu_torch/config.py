"""Typed configuration for the PyTorch/CUDA serving path.

A copy of the parts of ``real_time_fraud_detection_system_tpu/config.py``
that the forest serving path reads: a subset of its fields, with the same
names, defaults and validation, so one set of values configures both
packages. Canonical
feature definitions (night = ``hour <= 6``, weekend = ``weekday >= 5``
with Monday == 0) are the JAX package's; see its module docstring.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class DataConfig:
    """Synthetic data generator knobs (reference ``data_generator.ipynb · cell 34``)."""

    n_customers: int = 5000
    n_terminals: int = 10000
    n_days: int = 245
    radius: float = 5.0
    start_date: str = "2025-04-01"
    seed: int = 0
    # Fraud scenarios (reference ``data_generator.ipynb · cell 42``).
    scenario1_amount_threshold: float = 220.0
    scenario2_terminals_per_day: int = 2
    scenario2_compromise_days: int = 28
    scenario3_customers_per_day: int = 3
    scenario3_compromise_days: int = 14
    scenario3_amount_multiplier: float = 5.0
    scenario3_fraction: float = 1.0 / 3.0


@dataclass(frozen=True)
class FeatureConfig:
    """Stateful windowed feature computation.

    Customer {1,7,30}-day count+avg-amount; terminal {1,7,30}-day
    count+risk shifted back by ``delay_days`` (fraud labels arrive late).
    The port serves ``key_mode="direct"`` with ``customer_source="table"``;
    the JAX package's other modes are accepted here and refused by
    ``features/online.py`` until they are ported, and their tuning fields
    come with them.
    """

    windows: Sequence[int] = (1, 7, 30)
    delay_days: int = 7
    # Day-bucket ring buffers must cover delay + max(window) days of history.
    n_day_buckets: int = 40
    # Dense per-key state capacity (power of 2).
    customer_capacity: int = 8192
    terminal_capacity: int = 16384
    # "direct" (key & (cap-1)) is collision-free for dense serial ids below
    # the capacity; "hash" and "exact" are not ported yet.
    key_mode: str = "direct"
    customer_source: str = "table"
    night_end_hour: int = 6
    weekend_start_weekday: int = 5  # Monday == 0

    def __post_init__(self):
        if self.customer_source not in ("table", "cms"):
            raise ValueError(
                f"customer_source must be 'table' or 'cms', "
                f"got {self.customer_source!r}")
        if self.key_mode not in ("direct", "hash", "exact"):
            raise ValueError(
                f"key_mode must be 'direct', 'hash' or 'exact', "
                f"got {self.key_mode!r}")
        for name in ("customer_capacity", "terminal_capacity"):
            cap = getattr(self, name)
            if cap < 1 or cap & (cap - 1):
                raise ValueError(
                    f"{name} must be a power of two (direct mode masks "
                    f"with capacity-1; non-pow2 silently aliases keys), "
                    f"got {cap}")


@dataclass(frozen=True)
class ModelConfig:
    """The forest's shape (the flagship artifact's)."""

    forest_n_trees: int = 100
    forest_max_depth: int = 8


@dataclass(frozen=True)
class RuntimeConfig:
    """Micro-batch engine knobs that the port reads.

    The JAX package's ``use_pallas`` has no field here: the port serves
    the fused featurize→forest step whenever the kernel's admission
    predicate holds (on the CPU the wrapper runs its plain version).
    ``max_batch_rows`` comes with the CLI that reads it (ROADMAP A2).
    """

    # Dtype of the dense path table: "auto" = int8 on CUDA, f32 elsewhere.
    # On the forest kernels' paths it only chooses the dtype of the plain
    # version's table: the kernels descend node tables that do not depend
    # on it, and every mode gives bit-identical sums.
    z_mode: str = "auto"
    # False = alerts-only serving: BatchResult.features is zeros and the
    # [B, 15] matrix never leaves the device.
    emit_features: bool = True
    # Pad micro-batches to these row counts.
    batch_buckets: Sequence[int] = (256, 1024, 4096, 16384, 65536)

    def __post_init__(self):
        if self.z_mode not in ("auto", "f32", "bf16", "int8"):
            raise ValueError(
                f"z_mode must be 'auto', 'f32', 'bf16' or 'int8', "
                f"got {self.z_mode!r}")


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
