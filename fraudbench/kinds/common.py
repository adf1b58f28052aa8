"""What every kind shares: the program's configuration from a
configuration file, and the seeded generator the weights are drawn
from."""

from __future__ import annotations

import dataclasses

import torch

# the weights' stream, apart from the traffic's (seeded with the seed)
_WEIGHT_STREAM = 0x5DEECE66D


def weight_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + _WEIGHT_STREAM)
                    % (1 << 63))
    return gen


def port_config(cfg: dict):
    """The program's ``Config`` from a configuration file's ``features``
    and ``runtime`` groups (lists become tuples; every other setting
    keeps the program's default)."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        Config,
        FeatureConfig,
        RuntimeConfig,
    )

    def fields(cls, group: dict) -> dict:
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(group) - names
        if unknown:
            raise ValueError(f"{cls.__name__} has no {sorted(unknown)}")
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in group.items()}

    return Config(features=FeatureConfig(**fields(FeatureConfig,
                                                  cfg["features"])),
                  runtime=RuntimeConfig(**fields(RuntimeConfig,
                                                 cfg["runtime"])))
