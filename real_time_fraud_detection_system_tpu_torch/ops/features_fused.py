"""The 15-feature assembly from gathered state rows, in plain PyTorch.

Counterpart of the JAX package's ``ops/pallas_kernels.py::assemble_features``
(the feature half shared by its two fused Pallas kernels). Here it is the
plain composition that the fused forest kernel (``ops/forest_kernels.py``,
``csrc/fused_forest.cu``) is held against, and the feature half of the
unfused step (``features/online.py::update_and_featurize``). The logreg
kernel of ``ops/pallas_kernels.py`` (``fused_featurize_score``) is not
ported yet.

Feature order matches ``features/spec.py::FEATURE_NAMES``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from real_time_fraud_detection_system_tpu_torch.ops.windows import (
    window_sums,
)


def flags(day: torch.Tensor, tod_s: torch.Tensor, weekend_start: int,
          night_end: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_weekend, is_night) float32 flags from (day, tod_s).

    Unix day 0 (1970-01-01) was a Thursday → weekday(Mon=0) = (day+3) % 7
    (floor modulo, as ``jnp.remainder``)."""
    weekday = torch.remainder(day + 3, 7)
    is_weekend = (weekday >= weekend_start).to(torch.float32)
    hour = torch.div(tod_s, 3600, rounding_mode="floor")
    is_night = (hour <= night_end).to(torch.float32)
    return is_weekend, is_night


def ratio(num: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """``num / max(cnt, 1)`` where ``cnt > 0``, else 0 (IEEE division)."""
    return torch.where(cnt > 0, num / torch.clamp(cnt, min=1.0),
                       torch.zeros_like(num))


def stack_features(amount, is_weekend, is_night, c_count, c_avg, t_count,
                   t_risk) -> torch.Tensor:
    """Columns → [B, 3 + 4·len(windows)] in ``FEATURE_NAMES`` order."""
    cols = [amount, is_weekend, is_night]
    for i in range(c_count.shape[1]):
        cols += [c_count[:, i], c_avg[:, i]]
    for i in range(t_count.shape[1]):
        cols += [t_count[:, i], t_risk[:, i]]
    return torch.stack(cols, dim=1)


def assemble_features(
    c_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # bd, cnt, amt
    t_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # bd, cnt, frd
    day: torch.Tensor,  # int32 [B]
    tod_s: torch.Tensor,  # int32 [B]
    amount: torch.Tensor,  # float32 [B]
    *,
    windows: Sequence[int],
    delay: int,
    weekend_start: int,
    night_end: int,
) -> torch.Tensor:
    """Gathered state rows → raw [B, F] feature block (age-mask form)."""
    c_bd, c_cnt, c_amt = c_rows
    t_bd, t_cnt, t_frd = t_rows
    c_count, c_amount = window_sums(c_bd, (c_cnt, c_amt), day, windows)
    t_count, t_fraud = window_sums(t_bd, (t_cnt, t_frd), day, windows,
                                   delay)
    is_weekend, is_night = flags(day, tod_s, weekend_start, night_end)
    return stack_features(amount, is_weekend, is_night, c_count,
                          ratio(c_amount, c_count), t_count,
                          ratio(t_fraud, t_count))
