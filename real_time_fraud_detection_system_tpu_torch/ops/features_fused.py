"""The 15-feature assembly from the feature-state tables, in plain PyTorch.

Counterpart of the JAX package's ``ops/pallas_kernels.py::assemble_features``
(the feature half shared by its two fused Pallas kernels) on the rows of
``ops/windows.py::gather_state_rows``. Here :func:`gather_feature_rows`
then :func:`assemble_features` is the plain composition that both fused
kernels are held against — the forest's (``ops/forest_kernels.py``) and
the logreg's (``ops/score_kernels.py``), whose CUDA sources share one
device copy of it (``csrc/features.cuh``) and read the rows by slot from
the tables — and the feature half of the unfused step
(``features/online.py::update_and_featurize``).

Feature order matches ``features/spec.py::FEATURE_NAMES``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from real_time_fraud_detection_system_tpu_torch.ops.cuda_lib import (
    check_tensor,
)
from real_time_fraud_detection_system_tpu_torch.ops.windows import (
    WindowState,
    window_sums,
)

Rows = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def gather_feature_rows(customer: WindowState, terminal: WindowState,
                        cust_slot: torch.Tensor, term_slot: torch.Tensor
                        ) -> Tuple[Rows, Rows]:
    """The six [B, NB] row gathers a feature reads: customer (bd, cnt,
    amt)[cust_slot] and terminal (bd, cnt, frd)[term_slot]. The columns no
    feature reads (customer fraud, terminal amount) are not gathered."""
    return ((customer.bucket_day[cust_slot], customer.count[cust_slot],
             customer.amount[cust_slot]),
            (terminal.bucket_day[term_slot], terminal.count[term_slot],
             terminal.fraud[term_slot]))


def check_slots(customer: WindowState, terminal: WindowState,
                cust_slot: torch.Tensor, term_slot: torch.Tensor) -> None:
    """Raise ``IndexError`` for a slot outside [0, capacity) (indexing
    alone would wrap a negative one). The plain versions of the fused
    kernels call it; it waits for the device."""
    for name, slot, cap in (("cust_slot", cust_slot, customer.capacity),
                            ("term_slot", term_slot, terminal.capacity)):
        if slot.numel() and bool(((slot < 0) | (slot >= cap)).any()):
            raise IndexError(f"{name}: a slot is outside [0, {cap})")


def check_feature_inputs(customer: WindowState, terminal: WindowState,
                         cust_slot: torch.Tensor, term_slot: torch.Tensor,
                         day: torch.Tensor, tod_s: torch.Tensor,
                         amount: torch.Tensor, device: torch.device
                         ) -> Tuple[int, int]:
    """Check what a fused kernel's feature half reads through raw pointers
    (the six table arrays, contiguous [cap, NB] with one NB and 16-byte
    aligned, as the kernels read runs in vectors of up to 16 bytes; int64
    slots and the per-row scalars, [B]) and return (B, NB). Raises
    ``ValueError``. The slots' range is not checked: a slot outside [0,
    capacity) is the caller's error."""
    nb = customer.bucket_day.shape[-1]
    for tname, table, cols in (("customer", customer, ("bucket_day", "count",
                                                       "amount")),
                               ("terminal", terminal, ("bucket_day", "count",
                                                       "fraud"))):
        cap = table.bucket_day.shape[0]
        for col in cols:
            t = getattr(table, col)
            check_tensor(t, f"{tname}.{col}",
                         torch.int32 if col == "bucket_day" else torch.float32,
                         (cap, nb), device)
            if t.data_ptr() % 16:
                raise ValueError(f"{tname}.{col}: the kernels read it in "
                                 f"16-byte vectors; it is not 16-byte "
                                 f"aligned")
    if cust_slot.dim() != 1:
        raise ValueError(f"cust_slot: expected int64 [B], got "
                         f"{tuple(cust_slot.shape)}")
    b = cust_slot.shape[0]
    check_tensor(cust_slot, "cust_slot", torch.int64, (b,), device)
    check_tensor(term_slot, "term_slot", torch.int64, (b,), device)
    check_tensor(day, "day", torch.int32, (b,), device)
    check_tensor(tod_s, "tod_s", torch.int32, (b,), device)
    check_tensor(amount, "amount", torch.float32, (b,), device)
    return b, nb


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
    """Gathered state rows (:func:`gather_feature_rows`) → raw [B, F]
    feature block (age-mask form)."""
    c_bd, c_cnt, c_amt = c_rows
    t_bd, t_cnt, t_frd = t_rows
    c_count, c_amount = window_sums(c_bd, (c_cnt, c_amt), day, windows)
    t_count, t_fraud = window_sums(t_bd, (t_cnt, t_frd), day, windows,
                                   delay)
    is_weekend, is_night = flags(day, tod_s, weekend_start, night_end)
    return stack_features(amount, is_weekend, is_night, c_count,
                          ratio(c_amount, c_count), t_count,
                          ratio(t_fraud, t_count))
