"""Micro-batch representation — port of the JAX package's ``core/batch.py``.

A ``TxBatch`` is the columnar unit of work one engine step consumes.
Ragged stream batches are padded to a small set of bucket sizes, and the
host moves a batch to the device as ONE int32 ``[7, B]`` array
(:func:`pack_batch`); :func:`unpack_batch` reads it back as bit views, so
the round trip is exact and copies nothing on the device.

Device tensors are 32-bit: timestamps travel as (day, second-of-day)
pairs, and 64-bit identifiers stay on the host (rows are re-joined by
position after scoring). Keys are uint32 bit patterns; torch lacks ``>>``
and ``%`` on ``torch.uint32``, so slot arithmetic runs on an int32 view.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

US_PER_DAY = 86_400_000_000


class TxBatch(NamedTuple):
    """Columnar transaction micro-batch: numpy arrays on the host, or
    tensors on the device (after :func:`unpack_batch`).

    All arrays have leading dim B (padded bucket size). ``valid`` masks the
    padding; padded rows never touch state or sinks.
    """

    customer_key: "np.ndarray | torch.Tensor"  # uint32 [B]
    terminal_key: "np.ndarray | torch.Tensor"  # uint32 [B]
    day: "np.ndarray | torch.Tensor"  # int32 [B] — days since unix epoch
    tod_s: "np.ndarray | torch.Tensor"  # int32 [B] — second within day
    amount: "np.ndarray | torch.Tensor"  # float32 [B] — dollars
    label: "np.ndarray | torch.Tensor"  # int32 [B] — -1 unknown, else 0/1
    valid: "np.ndarray | torch.Tensor"  # bool [B]

    @property
    def size(self) -> int:
        return int(self.customer_key.shape[0])


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket that fits n rows (largest bucket if none)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def fold_key(ids: np.ndarray) -> np.ndarray:
    """Fold int64 ids to uint32 keys (xor-fold hi/lo words)."""
    v = ids.astype(np.uint64)
    return ((v ^ (v >> np.uint64(32))) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def make_batch(
    customer_id: np.ndarray,
    terminal_id: np.ndarray,
    tx_datetime_us: np.ndarray,
    amount_cents: np.ndarray,
    label: Optional[np.ndarray] = None,
    pad_to: Optional[int] = None,
) -> TxBatch:
    """Build a host-side (numpy) TxBatch from columnar int64 inputs."""
    n = len(customer_id)
    m = pad_to if pad_to is not None else n
    if m < n:
        raise ValueError(f"pad_to={m} < batch rows {n}")

    def _pad(a: np.ndarray) -> np.ndarray:
        out = np.zeros(m, dtype=a.dtype)
        out[:n] = a
        return out

    day = (tx_datetime_us // US_PER_DAY).astype(np.int32)
    tod = ((tx_datetime_us % US_PER_DAY) // 1_000_000).astype(np.int32)
    lab = (label if label is not None else np.full(n, -1)).astype(np.int32)
    valid = np.zeros(m, dtype=bool)
    valid[:n] = True
    return TxBatch(
        customer_key=_pad(fold_key(customer_id)),
        terminal_key=_pad(fold_key(terminal_id)),
        day=_pad(day),
        tod_s=_pad(tod),
        amount=_pad((amount_cents.astype(np.float64) / 100.0).astype(np.float32)),
        label=_pad(lab),
        valid=valid,
    )


def pad_batch(batch: TxBatch, pad_to: int) -> TxBatch:
    """Pad an existing (numpy) TxBatch up to ``pad_to`` rows."""
    n = batch.size
    if pad_to == n:
        return batch
    if pad_to < n:
        raise ValueError(f"pad_to={pad_to} < batch rows {n}")

    def _pad(a):
        a = np.asarray(a)
        out = np.zeros((pad_to,) + a.shape[1:], dtype=a.dtype)
        out[:n] = a
        return out

    return TxBatch(*[_pad(x) for x in batch])


def pack_batch(batch: TxBatch) -> np.ndarray:
    """Host-side TxBatch → ONE int32 array [7, B] for a single H2D copy.

    uint32 keys and float32 amounts travel as their int32 bit patterns;
    :func:`unpack_batch` views them back, so the round trip is exact.
    """
    return np.stack([
        np.asarray(batch.customer_key).view(np.int32),
        np.asarray(batch.terminal_key).view(np.int32),
        np.asarray(batch.day),
        np.asarray(batch.tod_s),
        np.asarray(batch.amount).view(np.int32),
        np.asarray(batch.label),
        np.asarray(batch.valid).astype(np.int32),
    ])


def unpack_batch(packed: torch.Tensor) -> TxBatch:
    """Device-side inverse of :func:`pack_batch`: bit views of the rows of
    one contiguous int32 ``[7, B]`` tensor (no copies, except the
    ``valid`` compare)."""
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or packed.shape[0] != 7 or not packed.is_contiguous():
        raise ValueError(
            f"expected a contiguous int32 [7, B] tensor, got "
            f"{packed.dtype} {tuple(packed.shape)}")
    return TxBatch(
        customer_key=packed[0].view(torch.uint32),
        terminal_key=packed[1].view(torch.uint32),
        day=packed[2],
        tod_s=packed[3],
        amount=packed[4].view(torch.float32),
        label=packed[5],
        valid=packed[6] != 0,
    )
