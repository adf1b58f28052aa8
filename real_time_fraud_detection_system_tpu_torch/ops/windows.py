"""Device-resident rolling-window state: per-key day-bucket ring buffers.

Port of the JAX package's ``ops/windows.py``. For each of ``capacity`` key
slots, ``n_buckets`` daily buckets form a ring (``bucket = day % n_buckets``),
each holding (count, amount-sum, fraud-sum) for one absolute day, stamped
with that day. A window query sums the buckets whose stamp falls inside
the window; stale buckets simply don't match and contribute zero.

Windows are trailing calendar days including the current day: window w at
day d covers days [d-w+1, d]; with ``delay`` it covers [d-delay-w+1, d-delay].

The JAX step donates the state, so XLA updates it in place; here
:func:`update_windows` updates the tensors in place and returns the same
``WindowState``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch


class WindowState(NamedTuple):
    """Ring-buffer day aggregates for one key space (tensors of [cap, NB])."""

    bucket_day: torch.Tensor  # int32 [cap, NB]; -1 = empty
    count: torch.Tensor  # float32 [cap, NB]
    amount: torch.Tensor  # float32 [cap, NB] — sum of amounts that day
    fraud: torch.Tensor  # float32 [cap, NB] — sum of fraud labels that day

    @property
    def capacity(self) -> int:
        return int(self.bucket_day.shape[0])

    @property
    def n_buckets(self) -> int:
        return int(self.bucket_day.shape[1])


def init_window_state(capacity: int, n_buckets: int,
                      device: torch.device) -> WindowState:
    shape = (capacity, n_buckets)
    return WindowState(
        bucket_day=torch.full(shape, -1, dtype=torch.int32, device=device),
        count=torch.zeros(shape, dtype=torch.float32, device=device),
        amount=torch.zeros(shape, dtype=torch.float32, device=device),
        fraud=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def update_windows(
    state: WindowState,
    slot: torch.Tensor,  # int64 [B] in [0, capacity)
    day: torch.Tensor,  # int32 [B] absolute day index
    amount: torch.Tensor,  # float32 [B]
    fraud: torch.Tensor,  # float32 [B] — 0/1, or 0 when label unknown
    valid: torch.Tensor,  # bool [B]
    track_amount: bool = True,
    track_fraud: bool = True,
) -> WindowState:
    """Scatter one micro-batch into the ring buffers, IN PLACE.

    Semantics (the JAX package's): a bucket is reset the first time a
    *newer* day maps onto it; rows older than what a bucket currently
    holds are dropped (the ring holds n_buckets days of history).
    Duplicate (slot, day) rows within the batch all accumulate.

    Three steps: ``scatter_reduce_(amax)`` stamps each touched bucket with
    max(existing, incoming); touched buckets whose stamp advanced are
    reset; ``index_add_`` adds the rows whose day is the bucket's stamp.
    Only touched buckets can advance, so the reset reads them alone.
    ``track_amount`` / ``track_fraud`` skip a column's add (the 15-feature
    spec reads customer count+amount and terminal count+fraud only); a
    skipped column still gets the reset, so its buckets never mix days.
    On CUDA ``index_add_`` adds with atomics, in no fixed order.
    """
    nb = state.n_buckets
    flat = slot.long() * nb + torch.remainder(day, nb).long()
    day_in = torch.where(valid, day, torch.full_like(day, -1))

    bd = state.bucket_day.view(-1)
    before = bd[flat]
    bd.scatter_reduce_(0, flat, day_in, "amax", include_self=True)
    after = bd[flat]
    stale = flat[after > before]
    count = state.count.view(-1)
    amt = state.amount.view(-1)
    frd = state.fraud.view(-1)
    for col in (count, amt, frd):
        col[stale] = 0.0

    w = (valid & (day_in == after)).to(torch.float32)
    count.index_add_(0, flat, w)
    if track_amount:
        amt.index_add_(0, flat, amount * w)
    if track_fraud:
        frd.index_add_(0, flat, fraud * w)
    return state


def gather_state_rows(
    state: WindowState, slot: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row-gather per table: (bucket_day, count, amount, fraud)[slot],
    each [B, NB]."""
    return (
        state.bucket_day[slot],
        state.count[slot],
        state.amount[slot],
        state.fraud[slot],
    )


def window_sums(
    bucket_day: torch.Tensor,  # int32 [B, NB]
    values: Sequence[torch.Tensor],  # each float32 [B, NB]
    day: torch.Tensor,  # int32 [B]
    windows: Sequence[int],
    delay: int = 0,
) -> List[torch.Tensor]:
    """Age-mask window sums, one [B, len(windows)] tensor per value array.

    A bucket holding absolute day s counts toward window w iff its age
    ``a = day - delay - s`` satisfies ``0 <= a < w`` (empty buckets carry
    stamp -1 and are excluded). Buckets are summed one after another in
    ring order 0..NB-1 — the order the CUDA kernel
    (``csrc/fused_forest.cu``) uses — so the plain path and the kernel
    give bit-identical sums.
    """
    age = day[:, None] - delay - bucket_day
    live = (bucket_day >= 0) & (age >= 0)
    out = []
    for v in values:
        cols = []
        for w in windows:
            vm = torch.where(live & (age < w), v, torch.zeros_like(v))
            acc = torch.zeros_like(v[:, 0])
            for k in range(v.shape[1]):
                acc = acc + vm[:, k]
            cols.append(acc)
        out.append(torch.stack(cols, dim=1))
    return out


def query_gathered(
    bucket_day: torch.Tensor,  # int32 [B, NB]
    count: torch.Tensor,  # float32 [B, NB]
    amount: torch.Tensor,  # float32 [B, NB]
    fraud: torch.Tensor,  # float32 [B, NB]
    day: torch.Tensor,  # int32 [B]
    windows: Sequence[int],
    delay: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Window sums from pre-gathered state rows (see :func:`window_sums`).
    Returns (counts, amount_sums, fraud_sums), each [B, len(windows)]."""
    return tuple(window_sums(bucket_day, (count, amount, fraud), day,
                             windows, delay))


def query_windows(
    state: WindowState,
    slot: torch.Tensor,  # int64 [B]
    day: torch.Tensor,  # int32 [B]
    windows: Sequence[int],
    delay: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row window aggregates: window w sums days
    [day-delay-w+1, day-delay]. One row-gather per table, then
    :func:`query_gathered`."""
    bd, cnt, amt, frd = gather_state_rows(state, slot)
    return query_gathered(bd, cnt, amt, frd, day, windows, delay)
