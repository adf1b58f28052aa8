"""Day-ringed count-min sketch — port of the JAX package's ``ops/cms.py``.

Velocity features for key universes larger than a dense table: a ring of
``n_days`` daily sketch slices, each ``depth × width``, lazily reset when
a newer day claims its ring position. The estimate of a key's day is the
minimum over the depth rows of its hashed columns (an overestimate only);
a window query sums the per-day estimates over trailing calendar days,
with the window semantics of ``ops/windows.py``.

This is BASELINE config 3 ("HBM-resident count-min sketch per-card /
per-merchant velocity features"), served under
``FeatureConfig.customer_source="cms"``. The fraud column of the tiered
store's terminal sketch (``cms_add_fraud``, ``cms_query_fraud``) comes
with ``key_mode="exact"`` (ROADMAP A5).

As everywhere in the port, :func:`cms_update` updates the tensors in place
and returns the same sketch. On CUDA its ``index_add_`` adds a slice's
amounts with atomics, in no fixed order: counts (whole numbers) stay
exact, amount sums may differ from an ordered sum by float32 rounding.
The query sums the per-day estimates one day after another, in order
(the JAX package multiplies by a 0/1 selection matrix), so no TF32 or
BLAS blocking enters it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from real_time_fraud_detection_system_tpu_torch.ops.hashing import multi_hash


class CountMinSketch(NamedTuple):
    """Ring of daily sketch slices."""

    slice_day: torch.Tensor  # int32 [ND] — absolute day held by each slice
    count: torch.Tensor  # float32 [ND, depth, width]
    amount: torch.Tensor  # float32 [ND, depth, width]

    @property
    def n_days(self) -> int:
        return int(self.slice_day.shape[0])

    @property
    def depth(self) -> int:
        return int(self.count.shape[1])

    @property
    def width(self) -> int:
        return int(self.count.shape[2])


def cms_init(depth: int, width: int, n_days: int = 40,
             device=None) -> CountMinSketch:
    shape = (n_days, depth, width)
    return CountMinSketch(
        slice_day=torch.full((n_days,), -1, dtype=torch.int32,
                             device=device),
        count=torch.zeros(shape, dtype=torch.float32, device=device),
        amount=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def _flat_cells(sk: CountMinSketch, key: torch.Tensor,
                sl: torch.Tensor) -> torch.Tensor:
    """int64 [depth, ...] flat indices of (slice ``sl``, row d, the key's
    column in row d) into ``sk.count.view(-1)``; ``sl`` is [B] or [B, W]."""
    depth, width = sk.depth, sk.width
    cols = multi_hash(key, depth, width)  # [depth, B]
    rows = torch.arange(depth, device=cols.device)
    extra = (None,) * (sl.dim() - 1)
    return ((sl[None] * depth + rows[(slice(None), None) + extra]) * width
            + cols[(slice(None), slice(None)) + extra])


def cms_update(
    sk: CountMinSketch,
    key: torch.Tensor,  # uint32 [B]
    amount: torch.Tensor,  # float32 [B]
    day: torch.Tensor,  # int32 [B]
    valid: torch.Tensor,  # bool [B]
) -> CountMinSketch:
    """Add one micro-batch to the sketch, IN PLACE.

    A slice is reset the first time a newer day maps onto it; rows older
    than the day a slice holds are dropped; duplicate keys all add."""
    nd = sk.n_days
    sl = torch.remainder(day, nd).long()
    day_in = torch.where(valid, day, torch.full_like(day, -1))
    before = sk.slice_day.clone()
    sk.slice_day.scatter_reduce_(0, sl, day_in, "amax", include_self=True)
    advanced = (sk.slice_day > before).view(nd, 1, 1)
    sk.count.masked_fill_(advanced, 0.0)
    sk.amount.masked_fill_(advanced, 0.0)

    w = (valid & (day_in == sk.slice_day[sl])).to(torch.float32)  # [B]
    flat = _flat_cells(sk, key, sl).reshape(-1)  # [depth * B]
    depth = sk.depth
    sk.count.view(-1).index_add_(0, flat, w.repeat(depth))
    sk.amount.view(-1).index_add_(0, flat, (w * amount).repeat(depth))
    return sk


def _cms_query_tables(
    sk: CountMinSketch,
    tables: Sequence[torch.Tensor],  # each [ND, depth, width]
    key: torch.Tensor,  # uint32 [B]
    day: torch.Tensor,  # int32 [B]
    windows: Sequence[int],
    delay: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Windowed min-over-depth estimates over parallel tables, each
    [B, len(windows)]: window w sums the per-day estimates for days
    [day-delay-w+1, day-delay]."""
    nd = sk.n_days
    offsets = torch.arange(max(windows), dtype=torch.int32,
                           device=day.device)
    wanted = day[:, None] - delay - offsets[None, :]  # [B, W]
    sl = torch.remainder(wanted, nd).long()
    live = (sk.slice_day[sl] == wanted) & (wanted >= 0)
    flat = _flat_cells(sk, key, sl)  # [depth, B, W]
    out = []
    for t in tables:
        est = torch.where(live, t.view(-1)[flat].amin(dim=0),
                          torch.zeros((), dtype=t.dtype, device=t.device))
        cols = []
        for w in windows:
            acc = est[:, 0]
            for k in range(1, w):
                acc = acc + est[:, k]
            cols.append(acc)
        out.append(torch.stack(cols, dim=1))
    return tuple(out)


def cms_query(
    sk: CountMinSketch,
    key: torch.Tensor,  # uint32 [B]
    day: torch.Tensor,  # int32 [B]
    windows: Sequence[int],
    delay: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed velocity estimates: (counts, amount_sums), each [B, NW]."""
    return _cms_query_tables(sk, (sk.count, sk.amount), key, day, windows,
                             delay)
