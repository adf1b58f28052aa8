"""Day-ringed count-min sketch — port of the JAX package's ``ops/cms.py``.

Velocity features for key universes larger than a dense table: a ring of
``n_days`` daily sketch slices, each ``depth × width``, lazily reset when
a newer day claims its ring position. The estimate of a key's day is the
minimum over the depth rows of its hashed columns (an overestimate only);
a window query sums the per-day estimates over trailing calendar days,
with the window semantics of ``ops/windows.py``.

This is BASELINE config 3 ("HBM-resident count-min sketch per-card /
per-merchant velocity features"), served under
``FeatureConfig.customer_source="cms"``, and the sketch tier of
``key_mode="exact"``, whose terminal sketch carries a third column of
fraud-label sums (``cms_init(track_fraud=True)``, ``cms_add_fraud``,
``cms_query_fraud``). Without that column every result is the two-column
sketch's, bit for bit.

As everywhere in the port, :func:`cms_update` updates the tensors in place
and returns the same sketch. On CUDA its ``index_add_`` adds a slice's
amounts with atomics, in no fixed order: counts (whole numbers) stay
exact, amount sums may differ from an ordered sum by float32 rounding.
The query sums the per-day estimates one day after another, in order
(the JAX package multiplies by a 0/1 selection matrix), so no TF32 or
BLAS blocking enters it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from real_time_fraud_detection_system_tpu_torch.ops.hashing import multi_hash


class CountMinSketch(NamedTuple):
    """Ring of daily sketch slices. ``fraud`` (fraud-label sums) is the
    optional third column of the tiered store's terminal sketch; it comes
    last, as in the JAX package's flatten order, and None keeps the
    two-column leaves (and checkpoints)."""

    slice_day: torch.Tensor  # int32 [ND] — absolute day held by each slice
    count: torch.Tensor  # float32 [ND, depth, width]
    amount: torch.Tensor  # float32 [ND, depth, width]
    fraud: Optional[torch.Tensor] = None  # float32 [ND, depth, width]

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
             device=None, track_fraud: bool = False) -> CountMinSketch:
    shape = (n_days, depth, width)
    return CountMinSketch(
        slice_day=torch.full((n_days,), -1, dtype=torch.int32,
                             device=device),
        count=torch.zeros(shape, dtype=torch.float32, device=device),
        amount=torch.zeros(shape, dtype=torch.float32, device=device),
        fraud=torch.zeros(shape, dtype=torch.float32, device=device)
        if track_fraud else None,
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


def _shard_view(sk: CountMinSketch, shard: Optional[torch.Tensor],
                sl: torch.Tensor) -> Tuple[CountMinSketch, torch.Tensor]:
    """``(sketch, slice index)`` to address: ``sk`` and ``sl`` as given
    without ``shard``; with it (``[n_shards, ND, ...]`` leaves, one sketch
    per shard), a view of the shards' slices one after another,
    ``[n_shards·ND, ...]``, and ``sl`` moved into row ``shard``'s block
    (``shard`` broadcasts against ``sl``). The shards' slices are
    disjoint, so one call on the view is every shard's own call."""
    if shard is None:
        return sk, sl
    n, nd = sk.slice_day.shape
    flat = CountMinSketch(*[
        None if t is None else t.view((n * nd,) + tuple(t.shape[2:]))
        for t in sk])
    extra = (None,) * (sl.dim() - shard.dim())
    return flat, shard.long()[(Ellipsis,) + extra] * nd + sl


def cms_update(
    sk: CountMinSketch,
    key: torch.Tensor,  # uint32 [B]
    amount: torch.Tensor,  # float32 [B]
    day: torch.Tensor,  # int32 [B]
    valid: torch.Tensor,  # bool [B]
    fraud: Optional[torch.Tensor] = None,  # float32 [B] 0/1 (labeled rows)
    shard: Optional[torch.Tensor] = None,  # int64 [B] (stacked sketches)
) -> CountMinSketch:
    """Add one micro-batch to the sketch, IN PLACE.

    A slice is reset the first time a newer day maps onto it; rows older
    than the day a slice holds are dropped; duplicate keys all add. A
    sketch with a fraud column resets it with the others and adds
    ``fraud`` (0 where None) to it. ``shard``: the sketch holds one
    sketch per shard (``[n_shards, ND, depth, width]``, the sharded
    engine's layout) and row i goes into sketch ``shard[i]``."""
    nd = int(sk.slice_day.shape[-1])
    out = sk
    sk, sl = _shard_view(sk, shard, torch.remainder(day, nd).long())
    n_slices = sk.n_days
    day_in = torch.where(valid, day, torch.full_like(day, -1))
    before = sk.slice_day.clone()
    sk.slice_day.scatter_reduce_(0, sl, day_in, "amax", include_self=True)
    advanced = (sk.slice_day > before).view(n_slices, 1, 1)
    sk.count.masked_fill_(advanced, 0.0)
    sk.amount.masked_fill_(advanced, 0.0)

    w = (valid & (day_in == sk.slice_day[sl])).to(torch.float32)  # [B]
    flat = _flat_cells(sk, key, sl).reshape(-1)  # [depth * B]
    depth = sk.depth
    sk.count.view(-1).index_add_(0, flat, w.repeat(depth))
    sk.amount.view(-1).index_add_(0, flat, (w * amount).repeat(depth))
    if sk.fraud is not None:
        sk.fraud.masked_fill_(advanced, 0.0)
        if fraud is not None:
            sk.fraud.view(-1).index_add_(
                0, flat, (w * fraud.to(torch.float32)).repeat(depth))
    return out


def cms_add_fraud(
    sk: CountMinSketch,
    key: torch.Tensor,  # uint32 [B]
    day: torch.Tensor,  # int32 [B] — the original transaction's day
    label: torch.Tensor,  # int32/float32 [B] 0/1
    valid: torch.Tensor,  # bool [B]
    owner: Optional[torch.Tensor] = None,  # int [B] (stacked sketches)
) -> CountMinSketch:
    """Late fraud labels into the sketch tier, IN PLACE: add to the fraud
    column of the slice still holding ``day`` (counts unchanged; labels
    for days the ring has wrapped past are dropped). A sketch without the
    column is returned as it is. ``owner``: the sketch holds one sketch
    per shard (``[n_shards, ND, depth, width]``) and row i lands in
    sketch ``owner[i]``, under the same lateness rule."""
    if sk.fraud is None:
        return sk
    nd = int(sk.slice_day.shape[-1])
    view, sl = _shard_view(sk, owner, torch.remainder(day, nd).long())
    live = valid & (view.slice_day[sl] == day)
    w = live.to(torch.float32) * label.to(torch.float32)
    flat = _flat_cells(view, key, sl).reshape(-1)
    view.fraud.view(-1).index_add_(0, flat, w.repeat(view.depth))
    return sk


def _cms_query_tables(
    sk: CountMinSketch,
    tables: Sequence[str],  # field names: "count", "amount", "fraud"
    key: torch.Tensor,  # uint32 [B]
    day: torch.Tensor,  # int32 [B]
    windows: Sequence[int],
    delay: int = 0,
    shard: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Windowed min-over-depth estimates over the named parallel tables,
    each [B, len(windows)]: window w sums the per-day estimates for days
    [day-delay-w+1, day-delay]."""
    nd = int(sk.slice_day.shape[-1])
    offsets = torch.arange(max(windows), dtype=torch.int32,
                           device=day.device)
    wanted = day[:, None] - delay - offsets[None, :]  # [B, W]
    sk, sl = _shard_view(sk, shard, torch.remainder(wanted, nd).long())
    live = (sk.slice_day[sl] == wanted) & (wanted >= 0)
    flat = _flat_cells(sk, key, sl)  # [depth, B, W]
    out = []
    for t in (getattr(sk, name) for name in tables):
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
    shard: Optional[torch.Tensor] = None,  # int64 [B] (stacked sketches)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed velocity estimates: (counts, amount_sums), each [B, NW];
    ``shard`` as in :func:`cms_update`."""
    return _cms_query_tables(sk, ("count", "amount"), key, day, windows,
                             delay, shard)


def cms_query_fraud(
    sk: CountMinSketch,
    key: torch.Tensor,  # uint32 [B]
    day: torch.Tensor,  # int32 [B]
    windows: Sequence[int],
    delay: int = 0,
    shard: Optional[torch.Tensor] = None,  # int64 [B] (stacked sketches)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts, amount_sums, fraud_sums), each [B, NW], from a sketch with
    a fraud column. Count and fraud both overestimate, so a risk ratio of
    the two is an estimate, not a bound. ``shard`` as in
    :func:`cms_update`."""
    if sk.fraud is None:
        raise ValueError(
            "cms_query_fraud needs a fraud-tracking sketch "
            "(cms_init(..., track_fraud=True))")
    return _cms_query_tables(sk, ("count", "amount", "fraud"), key, day,
                             windows, delay, shard)
