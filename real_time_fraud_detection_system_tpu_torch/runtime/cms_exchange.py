"""The fleet's host-side exchange of terminal sketch aggregates — port of
the JAX package's ``runtime/cms_exchange.py``, writing and reading the
same npz partials (either package merges the other's).

The fleet partitions the stream by ``customer_id`` residue, so customer
state is co-partitioned and the P→1 checkpoint merge sums disjoint parts.
Terminal ids are not: one terminal's traffic spreads over the fleet, so
each process's serving ``terminal_cms`` holds a PARTIAL view. This module
closes the gap at checkpoint boundaries without a collective: each
process publishes its cumulative LOCAL contributions as an atomically
renamed ``cms-pNN.npz`` in a directory the fleet shares, adopts whatever
peer partials are there under the newest-day rule of
:func:`~..parallel.mesh._merge_sketch`, and checkpoints ALWAYS store the
locals-only partial, so ``merge_process_states``' same-day sum stays
exact however stale any round was. The exchange only makes serving
fresher between resizes.

The accounting keeps an overlay ``O`` of adopted peer content:

- serving sketch ``S = locals ⊕ O`` (newest-day semantics);
- published partial ``P_self = S ⊖ O`` (locals only, cumulative);
- after merging every partial into ``M``: install ``M`` and set
  ``O' = M ⊖ P_self``.

``⊖`` subtracts where the slice days match and takes a newer-day slice
whole. A stacked ``[n_shards, ...]`` sketch gets the peer content in
SHARD 0 only (the logical merge sums same-day shards, so copying it to
every shard would multiply it).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np

from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    get_registry,
)


def _np(leaf) -> Optional[np.ndarray]:
    if leaf is None:
        return None
    detach = getattr(leaf, "detach", None)
    if detach is not None:
        return detach().cpu().numpy()
    return np.asarray(leaf)


class _Logical(NamedTuple):
    """One single-layout host view of a sketch: days [ND], tables
    [ND, depth, width] (fraud optional)."""

    days: np.ndarray
    count: np.ndarray
    amount: np.ndarray
    fraud: Optional[np.ndarray]


def _logical_of(cms) -> _Logical:
    """The newest-day merge of a (possibly ``[n_shards]``-stacked) sketch
    into one single-layout view: the host mirror of
    :func:`~..parallel.mesh._merge_sketch`."""
    days = _np(cms.slice_day)
    count = _np(cms.count)
    amount = _np(cms.amount)
    fraud = _np(cms.fraud)
    if days.ndim == 1:
        return _Logical(days.copy(), count.copy(), amount.copy(),
                        None if fraud is None else fraud.copy())
    max_day = days.max(axis=0)
    fresh = (days == max_day[None]).astype(count.dtype)[..., None, None]
    return _Logical(
        max_day,
        (count * fresh).sum(axis=0),
        (amount * fresh).sum(axis=0),
        None if fraud is None else (fraud * fresh).sum(axis=0))


def _subtract(a: _Logical, b: _Logical) -> _Logical:
    """Day-guarded ``a ⊖ b``: counts subtract where the slice days match;
    where ``a``'s day is newer it stays whole (``b``'s older content was
    retired by the ring)."""
    sub = (a.days == b.days)[..., None, None].astype(a.count.dtype)

    def tbl(x, y):
        if x is None:
            return None
        return x - (y * sub if y is not None else 0.0)

    return _Logical(a.days.copy(), tbl(a.count, b.count),
                    tbl(a.amount, b.amount), tbl(a.fraud, b.fraud))


def _merge(parts) -> _Logical:
    """The newest-day merge of logical sketches: per slice the newest day
    stamp, its holders SUMMED (disjoint locals-only partials make the
    same-day sums exact)."""
    days = np.stack([p.days for p in parts])
    max_day = days.max(axis=0)
    fresh = (days == max_day[None]).astype(parts[0].count.dtype)

    def tbl(name):
        first = getattr(parts[0], name)
        if first is None:
            return None
        return sum(getattr(p, name) * fresh[i][..., None, None]
                   for i, p in enumerate(parts))

    return _Logical(max_day, tbl("count"), tbl("amount"), tbl("fraud"))


def _is_zero(lg: Optional[_Logical]) -> bool:
    return lg is None or bool((lg.days < 0).all())


class SketchExchange:
    """One process's half of the file exchange of the terminal sketch.

    ``root`` is a directory the fleet shares. :meth:`exchange` publishes
    this process's partial and merges the peers'; :meth:`checkpoint_cms`
    takes adopted peer content back out so a checkpoint holds locals
    only. ``timeout_s`` bounds the wait for missing peer files: a round
    that merges a subset counts as ``outcome="partial"`` and the next
    catches up (the partials are cumulative)."""

    def __init__(self, root: str, process_id: int, n_processes: int,
                 timeout_s: float = 2.0):
        self.root = root
        self.process_id = int(process_id)
        self.n_processes = int(n_processes)
        self.timeout_s = float(timeout_s)
        os.makedirs(root, exist_ok=True)
        self._seq = 0
        self._overlay: Optional[_Logical] = None
        reg = get_registry()
        self._m_rounds = {
            o: reg.counter(
                "rtfds_cms_exchange_rounds_total",
                "terminal-sketch exchange rounds (merged = every peer "
                "partial present; partial = some peers missing within "
                "the timeout — cumulative partials make the next round "
                "catch up)", outcome=o)
            for o in ("merged", "partial")}

    def _path(self, pid: int) -> str:
        return os.path.join(self.root, f"cms-p{pid:02d}.npz")

    def _publish(self, part: _Logical) -> None:
        tmp = self._path(self.process_id) + ".tmp"
        payload = {"seq": np.int64(self._seq), "days": part.days,
                   "count": part.count, "amount": part.amount}
        if part.fraud is not None:
            payload["fraud"] = part.fraud
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(self.process_id))

    def _load_peer(self, pid: int) -> Optional[_Logical]:
        try:
            with np.load(self._path(pid)) as z:
                return _Logical(z["days"], z["count"], z["amount"],
                                z["fraud"] if "fraud" in z.files else None)
        except (OSError, ValueError, KeyError):
            return None

    def exchange(self, cms) -> Optional[_Logical]:
        """One round against the serving sketch ``cms`` (the engine's
        ``terminal_cms``). Returns the merged view to install
        (:func:`install_logical`), or None when there is nothing to adopt
        (one process, or no peer content yet)."""
        self._seq += 1
        local = _logical_of(cms)
        p_self = local if self._overlay is None \
            else _subtract(local, self._overlay)
        self._publish(p_self)
        peers = [p for p in range(self.n_processes)
                 if p != self.process_id]
        parts = {self.process_id: p_self}
        deadline = time.monotonic() + self.timeout_s
        while True:
            for p in peers:
                if p not in parts:
                    got = self._load_peer(p)
                    if got is not None:
                        parts[p] = got
            if len(parts) > self.n_processes - 1 or \
                    time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        complete = len(parts) == self.n_processes
        self._m_rounds["merged" if complete else "partial"].inc()
        if len(parts) == 1:
            # nothing from any peer: the earlier adoptions stand
            return None
        merged = _merge(list(parts.values()))
        self._overlay = _subtract(merged, p_self)
        return merged

    def checkpoint_cms(self, cms):
        """The locals-only form of the serving sketch for a checkpoint:
        the overlay subtracted back out of shard 0, where it was
        installed. None when no peer content was ever adopted (the state
        is checkpointed as it is). Returns numpy leaves."""
        if _is_zero(self._overlay):
            return None
        days = _np(cms.slice_day)
        if days.ndim == 1:
            part = _subtract(_logical_of(cms), self._overlay)
            return cms._replace(
                slice_day=part.days.astype(days.dtype),
                count=part.count, amount=part.amount, fraud=part.fraud)
        count, amount, fraud = _np(cms.count), _np(cms.amount), \
            _np(cms.fraud)
        shard0 = _Logical(days[0], count[0], amount[0],
                          None if fraud is None else fraud[0])
        part = _subtract(shard0, self._overlay)

        def put0(stack, new):
            if stack is None:
                return None
            out = stack.copy()
            out[0] = new
            return out

        return cms._replace(
            slice_day=put0(days, part.days.astype(days.dtype)),
            count=put0(count, part.count),
            amount=put0(amount, part.amount),
            fraud=put0(fraud, part.fraud))


def install_logical(cms, merged: _Logical):
    """Lay a merged view out as the serving sketch.

    An unstacked sketch takes the merged view whole. A stacked
    ``[n_shards, ...]`` sketch gets the whole view in SHARD 0, and the
    other shards' stale slices (day < merged day) are retired, zeroed at
    the merged day as the ring would have done; their same-day content is
    already inside ``merged``, so shard 0 holds ``merged`` MINUS it and
    the cross-shard sum is exactly ``merged``. Returns numpy leaves; the
    caller writes them into the engine's tensors."""
    days = _np(cms.slice_day)
    count, amount, fraud = _np(cms.count), _np(cms.amount), _np(cms.fraud)
    if days.ndim == 1:
        return cms._replace(
            slice_day=merged.days.astype(days.dtype),
            count=merged.count.astype(count.dtype),
            amount=merged.amount.astype(amount.dtype),
            fraud=None if fraud is None else merged.fraud)

    n = days.shape[0]
    new_days = days.copy()
    count, amount = count.copy(), amount.copy()
    fraud = None if fraud is None else fraud.copy()
    stale = days < merged.days[None]  # [n, ND]
    for d in range(1, n):
        idx = np.where(stale[d])[0]
        if idx.size:
            new_days[d, idx] = merged.days[idx]
            count[d, idx] = 0.0
            amount[d, idx] = 0.0
            if fraud is not None:
                fraud[d, idx] = 0.0
    # shard 0 := merged ⊖ (the same-day content of shards 1+)
    same = (new_days[1:] == merged.days[None]).astype(
        merged.count.dtype)[..., None, None]
    rest = _Logical(
        merged.days,
        (count[1:] * same).sum(axis=0),
        (amount[1:] * same).sum(axis=0),
        None if fraud is None else (fraud[1:] * same).sum(axis=0))
    shard0 = _subtract(merged, rest)
    new_days[0] = merged.days
    count[0] = shard0.count
    amount[0] = shard0.amount
    if fraud is not None:
        fraud[0] = shard0.fraud
    return cms._replace(slice_day=new_days.astype(days.dtype),
                        count=count, amount=amount, fraud=fraud)
