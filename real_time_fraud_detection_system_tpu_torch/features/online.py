"""Online feature computation: update device state, emit the 15 features.

Port of the JAX package's ``features/online.py``, with
``customer_source="table"`` or ``"cms"`` (the count-min sketch of
``ops/cms.py`` in place of the customer table), for every ``key_mode``:
"direct" and "hash" map a key to its slot statically; "exact" is the
tiered store (:func:`update_and_featurize_exact`): slots come from the key
directories of ``ops/keydir.py``, rows that miss admission read the sketch
tier, :func:`compact_feature_state` reclaims dead history on a cadence
(and demotes the oldest keys to the host cold tier under pressure), and
:func:`promote_rows` merges cold rows back. :func:`apply_feedback` lands
delayed fraud labels in the terminal risk windows (in exact mode by a
directory lookup, the misses in the terminal sketch's fraud column).
Over N shards (``n_shards`` of :func:`init_feature_state`) each shard has
its own directory over its block of the tables;
:func:`apply_feedback_sharded_exact` looks labels up in the owner's, and
the sharded step, compaction and promotion live in ``parallel/step.py``.
One call per micro-batch scatters the batch into the rolling-window state,
then reads the feature vector of every row from it (update-then-query: a
row's windows include itself and its batch-mates of the same key and day).
The fused steps hand the tables and slots to their kernels, which read the
rows by slot; the unfused step gathers the rows first (and, under
``customer_source="cms"``, reads the customer windows from the sketch).

Terminal fraud labels arrive late; the risk windows are delay-shifted, so
current-batch labels never reach the queried window.

The JAX step donates the state and XLA updates it in place; here the
state tensors are updated in place and the same ``FeatureState`` is
returned.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from real_time_fraud_detection_system_tpu_torch.config import FeatureConfig
from real_time_fraud_detection_system_tpu_torch.core.batch import TxBatch
from real_time_fraud_detection_system_tpu_torch.ops.cms import (
    CountMinSketch,
    cms_add_fraud,
    cms_init,
    cms_query,
    cms_query_fraud,
    cms_update,
)
from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
    flags,
    gather_feature_rows,
    ratio,
    stack_features,
)
from real_time_fraud_detection_system_tpu_torch.ops.forest_kernels import (
    ForestTables,
    fused_forest_leaf_sum,
)
from real_time_fraud_detection_system_tpu_torch.ops.hashing import (
    slot_of,
    widen_u32,
)
from real_time_fraud_detection_system_tpu_torch.ops.keydir import (
    KeyDirectory,
    admit_slots,
    init_keydir,
    init_stacked_keydir,
    lookup_slots,
    lookup_slots_stacked,
    put_kept_,
    reclaim_entries,
)
from real_time_fraud_detection_system_tpu_torch.ops.score_kernels import (
    fused_featurize_score,
)
from real_time_fraud_detection_system_tpu_torch.ops.windows import (
    WindowState,
    init_window_state,
    update_windows,
    window_sums,
)


class FeatureState(NamedTuple):
    """All device-resident feature state. ``cms`` is the customer sketch
    under ``customer_source="cms"`` (the customer table is then allocated
    but never read or written, as in the JAX package) and under
    ``key_mode="exact"``, else None. The three trailing fields exist only
    under ``key_mode="exact"``: the key directories of both hot-tier
    tables (no customer directory under ``customer_source="cms"``) and the
    terminal sketch with its fraud column. They come last, as in the JAX
    package, so direct and hash states keep their leaves."""

    customer: WindowState
    terminal: WindowState
    cms: Optional[CountMinSketch] = None
    customer_dir: Optional[KeyDirectory] = None
    terminal_dir: Optional[KeyDirectory] = None
    terminal_cms: Optional[CountMinSketch] = None


def init_feature_state(cfg: FeatureConfig, device,
                       n_shards: int = 1) -> FeatureState:
    """A fresh state. ``n_shards > 1`` builds the sharded exact layout:
    the window tables stay global ``[capacity, NB]`` (shard s owns rows
    ``[s·cap/n, (s+1)·cap/n)``) and each shard gets its own key directory
    over its local slot range, stacked ``[n_shards, ...]``
    (``ops/keydir.py::init_stacked_keydir``). The sketches keep the
    single layout here; ``parallel/mesh.py::shard_feature_state`` gives
    each shard its replica. Other key modes ignore ``n_shards``."""
    exact = cfg.key_mode == "exact"
    nb = cfg.n_day_buckets
    customer_dir = terminal_dir = terminal_cms = None
    if exact:
        # directory at 2x the slot capacity: load factor <= 0.5 keeps the
        # fixed-depth probing lossless until the free stack runs dry
        def _dir(cap: int) -> KeyDirectory:
            if n_shards > 1:
                if cap % n_shards:
                    raise ValueError(
                        f"capacity {cap} must divide by n_shards "
                        f"{n_shards}")
                local = cap // n_shards
                return init_stacked_keydir(2 * local, local, n_shards,
                                           device)
            return init_keydir(2 * cap, cap, device)

        if cfg.customer_source != "cms":
            customer_dir = _dir(cfg.customer_capacity)
        terminal_dir = _dir(cfg.terminal_capacity)
        terminal_cms = cms_init(cfg.cms_depth, cfg.cms_width, nb, device,
                                track_fraud=True)
    return FeatureState(
        customer=init_window_state(cfg.customer_capacity, nb, device),
        terminal=init_window_state(cfg.terminal_capacity, nb, device),
        # exact mode always carries the customer sketch: the overflow tier
        cms=cms_init(cfg.cms_depth, cfg.cms_width, nb, device)
        if cfg.customer_source == "cms" or exact else None,
        customer_dir=customer_dir,
        terminal_dir=terminal_dir,
        terminal_cms=terminal_cms,
    )


def _slot(key: torch.Tensor, capacity: int, mode: str) -> torch.Tensor:
    """uint32 key → int64 table slot. 'direct' is exact for dense serial
    ids (< capacity): ``key & (capacity-1)``, taken on the int32 view
    (torch has no ``&`` on uint32 tensors; the low bits are the same).
    'hash' mixes the key first (``ops/hashing.py::slot_of``): bounded
    memory for sparse key universes, colliding keys share a slot."""
    if mode == "direct":
        return (key.view(torch.int32) & (capacity - 1)).long()
    if mode == "hash":
        return slot_of(key, capacity)
    raise ValueError(
        f"key_mode={mode!r} has no static slot map (key_mode='exact' "
        f"routes through the key directory, ops/keydir.py::admit_slots)")


def state_bytes(cfg: FeatureConfig, n_shards: int = 1) -> dict:
    """Static device accounting of the feature state
    :func:`init_feature_state` builds (the JAX package's numbers, which
    the engine's ``state_hbm_budget_mb`` check reads): window tables hold
    bucket_day i32 + count/amount/fraud f32 = 16 B per bucket; a sketch a
    slice_day i32 per day and two f32 tables of depth × width per day,
    the terminal sketch a third; a directory keys u32 + slots i32 over 2×
    the slots, free i32 per slot and free_top. ``n_shards``: the sharded
    engine's width — the window tables and directories partition (one
    free_top per shard), but every shard keeps its own sketch, so the
    cms tier multiplies."""
    exact = cfg.key_mode == "exact"
    nb = cfg.n_day_buckets
    n_shards = max(n_shards, 1)
    dense = (cfg.customer_capacity + cfg.terminal_capacity) * nb * 16
    n_sketches = int(cfg.customer_source == "cms" or exact) + int(exact)
    table = nb * cfg.cms_depth * cfg.cms_width * 4
    cms = n_sketches * (nb * 4 + 2 * table)
    directory = 0
    if exact:
        cms += table  # the terminal sketch's fraud column
        for cap, present in ((cfg.customer_capacity,
                              cfg.customer_source != "cms"),
                             (cfg.terminal_capacity, True)):
            if present:
                directory += 2 * cap * 8 + cap * 4 + 4 * n_shards
    cms *= n_shards
    return {"dense": int(dense), "directory": int(directory),
            "cms": int(cms), "total": int(dense + directory + cms)}


def _flags(batch: TxBatch, cfg: FeatureConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_weekend, is_night) float32 flags from (day, tod_s)."""
    return flags(batch.day, batch.tod_s, cfg.weekend_start_weekday,
                 cfg.night_end_hour)


def _update_state(
    state: FeatureState, batch: TxBatch, cfg: FeatureConfig
) -> Tuple[FeatureState, torch.Tensor, torch.Tensor]:
    """Scatter-update half of both scoring paths, in place.

    Returns (state, cust_slot, term_slot). Labeled rows
    (``batch.label >= 0``) also scatter fraud counts into the terminal
    state; unlabeled rows contribute 0. The customer table skips its
    fraud column and the terminal table its amount column: no feature
    reads them. Under ``customer_source="cms"`` the customer rows go into
    the sketch instead of the customer table.
    """
    cust_slot = _slot(batch.customer_key, cfg.customer_capacity, cfg.key_mode)
    term_slot = _slot(batch.terminal_key, cfg.terminal_capacity, cfg.key_mode)
    fraud = torch.clamp(batch.label, min=0).to(torch.float32)
    if cfg.customer_source == "cms":
        _require_sketch(state)
        cms_update(state.cms, batch.customer_key, batch.amount, batch.day,
                   batch.valid)
    else:
        update_windows(state.customer, cust_slot, batch.day, batch.amount,
                       fraud, batch.valid, track_fraud=False)
    update_windows(state.terminal, term_slot, batch.day, batch.amount, fraud,
                   batch.valid, track_amount=False)
    return state, cust_slot, term_slot


def _require_table_source(cfg: FeatureConfig) -> None:
    """The fused kernels read the customer table; under
    ``customer_source="cms"`` the engine serves the unfused step."""
    if cfg.customer_source != "table":
        raise ValueError(
            "the fused steps read the customer table; customer_source="
            f"{cfg.customer_source!r} serves through update_and_featurize")


def _require_sketch(state: FeatureState) -> None:
    if state.cms is None:
        raise ValueError(
            "customer_source='cms' but the feature state has no sketch "
            "(init_feature_state must be built from the same config)")


def update_and_featurize(
    state: FeatureState,
    batch: TxBatch,
    cfg: FeatureConfig,
) -> Tuple[FeatureState, torch.Tensor]:
    """Returns (state, features [B, 15]); the state is updated in place."""
    windows = tuple(cfg.windows)
    state, cust_slot, term_slot = _update_state(state, batch, cfg)
    if cfg.customer_source == "cms":
        c_count, c_amount = cms_query(state.cms, batch.customer_key,
                                      batch.day, windows)
        t = state.terminal
        t_bd, t_cnt, t_frd = (t.bucket_day[term_slot], t.count[term_slot],
                              t.fraud[term_slot])
    else:
        (c_bd, c_cnt, c_amt), (t_bd, t_cnt, t_frd) = gather_feature_rows(
            state.customer, state.terminal, cust_slot, term_slot)
        c_count, c_amount = window_sums(c_bd, (c_cnt, c_amt), batch.day,
                                        windows)
    t_count, t_fraud = window_sums(t_bd, (t_cnt, t_frd), batch.day, windows,
                                   cfg.delay_days)
    is_weekend, is_night = _flags(batch, cfg)
    features = _assemble(batch, cfg, c_count, ratio(c_amount, c_count),
                         t_count, ratio(t_fraud, t_count), is_weekend,
                         is_night)
    return state, features


def _update_state_exact(
    state: FeatureState, batch: TxBatch, cfg: FeatureConfig
) -> Tuple[FeatureState, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Tiered scatter-update half (``key_mode="exact"``), in place.

    Returns (state, cust_slot, c_adm, term_slot, t_adm): slots come from
    the key directories; rows that miss admission (``*_adm`` False) stay
    out of the hot-tier scatters and the caller serves them from the
    sketch tier. The sketches take every row (they shadow the whole
    stream), so a key's estimate stays an overestimate whether or not it
    holds a slot now.
    """
    fraud = torch.clamp(batch.label, min=0).to(torch.float32)
    probes = cfg.keydir_probes
    if cfg.customer_source == "cms":
        cust_slot = torch.zeros_like(batch.day, dtype=torch.int64)
        c_adm = torch.zeros_like(batch.valid)
    else:
        _, cust_slot, c_adm = admit_slots(
            state.customer_dir, batch.customer_key, batch.valid, probes)
        update_windows(state.customer, cust_slot, batch.day, batch.amount,
                       fraud, batch.valid & c_adm, track_fraud=False)
    _, term_slot, t_adm = admit_slots(
        state.terminal_dir, batch.terminal_key, batch.valid, probes)
    update_windows(state.terminal, term_slot, batch.day, batch.amount, fraud,
                   batch.valid & t_adm, track_amount=False)
    cms_update(state.cms, batch.customer_key, batch.amount, batch.day,
               batch.valid)
    cms_update(state.terminal_cms, batch.terminal_key, batch.amount,
               batch.day, batch.valid, fraud=fraud)
    return state, cust_slot, c_adm, term_slot, t_adm


def update_and_featurize_exact(
    state: FeatureState,
    batch: TxBatch,
    cfg: FeatureConfig,
) -> Tuple[FeatureState, torch.Tensor, torch.Tensor]:
    """Tiered twin of :func:`update_and_featurize` (``key_mode="exact"``).

    Returns (state, features [B, 15], tier_rows float32 [2]) where
    ``tier_rows = [dense, cms]`` counts this batch's (row × keyspace)
    reads per tier, the source of ``rtfds_feature_tier_rows_total``.

    An admitted key reads its private hot-tier row (with the hot tier
    holding every key, this is ``direct`` mode bit for bit); a row that
    missed admission reads the count-min sketch (overestimate-only counts
    and amounts; terminal risk a ratio of two overestimates).
    """
    windows = tuple(cfg.windows)
    state, cust_slot, c_adm, term_slot, t_adm = _update_state_exact(
        state, batch, cfg)
    valid = batch.valid
    c_count, c_amount = cms_query(state.cms, batch.customer_key, batch.day,
                                  windows)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    c_dense = c_miss = zero
    if cfg.customer_source != "cms":
        c = state.customer
        cc_t, ca_t = window_sums(
            c.bucket_day[cust_slot], (c.count[cust_slot], c.amount[cust_slot]),
            batch.day, windows)
        c_count = torch.where(c_adm[:, None], cc_t, c_count)
        c_amount = torch.where(c_adm[:, None], ca_t, c_amount)
        c_dense = (valid & c_adm).sum().to(torch.float32)
        c_miss = (valid & ~c_adm).sum().to(torch.float32)
    t = state.terminal
    tc_t, tf_t = window_sums(
        t.bucket_day[term_slot], (t.count[term_slot], t.fraud[term_slot]),
        batch.day, windows, cfg.delay_days)
    tc_s, _, tf_s = cms_query_fraud(state.terminal_cms, batch.terminal_key,
                                    batch.day, windows, cfg.delay_days)
    t_count = torch.where(t_adm[:, None], tc_t, tc_s)
    t_fraud = torch.where(t_adm[:, None], tf_t, tf_s)
    is_weekend, is_night = _flags(batch, cfg)
    features = _assemble(batch, cfg, c_count, ratio(c_amount, c_count),
                         t_count, ratio(t_fraud, t_count), is_weekend,
                         is_night)
    dense = c_dense + (valid & t_adm).sum().to(torch.float32)
    cms_rows = c_miss + (valid & ~t_adm).sum().to(torch.float32)
    return state, features, torch.stack([dense, cms_rows])


def _assemble(batch, cfg, c_count, c_avg, t_count, t_risk,
              is_weekend, is_night) -> torch.Tensor:
    """Feature columns → [B, 15] in ``features/spec.py`` order."""
    return stack_features(batch.amount, is_weekend, is_night, c_count, c_avg,
                          t_count, t_risk)


def update_and_score_fused_forest(
    state: FeatureState,
    batch: TxBatch,
    cfg: FeatureConfig,
    scaler_mean: torch.Tensor,
    scaler_scale: torch.Tensor,
    tables: ForestTables,
) -> Tuple[FeatureState, torch.Tensor, torch.Tensor]:
    """Scatter-update the state (in place), then run the fused
    featurize→forest step (``ops/forest_kernels.py::fused_forest_leaf_sum``)
    on both tables and the batch's slots: its kernel reads the updated
    rows by slot.

    Counterpart of the JAX ``update_and_score_pallas_forest``: returns
    (state, leaf_sum [B], features [B, 15]); the caller divides by
    ``tables.n_trees`` and masks invalid rows.
    """
    _require_table_source(cfg)
    state, cust_slot, term_slot = _update_state(state, batch, cfg)
    leaf_sum, feats = fused_forest_leaf_sum(
        tables, state.customer, state.terminal, cust_slot, term_slot,
        batch.day, batch.tod_s, batch.amount, scaler_mean, scaler_scale,
        windows=tuple(cfg.windows),
        delay=cfg.delay_days,
        weekend_start=cfg.weekend_start_weekday,
        night_end=cfg.night_end_hour,
    )
    return state, leaf_sum, feats


def update_and_score_fused_logreg(
    state: FeatureState,
    batch: TxBatch,
    cfg: FeatureConfig,
    scaler_mean: torch.Tensor,
    scaler_scale: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
) -> Tuple[FeatureState, torch.Tensor, torch.Tensor]:
    """Scatter-update the state (in place), then run the fused
    featurize→logreg step (``ops/score_kernels.py::fused_featurize_score``)
    on both tables and the batch's slots: its kernel reads the updated
    rows by slot.

    Counterpart of the JAX ``update_and_score_pallas``: returns (state,
    probs [B], features [B, 15]); padded rows score 0.
    """
    _require_table_source(cfg)
    state, cust_slot, term_slot = _update_state(state, batch, cfg)
    probs, feats = fused_featurize_score(
        state.customer, state.terminal, cust_slot, term_slot, batch.day,
        batch.tod_s, batch.amount, batch.valid, scaler_mean, scaler_scale,
        w, b,
        windows=tuple(cfg.windows),
        delay=cfg.delay_days,
        weekend_start=cfg.weekend_start_weekday,
        night_end=cfg.night_end_hour,
    )
    return state, probs, feats


def _reset_slots(ws: WindowState, slots: torch.Tensor,
                 dead: torch.Tensor) -> None:
    """Reset the window rows of ``slots[dead]`` (empty stamps, zero sums),
    IN PLACE, through a per-slot mask: one pass over the table."""
    cap = ws.capacity
    idx = torch.where(dead, slots.long().clamp(0, cap - 1),
                      torch.full_like(slots, cap, dtype=torch.int64))
    mask = torch.zeros(cap + 1, dtype=torch.bool, device=slots.device)
    mask.index_fill_(0, idx, True)
    m = mask[:cap, None]
    ws.bucket_day.masked_fill_(m, -1)
    for col in (ws.count, ws.amount, ws.fraud):
        col.masked_fill_(m, 0.0)


def _swept_rows(ws: WindowState) -> torch.Tensor:
    """The rows of ``ws.bucket_day`` a compaction pass reads: all of
    them, a full-table sweep."""
    return ws.bucket_day


def compact_swept_slots(state: FeatureState) -> dict:
    """Hot-tier slots one :func:`compact_feature_state` pass reads, by
    table with a key directory: the rows of its :func:`_swept_rows`
    (over a sharded state, the per-shard passes read its blocks, which
    add up to the same)."""
    return {ws_name: int(_swept_rows(getattr(state, ws_name)).shape[0])
            for dir_name, ws_name in (("customer_dir", "customer"),
                                      ("terminal_dir", "terminal"))
            if getattr(state, dir_name) is not None}


def compact_feature_state(
    state: FeatureState,
    now_day,  # int or int32 [] — the newest day the stream has seen
    cfg: FeatureConfig,
    demote_slots: int = 0,
):
    """Recency compaction (``key_mode="exact"``), IN PLACE: one vector
    pass per table reclaiming the hot-tier slots that hold only dead
    history.

    A slot whose newest ``bucket_day`` is older than ``now_day -
    (delay_days + max(windows))`` can never reach a window query again:
    its directory entry is vacated, the slot goes back on the free stack
    and its window row is reset. Returns (state, reclaimed int32 [2] =
    [customer, terminal]).

    ``demote_slots > 0`` adds the cold tier's pressure eviction
    (:func:`_demote_oldest`): while a table sits above ``cold_highwater *
    capacity`` occupied slots after the dead reclaim, up to
    ``demote_slots`` of its oldest entries are demoted, and the return is
    ``(state, reclaimed, payload)`` with ``payload[table] = (keys uint32
    [K], bucket_day int32 [K, NB], count/amount/fraud float32 [K, NB])``,
    unselected lanes ``EMPTY_KEY`` with empty rows.
    """
    horizon = cfg.delay_days + max(cfg.windows)
    now = now_day
    cutoff = now - horizon
    counts = []
    payload = {}
    for dir_name, ws_name in (("customer_dir", "customer"),
                              ("terminal_dir", "terminal")):
        kd = getattr(state, dir_name)
        ws = getattr(state, ws_name)
        payload[ws_name] = None
        if kd is None:
            counts.append(torch.zeros((), dtype=torch.int32,
                                      device=ws.count.device))
            continue
        newest = _swept_rows(ws).amax(dim=1)  # [slot_cap]
        live = kd.slots >= 0
        newest_e = newest[kd.slots.long().clamp(0, ws.capacity - 1)]
        dead_entry = live & (newest_e < cutoff)
        if demote_slots > 0:
            # the eviction extends the dead mask: one combined reclaim
            # and one table sweep
            n, payload[ws_name] = _demote_oldest(
                kd, ws, dead_entry, newest_e, live, now, horizon,
                int(demote_slots), cfg.cold_highwater)
        else:
            _reset_slots(ws, kd.slots, dead_entry)
            _, _, n = reclaim_entries(kd, dead_entry)
        counts.append(n)
    reclaimed = torch.stack(counts)
    if demote_slots > 0:
        return state, reclaimed, payload
    return state, reclaimed


def _demote_oldest(
    kd: KeyDirectory,
    ws: WindowState,
    dead_entry: torch.Tensor,  # bool [dir_cap] — the dead-history mask
    newest_e: torch.Tensor,  # int32 [dir_cap] — newest bucket per entry
    live: torch.Tensor,  # bool [dir_cap]
    now_day,  # int or int32 []
    horizon: int,  # days — the dead-history cutoff distance
    demote_slots: int,
    highwater: float,
):
    """Pressure eviction for one table, fused with the dead reclaim, IN
    PLACE: the ``demote_slots`` oldest live entries whose newest bucket is
    strictly before ``now_day`` (an entry touched today is never evicted
    under the batch that wrote it), but only as many as post-reclaim
    occupancy sits above ``highwater * capacity``. Their rows are gathered
    into a fixed-shape payload first; then the dead mask and the
    selection are vacated in one reclaim and one table sweep.

    The selection is the set ``lax.top_k`` would pick (oldest first, ties
    to the lowest index), found without a sort: eligible ages lie in
    ``[1, horizon]``, so an age histogram and a suffix sum give the
    threshold age, and a cumsum rank breaks the tie there by index.
    Returns ``(n_reclaimed, (keys, bd, cnt, amt, frd))``.
    """
    slot_cap = ws.capacity
    dir_cap = kd.dir_capacity
    dev = newest_e.device
    k = min(int(demote_slots), dir_cap)
    hzn = max(int(horizon), 1)
    n_dead = (dead_entry & live).sum().to(torch.int32)
    occ = slot_cap - kd.free_top - n_dead
    n_evict = torch.clamp(occ - int(highwater * slot_cap), 0, k)
    eligible = live & ~dead_entry & (newest_e < now_day)
    age = torch.clamp(torch.where(eligible, now_day - newest_e,
                                  torch.zeros_like(newest_e)), 0, hzn).long()
    hist = torch.zeros(hzn + 3, dtype=torch.int32, device=dev)
    hist.index_add_(0, age, torch.ones_like(age, dtype=torch.int32))
    incl = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    # threshold t* = the oldest age with incl >= n_evict (floor 1 covers
    # n_evict > #eligible: every eligible entry is taken)
    thresh = torch.clamp(
        (incl >= n_evict)[1:hzn + 2].sum().to(torch.int32), min=1)
    # a 1-element index: a 0-d one would read ``thresh`` back to the host
    quota = n_evict - incl[thresh.long().view(1) + 1]
    at_t = age == thresh
    rank_t = torch.cumsum(at_t.to(torch.int32), 0) - 1
    sel = (age > thresh) | (at_t & (rank_t < quota))
    # selected entry indices packed into the k payload lanes in index
    # order (lane k is the scratch lane of the unselected entries)
    lane = torch.where(sel, torch.cumsum(sel.to(torch.int64), 0) - 1,
                       torch.full_like(age, k))
    eidx = torch.full((k + 1,), dir_cap, dtype=torch.int64, device=dev)
    eidx.index_put_((lane,), torch.arange(dir_cap, dtype=torch.int64,
                                          device=dev))
    eidx = eidx[:k].clamp(0, dir_cap - 1)
    lane_live = torch.arange(k, device=dev) < sel.sum()
    # the payload is gathered BEFORE the vacate: keys and full rows
    kv = kd.keys.view(torch.int32)
    keys = torch.where(lane_live, kv[eidx],
                       torch.full((k,), -1, dtype=torch.int32,
                                  device=dev)).view(torch.uint32)
    slot_g = kd.slots[eidx].long().clamp(0, slot_cap - 1)
    m = lane_live[:, None]
    bd = torch.where(m, ws.bucket_day[slot_g],
                     torch.full_like(ws.bucket_day[slot_g], -1))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.where(m, ws.count[slot_g], zero)
    amt = torch.where(m, ws.amount[slot_g], zero)
    frd = torch.where(m, ws.fraud[slot_g], zero)
    vacate = dead_entry | sel
    _reset_slots(ws, kd.slots, vacate & live)
    _, _, n = reclaim_entries(kd, vacate)
    return n, (keys, bd, cnt, amt, frd)


def promote_rows(
    state: FeatureState,
    payload: dict,  # {"customer": (keys, bd, cnt, amt, frd) | None, ...}
    cfg: FeatureConfig,
) -> Tuple[FeatureState, torch.Tensor]:
    """Land cold-store rows back in the hot tier between steps, IN PLACE.

    Per table: ``admit_slots`` grants (or finds) a slot for every
    non-``EMPTY_KEY`` lane, then a per-bucket day-dominance merge takes
    the cold bucket only where its ``bucket_day`` is strictly newer than
    the resident one, never a float add: promotion is idempotent, and a
    key that took fresh hot rows while its promotion was in flight
    converges to the never-evicted state (eviction needed every cold
    bucket strictly before the eviction day, later writes land on later
    days). Returns ``(state, stats int32 [2, 2])`` = per table
    ``[admitted, dropped]`` (dropped: the free stack ran dry; the host
    re-requests on the key's next touch). Keys are unique per call.
    """
    stats = []
    for dir_name, ws_name in (("customer_dir", "customer"),
                              ("terminal_dir", "terminal")):
        kd = getattr(state, dir_name)
        ws = getattr(state, ws_name)
        pay = payload.get(ws_name)
        if kd is None or pay is None:
            stats.append(torch.zeros(2, dtype=torch.int32,
                                     device=ws.count.device))
            continue
        keys, bd, cnt, amt, frd = pay
        valid = keys.view(torch.int32) != -1
        _, slot, adm = admit_slots(kd, keys, valid, cfg.keydir_probes)
        cur = (ws.bucket_day[slot], ws.count[slot], ws.amount[slot],
               ws.fraud[slot])
        take = adm[:, None] & (bd > cur[0])
        for col, new, old in zip((ws.bucket_day, ws.count, ws.amount,
                                  ws.fraud), (bd, cnt, amt, frd), cur):
            put_kept_(col, slot, adm, torch.where(take, new, old))
        stats.append(torch.stack([adm.sum().to(torch.int32),
                                  (valid & ~adm).sum().to(torch.int32)]))
    return state, torch.stack(stats)


def apply_feedback(
    state: FeatureState,
    terminal_key: torch.Tensor,  # uint32 [B]
    day: torch.Tensor,  # int32 [B] — the day of the original transaction
    label: torch.Tensor,  # int32 [B] 0/1
    valid: torch.Tensor,  # bool [B]
    cfg: FeatureConfig,
) -> FeatureState:
    """Late fraud-label feedback, in place: add the labels to the fraud
    sums of past day buckets (counts unchanged: the transaction was
    counted when it streamed through); the delay-shifted risk windows
    pick them up.

    ``key_mode="exact"``: labels route by a directory LOOKUP, never an
    insert (feedback must not take a slot from live traffic). Hits land
    in the dense terminal rows; misses (never admitted, or compacted
    away) land in the terminal sketch's fraud column."""
    if cfg.key_mode == "exact":
        term_slot, hit = lookup_slots(
            state.terminal_dir, terminal_key, valid, cfg.keydir_probes)
        state = apply_feedback_at_slot(state, term_slot, day, label,
                                       valid & hit)
        cms_add_fraud(state.terminal_cms, terminal_key, day, label,
                      valid & ~hit)
        return state
    term_slot = _slot(terminal_key, cfg.terminal_capacity, cfg.key_mode)
    return apply_feedback_at_slot(state, term_slot, day, label, valid)


def apply_feedback_sharded_exact(
    state: FeatureState,
    terminal_key: torch.Tensor,  # uint32 [B] (fold_key'd)
    day: torch.Tensor,  # int32 [B] — the day of the original transaction
    label: torch.Tensor,  # int32 [B] 0/1
    valid: torch.Tensor,  # bool [B]
    cfg: FeatureConfig,
) -> FeatureState:
    """The sharded twin of :func:`apply_feedback` under
    ``key_mode="exact"``, in place: a key's owner is ``key % n_shards``
    (the modulo the step's owner exchange routes by) and its slot comes
    from the owner's directory by a LOOKUP, never an insert. Hits land in
    the owner's window rows (global row ``owner · cap_local + slot``),
    misses in the owner's sketch's fraud column."""
    kd = state.terminal_dir
    n_shards = int(kd.keys.shape[0])
    cap_local = state.terminal.capacity // n_shards
    owner = widen_u32(terminal_key) % n_shards
    slot, hit = lookup_slots_stacked(kd, owner, terminal_key, valid,
                                     cfg.keydir_probes)
    state = apply_feedback_at_slot(state, owner * cap_local + slot, day,
                                   label, valid & hit)
    cms_add_fraud(state.terminal_cms, terminal_key, day, label,
                  valid & ~hit, owner=owner)
    return state


def apply_feedback_at_slot(
    state: FeatureState,
    term_slot: torch.Tensor,  # int64 [B] — row into the terminal table
    day: torch.Tensor,
    label: torch.Tensor,
    valid: torch.Tensor,
) -> FeatureState:
    """Slot-addressed core of :func:`apply_feedback`, in place: a label
    lands only where the bucket still holds its day (the ring has not
    wrapped past it). 0/1 adds are exact in any order."""
    t = state.terminal
    nb = t.n_buckets
    bucket = torch.remainder(day, nb).long()
    flat = term_slot.long() * nb + bucket
    live = valid & (t.bucket_day.view(-1)[flat] == day)
    t.fraud.view(-1).index_put_(
        (flat,), label.to(torch.float32) * live.to(torch.float32),
        accumulate=True)
    return state
