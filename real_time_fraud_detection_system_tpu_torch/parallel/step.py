"""The sharded micro-batch step — port of the JAX package's
``parallel/step.py`` for shards that share one device.

Distribution contract, the JAX package's:

- rows arrive partitioned by **customer** (``customer_id % n_dev``, the
  broker's key-hash partition analogue), so a shard updates and queries
  its customers' windows locally (:func:`partition_batch_spill`, chunk 0);
- **terminal** windows are owned by ``terminal_key % n_dev``. A shard's
  rows reference foreign terminals, so the step routes one packed
  ``[*, 5]`` 32-bit record per row (key, day, amount, fraud, valid) to the
  owner, which updates and queries its block, and routes the window
  aggregates back;
- the hot-key spill (``__routed__`` chunks, rows on ANY shard) routes the
  customers to their owner the same way;
- params and scaler are shared; the online-SGD gradient is the mean of
  the shards' gradients, each of its own masked mean loss.

The JAX step runs that exchange as ``jax.lax.all_to_all`` over ICI. Here
the shards share one device, so a bucketed all_to_all is a permutation of
one tensor: the send buffer ``[n_dev (sender), n_dev (owner), cap, ...]``
transposed to ``[owner, sender, cap, ...]`` (:func:`_make_xchg`, its own
inverse). The owner side runs over every shard in one call: the shards'
global row ranges are disjoint (owner-major layout, ``parallel/mesh.py``),
so one ``update_windows`` / ``query_windows`` over the received buffer is
each shard's own update. Rows keep the JAX receive order (owner, then
sender, then rank), so sums add in the JAX package's order per row.

The exchange's bucket: the compact one, ``2·ceil(bl/n_dev)`` rows per
(sender, owner) pair, holds balanced traffic; a valid row ranked past it
needs the full one (``bl``). JAX picks on the device with ``lax.cond`` on
a psum'd flag. A CUDA graph cannot branch, and the host holds every
row's key already, so here the host picks per chunk
(:func:`exchange_overflows`) and the step takes the choice as an
argument (``full``); the results do not depend on it, since padding rows
touch no state and the valid rows keep their order.

Scoring: the 15 features as the JAX step assembles them, ``transform``,
then ``predict_fn`` once over the whole ``[n_dev · bl]`` chunk — the
engine passes the leaf-sum kernel (``ops/forest_kernels.py::leaf_sum``)
for tree, forest and gbt, the plain predict for the other kinds, as the
JAX sharded step scores through the engine's predict.
``fused_forest_leaf_sum`` and ``fused_featurize_score`` are not on this
path: they read both tables by slot in one pass, and a sharded row's
terminal aggregates arrive through the exchange.

Key arithmetic runs on uint32 keys widened to int64 (``& 0xFFFFFFFF``):
``%`` and ``//`` on the int32 view are wrong for keys ≥ 2³¹. Direct and
hash keys are placed by that modulo (hash mode too: the sharded step
never calls the single-device ``slot_of``).

``key_mode="exact"`` (the tiered store) keeps the wire contract —
ownership is ``key % n_dev``, so the partitioner and the exchange route
as above — but the slot within a shard comes from that shard's own key
directory (stacked ``[n_dev, ...]`` leaves): the owner side admits every
shard's rows in one pass (``ops/keydir.py::admit_slots_stacked``, the
rows of shard s being its block of the owner-local chunk or of the
receive buffer), rows that miss admission read the owner's sketch
replica, and the step returns a fifth output, the per-shard ``[dense,
cms]`` read counts ``[n_dev, 2]``, counted owner-side.
:func:`make_sharded_compact` and :func:`make_sharded_promote` run the
recency compaction (with the cold tier's demotions) and the cold rows'
promotion over each shard's block and directory.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.config import Config
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    TxBatch,
    fold_key,
    unpack_batch,
)
from real_time_fraud_detection_system_tpu_torch.features.online import (
    FeatureState,
    _assemble,
    _flags,
    compact_feature_state,
    promote_rows,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    loss_grad,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    Scaler,
    transform,
)
from real_time_fraud_detection_system_tpu_torch.ops.cms import (
    cms_query,
    cms_query_fraud,
    cms_update,
)
from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
    ratio,
)
from real_time_fraud_detection_system_tpu_torch.ops.keydir import (
    KeyDirectory,
    admit_slots_stacked,
)
from real_time_fraud_detection_system_tpu_torch.ops.windows import (
    WindowState,
    query_windows,
    update_windows,
)
from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
    Mesh,
    _check_colocated,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree


def partition_batch_spill(
    cols: dict, n_dev: int, rows_per_shard: int
) -> "list[Tuple[dict, np.ndarray, np.ndarray]]":
    """Host-side partitioner with densely-packed hot-key spill: one or
    more [n_dev × rows_per_shard] layouts.

    Partition of a row is ``customer_id % n_dev``. Rows that fit their
    shard's budget form chunk 0, laid out owner-locally (``__routed__ =
    False``). A skewed key distribution can put more than
    ``rows_per_shard`` rows on one shard; the overflow is re-packed
    densely across ALL shards into follow-on chunks (``__routed__ =
    True``), row-robin, and the step routes their customers to the owner
    like terminals.

    Returns a list of (columns dict with every array length
    n_dev*rows_per_shard plus ``__valid__`` mask and ``__routed__`` flag,
    input_rows, pos): ``input_rows[j]`` is the original row index of the
    chunk's j-th occupied slot and ``pos[j]`` its position in the chunk
    layout — for re-assembling results in input order.
    """
    cust = cols["customer_id"]
    n = len(cust)
    if n_dev == 1:
        # one shard: every row in input order, no rank machinery
        part = np.zeros(n, dtype=np.int64)
        rank = np.arange(n, dtype=np.int64)
    else:
        part = (cust % n_dev).astype(np.int64)
        order = np.argsort(part, kind="stable")
        part_sorted = part[order]
        rank_sorted = (
            np.arange(n) - np.searchsorted(part_sorted, part_sorted,
                                           "left")
        )
        rank = np.empty(n, dtype=np.int64)
        rank[order] = rank_sorted
    total = n_dev * rows_per_shard

    def _mk_chunk(rows, pos, routed):
        out = {}
        for k, v in cols.items():
            buf = np.zeros(total, dtype=v.dtype)
            buf[pos] = v[rows]
            out[k] = buf
        valid = np.zeros(total, dtype=bool)
        valid[pos] = True
        out["__valid__"] = valid
        out["__routed__"] = routed
        return out, rows, pos

    fits = rank < rows_per_shard
    rows0 = np.flatnonzero(fits)
    pos0 = part[rows0] * rows_per_shard + rank[rows0]
    chunks = [_mk_chunk(rows0, pos0, False)]
    overflow = np.flatnonzero(~fits)  # original order preserved
    for s in range(0, len(overflow), total):
        rows = overflow[s : s + total]
        i = np.arange(len(rows), dtype=np.int64)
        # row-robin, so a partial final chunk spreads over every shard
        pos = (i % n_dev) * rows_per_shard + i // n_dev
        chunks.append(_mk_chunk(rows, pos, True))
    return chunks


def partition_batch_by_customer(
    cols: dict, n_dev: int, rows_per_shard: int
) -> Tuple[dict, np.ndarray]:
    """Single-chunk partitioner: layout rows as [n_dev × rows_per_shard].

    Returns (columns dict with every array length n_dev*rows_per_shard,
    gather_index) where ``gather_index[i]`` is the output position of input
    row i. Raises on shard overflow — callers that must survive hot keys
    use :func:`partition_batch_spill` (the sharded engine does).
    """
    chunks = partition_batch_spill(cols, n_dev, rows_per_shard)
    if len(chunks) > 1:
        raise ValueError(
            f"partition overflow: >{rows_per_shard} rows on one shard; "
            f"raise rows_per_shard, poll smaller batches, or use "
            f"partition_batch_spill"
        )
    out, rows, pos_chunk = chunks[0]
    n = len(cols["customer_id"])
    pos = np.empty(n, dtype=np.int64)
    pos[rows] = pos_chunk
    return out, pos


def compact_capacity(bl: int, n_dev: int) -> int:
    """The compact exchange's rows per (sender, owner) pair: 2× the
    balanced share, never more than ``bl``."""
    return min(bl, 2 * -(-bl // n_dev))


def exchange_overflows(ids: np.ndarray, valid: np.ndarray,
                       n_dev: int) -> bool:
    """Host side of the capacity choice for one exchange of a chunk:
    True when some sender holds more valid rows for one owner than the
    compact bucket takes. ``ids`` are the chunk's int64 ids (folded to
    the step's uint32 keys here), laid out ``[n_dev × bl]``."""
    if n_dev == 1:
        return False
    bl = len(ids) // n_dev
    cap = compact_capacity(bl, n_dev)
    if cap >= bl:
        return False
    dest = (fold_key(np.asarray(ids)).astype(np.int64) % n_dev)
    sender = np.arange(len(ids), dtype=np.int64) // bl
    pair = (sender * n_dev + dest)[np.asarray(valid, dtype=bool)]
    return bool(np.bincount(pair, minlength=n_dev * n_dev).max(
        initial=0) > cap)


def _u64(key: torch.Tensor) -> torch.Tensor:
    """uint32 key bits → int64 values (the int32 view's sign undone)."""
    return key.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _route(
    dest: torch.Tensor,  # int64 [n_dev, b] in [0, n_dev] (n_dev: invalid)
    valid: torch.Tensor,  # bool [n_dev, b]
    n_dev: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(send_pos, rank), each [n_dev, b], per sending shard:
    ``send_pos = dest * b + rank``, ``rank`` the row's place among the
    shard's earlier rows of the same ``dest`` (the JAX stable-argsort
    rank, here a running count: no sort, no host sync). Invalid rows route
    too and are masked by the caller."""
    b = dest.shape[1]
    hits = torch.nn.functional.one_hot(dest, n_dev + 1)  # [n, b, n+1]
    rank = hits.cumsum(dim=1).gather(2, dest[..., None])[..., 0] - 1
    return dest * b + rank, rank


def _make_xchg(n_dev: int, cap: int):
    """The bucketed all_to_all over co-located shards: ``[n_dev,
    n_dev·cap, ...]`` laid out sender-major with owner buckets →
    ``[n_dev, n_dev·cap, ...]`` where row o holds what every sender sent
    to owner o, senders in order. Its own inverse (routing results back
    is ``xchg(result)``); carries trailing feature dims."""

    def xchg(x):
        rest = tuple(x.shape[2:])
        return (x.reshape((n_dev, n_dev, cap) + rest).transpose(0, 1)
                .reshape((n_dev, n_dev * cap) + rest))

    return xchg


def owner_route(
    dest: torch.Tensor,  # int64 [n_dev, bl] owner shard per row
    valid: torch.Tensor,  # bool [n_dev, bl]
    n_dev: int,
    bl: int,
):
    """The bucketed exchange's primitives with worst-case buckets (``bl``
    per pair, any skew fits): → (send_pos, xchg, scatter).
    ``scatter(x)`` lays ``[n_dev, bl, ...]`` rows into the ``[n_dev,
    n_dev·bl, ...]`` send buffer at their owner bucket; ``xchg`` runs the
    exchange."""
    send_pos, _ = _route(dest, valid, n_dev)
    xchg = _make_xchg(n_dev, bl)

    def scatter(x, fill=0):
        buf = torch.full((n_dev, n_dev * bl) + tuple(x.shape[2:]), fill,
                         dtype=x.dtype, device=x.device)
        buf.scatter_(1, send_pos.view(send_pos.shape + (1,) * (x.dim() - 2))
                     .expand_as(x), x)
        return buf

    return send_pos, xchg, scatter


def make_sharded_step(
    cfg: Config,
    predict_fn: Callable,
    loss_fn: Optional[Callable] = None,
    online_lr: float = 0.0,
    mesh: Optional[Mesh] = None,
    route_customers: bool = False,
    packed: bool = False,
    axis: "str | tuple" = "data",
):
    """The sharded step over ``mesh`` (co-located shards):

    ``step(feature_state, params, scaler, batch, full=(False, False))
    -> (feature_state, params, probs, features)`` (and ``tier [n_dev, 2]``
    under ``key_mode="exact"``) with the batch's rows
    laid out ``[n_dev × B_local]`` (:func:`partition_batch_spill`); the
    feature state (owner-major tables, ``[n_dev, ...]`` sketch) and, with
    ``online_lr``, the params are updated in place and returned.
    ``packed=True`` takes the ``[7, n_dev·B_local]`` int32 array
    (``core/batch.py::pack_batch``) instead of a ``TxBatch``.
    ``route_customers=True`` is the dense-spill variant: rows sit on any
    shard and customers are routed to their owner like terminals. ``full``
    picks each exchange's bucket, (customer, terminal), from the host's
    :func:`exchange_overflows`. Under ``emit_dtype="bfloat16"``
    ``features`` is cast after the classifier read the float32 features.
    Under selective emission (``runtime.emit_threshold > 0``) ``features``
    is ``{"packed": ..., "full": ...}`` as in the JAX step: the one
    float32 transfer of ``runtime/engine.py::pack_selective`` over the
    global arrays, and the full matrix for a count past the cap.

    ``axis`` names the mesh's axis, or the pair ``("dcn", "ici")`` of a
    ``parallel/distributed.py::make_hybrid_mesh`` grid: as in the JAX
    step, the pair is one flattened axis (the grid's shards in row-major
    order).

    The JAX function returns a builder of a jitted step; a PyTorch step
    needs no tracing, so this returns the step itself."""
    if mesh is None:
        raise ValueError("make_sharded_step needs a mesh")
    names = getattr(mesh, "axis_names", None)
    if names is not None and tuple(
            (axis,) if isinstance(axis, str) else axis) != tuple(names):
        raise ValueError(f"axis {axis!r} is not the mesh's axes {names}")
    mesh = _check_colocated(mesh)
    n_dev = len(mesh)
    fcfg = cfg.features
    exact = fcfg.key_mode == "exact"
    probes = fcfg.keydir_probes
    use_cms = fcfg.customer_source == "cms"
    windows = tuple(fcfg.windows)
    nw = len(windows)
    c_cap_local = fcfg.customer_capacity // n_dev
    t_cap_local = fcfg.terminal_capacity // n_dev
    for nm, cl in (("customer", c_cap_local), ("terminal", t_cap_local)):
        # the local slot masks with `& (cap_local - 1)`, a modulo only for
        # powers of two: another local capacity would alias distinct keys
        if cl <= 0 or (cl & (cl - 1)):
            raise ValueError(
                f"{nm}_capacity / n_devices must be a power of two, "
                f"got {cl}")
    rt = cfg.runtime
    thresh = float(rt.emit_threshold)
    selective = rt.emit_features and thresh > 0.0
    emit_bf16 = rt.emit_dtype == "bfloat16"

    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        pack_selective,
    )

    def step(fstate: FeatureState, params, scaler: Scaler, batch_in,
             full: Tuple[bool, bool] = (False, False)):
        batch: TxBatch = unpack_batch(batch_in) if packed else batch_in
        total = batch.valid.shape[0]
        if total % n_dev:
            raise ValueError(f"a chunk of {total} rows does not split over "
                             f"{n_dev} shards")
        bl = total // n_dev
        dev = batch.valid.device
        fraud = torch.clamp(batch.label, min=0).to(torch.float32)
        row_shard = torch.arange(total, device=dev) // bl  # the sender

        def exchanged_compute(key, fn, full_bucket: bool):
            """Route (key, day, amount, fraud, valid) to the key's owner
            shard, run ``fn(owner, key, day, amount, fraud, valid) -> mat``
            there, and route ``mat``'s per-row aggregates back:
            → local_mat [total, K]. One packed ``[*, 5]`` int32 record
            goes out (32-bit fields as bit patterns), one matrix comes
            back."""
            if n_dev == 1:
                # one shard: every key is owner-local already
                return fn(row_shard, key, batch.day, batch.amount, fraud,
                          batch.valid)
            valid2 = batch.valid.view(n_dev, bl)
            dest = (_u64(key) % n_dev).view(n_dev, bl)
            # rank VALID rows only: invalid rows sort into a trailing
            # pseudo-bucket, so padding never takes a receive slot
            _, rank = _route(torch.where(valid2, dest,
                                         torch.full_like(dest, n_dev)),
                             valid2, n_dev)
            cap = bl if full_bucket else compact_capacity(bl, n_dev)
            # invalid and overflow rows get the out-of-bounds position:
            # the scatter drops them (into a trailing slot nobody reads),
            # the gather back clamps them (their rows are masked)
            pos = torch.where(valid2 & (rank < cap), dest * cap + rank,
                              torch.full_like(rank, n_dev * cap))
            pk = torch.stack([
                key.view(torch.int32), batch.day,
                batch.amount.view(torch.int32), fraud.view(torch.int32),
                batch.valid.to(torch.int32)], dim=1).view(n_dev, bl, 5)
            send = torch.zeros((n_dev, n_dev * cap + 1, 5),
                               dtype=torch.int32, device=dev)
            send.scatter_(1, pos[..., None].expand(n_dev, bl, 5), pk)
            xchg = _make_xchg(n_dev, cap)
            r = xchg(send[:, :-1]).reshape(n_dev * n_dev * cap, 5)
            owner = (torch.arange(n_dev * n_dev * cap, device=dev)
                     // (n_dev * cap))
            mat = fn(owner, r[:, 0].view(torch.uint32), r[:, 1],
                     r[:, 2].view(torch.float32), r[:, 3].view(torch.float32),
                     r[:, 4] != 0)
            back = xchg(mat.view(n_dev, n_dev * cap, -1))
            at = torch.clamp(pos, max=n_dev * cap - 1)
            return back.gather(1, at[..., None].expand(
                n_dev, bl, back.shape[-1])).reshape(total, -1)

        def local_slot(key, cap_local: int, owner):
            """Global table row: owner block, then ``(key // n) & (cap/n -
            1)`` on the widened key."""
            return (owner * cap_local
                    + ((_u64(key) // n_dev) & (cap_local - 1)))

        def customer_fn(owner, c_key, c_day, c_amt, c_fraud, c_valid):
            """Owner-side customer velocity: the sketch or the table,
            updated then queried; → [*, 2·NW] aggregates."""
            if fstate.cms is not None:
                cms_update(fstate.cms, c_key, c_amt, c_day, c_valid,
                           shard=owner)
            if use_cms:
                cc, ca = cms_query(fstate.cms, c_key, c_day, windows,
                                   shard=owner)
            else:
                slot = local_slot(c_key, c_cap_local, owner)
                update_windows(fstate.customer, slot, c_day, c_amt, c_fraud,
                               c_valid, track_fraud=False)
                cc, ca, _ = query_windows(fstate.customer, slot, c_day,
                                          windows)
            return torch.cat([cc, ca], dim=1)

        def terminal_fn(owner, t_key, t_day, t_amt, t_fraud, t_valid):
            """Owner-side terminal windows: count and delayed risk."""
            slot = local_slot(t_key, t_cap_local, owner)
            update_windows(fstate.terminal, slot, t_day, t_amt, t_fraud,
                           t_valid, track_amount=False)
            t_count, _, t_fr = query_windows(fstate.terminal, slot, t_day,
                                             windows, delay=fcfg.delay_days)
            return torch.cat([t_count, t_fr], dim=1)

        # -- the tiered store: each shard's directory, sketch for misses --
        tiers = []  # per table with a directory: [n_dev, 2] reads

        def admit(kd: KeyDirectory, key, valid, cap_local: int):
            """Every shard's rows (``[n_dev · L]``, shard-major) admitted
            into its own directory: → (global table row, admitted), and
            the shards' [dense, cms] read counts noted."""
            _, slot, adm = admit_slots_stacked(
                kd, key.view(n_dev, -1), valid.view(n_dev, -1), probes)
            base = torch.arange(n_dev, device=dev)[:, None] * cap_local
            v = valid.view(n_dev, -1)
            tiers.append(torch.stack([(v & adm).sum(1), (v & ~adm).sum(1)],
                                     dim=1).to(torch.float32))
            return (base + slot).view(-1), adm.view(-1)

        def customer_fn_x(owner, c_key, c_day, c_amt, c_fraud, c_valid):
            """Owner-side customer velocity on the tiered store: the
            table for admitted rows, the owner's sketch for the rest (the
            sketch alone under ``customer_source="cms"``)."""
            cms_update(fstate.cms, c_key, c_amt, c_day, c_valid,
                       shard=owner)
            cc, ca = cms_query(fstate.cms, c_key, c_day, windows,
                               shard=owner)
            if fstate.customer_dir is not None:
                row, adm = admit(fstate.customer_dir, c_key, c_valid,
                                 c_cap_local)
                update_windows(fstate.customer, row, c_day, c_amt, c_fraud,
                               c_valid & adm, track_fraud=False)
                cc_t, ca_t, _ = query_windows(fstate.customer, row, c_day,
                                              windows)
                cc = torch.where(adm[:, None], cc_t, cc)
                ca = torch.where(adm[:, None], ca_t, ca)
            return torch.cat([cc, ca], dim=1)

        def terminal_fn_x(owner, t_key, t_day, t_amt, t_fraud, t_valid):
            """Owner-side terminal windows on the tiered store: count and
            delayed risk from the table or the owner's terminal sketch."""
            row, adm = admit(fstate.terminal_dir, t_key, t_valid,
                             t_cap_local)
            update_windows(fstate.terminal, row, t_day, t_amt, t_fraud,
                           t_valid & adm, track_amount=False)
            cms_update(fstate.terminal_cms, t_key, t_amt, t_day, t_valid,
                       fraud=t_fraud, shard=owner)
            tc, _, tf = query_windows(fstate.terminal, row, t_day, windows,
                                      delay=fcfg.delay_days)
            tc_s, _, tf_s = cms_query_fraud(
                fstate.terminal_cms, t_key, t_day, windows,
                delay=fcfg.delay_days, shard=owner)
            return torch.cat([torch.where(adm[:, None], tc, tc_s),
                              torch.where(adm[:, None], tf, tf_s)], dim=1)

        c_fn, t_fn = ((customer_fn_x, terminal_fn_x) if exact
                      else (customer_fn, terminal_fn))
        if route_customers:
            cb = exchanged_compute(batch.customer_key, c_fn, full[0])
        else:
            cb = c_fn(row_shard, batch.customer_key, batch.day,
                      batch.amount, fraud, batch.valid)
        tb = exchanged_compute(batch.terminal_key, t_fn, full[1])
        c_count, c_amount = cb[:, :nw], cb[:, nw:]
        t_count, t_fraud = tb[:, :nw], tb[:, nw:]

        is_weekend, is_night = _flags(batch, fcfg)
        feats = _assemble(batch, fcfg, c_count, ratio(c_amount, c_count),
                          t_count, ratio(t_fraud, t_count), is_weekend,
                          is_night)
        x = transform(scaler, feats)
        probs = torch.where(batch.valid, predict_fn(params, x),
                            torch.zeros((), device=dev))
        if online_lr > 0.0 and loss_fn is not None:
            labeled = (batch.valid & (batch.label >= 0)).view(n_dev, bl)
            y = torch.clamp(batch.label, min=0).view(n_dev, bl)
            xs = x.view(n_dev, bl, -1)

            def mean_of_shard_losses(p):
                # each shard's masked mean loss; the mean of their
                # gradients is the gradient of their mean
                return sum(loss_fn(p, xs[s], y[s], labeled[s])
                           for s in range(n_dev)) / n_dev

            _, g = loss_grad(mean_of_shard_losses, params)
            has = torch.any(labeled).to(torch.float32)
            with torch.no_grad():
                for p, gi in zip(tree.leaves(params), tree.leaves(g)):
                    p.sub_(online_lr * has * gi)
        if emit_bf16:
            feats = feats.to(torch.bfloat16)
        if selective:
            # probs for every row, the flagged rows' features compacted:
            # {"packed": the one transfer, "full": the overflow fallback}
            feats = {"packed": pack_selective(probs, feats, batch.valid,
                                              thresh, rt.emit_cap_fraction),
                     "full": feats}
        if exact:
            return fstate, params, probs, feats, sum(tiers)
        return fstate, params, probs, feats

    return step


def shard_view(state: FeatureState, s: int, n: int) -> FeatureState:
    """Shard ``s`` of ``n``'s own part of a sharded exact state, as a
    one-shard state of views: its block of each window table (rows
    ``[s·cap/n, (s+1)·cap/n)``) and its directories. An in-place update
    of the view updates the state (the sketches are left out: compaction
    and promotion do not touch them)."""

    def block(ws: WindowState) -> WindowState:
        cl = ws.capacity // n
        return WindowState(*[t[s * cl:(s + 1) * cl] for t in ws])

    def one(kd: Optional[KeyDirectory]) -> Optional[KeyDirectory]:
        return None if kd is None else KeyDirectory(*[t[s] for t in kd])

    return FeatureState(customer=block(state.customer),
                        terminal=block(state.terminal),
                        customer_dir=one(state.customer_dir),
                        terminal_dir=one(state.terminal_dir))


def _stack_rows(parts) -> Tuple[torch.Tensor, ...]:
    """Per-shard payloads ``(keys uint32 [K], bd, cnt, amt, frd)`` →
    the same fields stacked on a leading shard axis."""
    keys = torch.stack([p[0].view(torch.int32) for p in parts])
    return (keys.view(torch.uint32),) + tuple(
        torch.stack(col) for col in list(zip(*parts))[1:])


def make_sharded_compact(cfg: Config, mesh: Mesh, demote_slots: int = 0):
    """The per-shard recency compaction, the sharded twin of the single
    engine's ``("compact",)``: ``compact(fstate, now_day) -> (fstate,
    reclaimed [n_dev, 2])``, each shard's block and directory compacted
    IN PLACE by ``features/online.py::compact_feature_state`` (a shard's
    dead slots are its own). With ``demote_slots`` the cold tier's
    pressure eviction runs per shard too and the return gains the
    demotion payload, per table ``(keys [n_dev, K], bd/cnt/amt/frd
    [n_dev, K, NB])`` (None for a table without a directory): a key
    demoted by shard i promotes back into shard i, since its owner is a
    function of the key. The shards run one after another on the
    current stream: no host sync, so it captures as one CUDA graph."""
    mesh = _check_colocated(mesh)
    n = len(mesh)
    fcfg = cfg.features

    def compact(fstate: FeatureState, now_day):
        outs = [compact_feature_state(shard_view(fstate, s, n), now_day,
                                      fcfg, demote_slots=demote_slots)
                for s in range(n)]
        reclaimed = torch.stack([o[1] for o in outs])
        if not demote_slots:
            return fstate, reclaimed
        payload = {t: None if outs[0][2][t] is None
                   else _stack_rows([o[2][t] for o in outs])
                   for t in ("customer", "terminal")}
        return fstate, reclaimed, payload

    return compact


def make_sharded_promote(cfg: Config, mesh: Mesh):
    """The per-shard promotion of cold rows, the sharded twin of the
    single engine's ``("promote",)``: ``promote(fstate, payload) ->
    (fstate, stats int32 [n_dev, 2, 2])``. The engine groups the keys by
    owner (``key % n_dev``) into per-shard lanes, ``payload[table] =
    (keys [n_dev, K], bd/cnt/amt/frd [n_dev, K, NB])`` padded with
    ``EMPTY_KEY``, and each shard merges its lanes into its own block and
    directory (``features/online.py::promote_rows``), IN PLACE."""
    mesh = _check_colocated(mesh)
    n = len(mesh)
    fcfg = cfg.features

    def promote(fstate: FeatureState, payload: dict):
        stats = [promote_rows(
            shard_view(fstate, s, n),
            {t: None if p is None else tuple(x[s] for x in p)
             for t, p in payload.items()}, fcfg)[1] for s in range(n)]
        return fstate, torch.stack(stats)

    return promote
